"""Baseline suppression file for repro-lint.

A baseline records *accepted* findings — violations that are intentional
(each entry carries a one-line justification) — so ``--strict`` CI runs stay
green on the shipped tree while any **new** finding still fails.  Entries
match on the finding's line-independent
:meth:`~repro_torch.analysis.base.Finding.fingerprint` (``rule / path /
message``), so unrelated edits to a file never invalidate its baseline
entries.  The port's baseline is ``lint_baseline_torch.txt`` at the repo root;
the JAX package's ``lint_baseline.txt`` lists ``src/repro`` paths and stays
that package's.

File format (one entry per record, ``#`` comments and blank lines ignored)::

    # justification for the entry below
    rule<TAB>path<TAB>message

``load_baseline`` / ``save_baseline`` round-trip this format; ``apply``
splits findings into (kept, suppressed) and reports entries that matched
nothing (stale — the violation was fixed, delete the entry).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path

from .base import Finding

DEFAULT_BASELINE = "lint_baseline_torch.txt"  # repo-root default, auto-loaded


@dataclass
class Baseline:
    """Parsed baseline: fingerprint -> justification comment lines."""

    entries: dict[str, list[str]] = field(default_factory=dict)

    def __contains__(self, fp: str) -> bool:
        return fp in self.entries

    def __len__(self) -> int:
        return len(self.entries)

    def apply(self, findings: list[Finding]
              ) -> tuple[list[Finding], list[Finding], list[str]]:
        """(kept, suppressed, stale-fingerprints)."""
        kept, suppressed, matched = [], [], set()
        for f in findings:
            fp = f.fingerprint()
            if fp in self.entries:
                suppressed.append(f)
                matched.add(fp)
            else:
                kept.append(f)
        stale = [fp for fp in self.entries if fp not in matched]
        return kept, suppressed, stale


def load_baseline(path: Path) -> Baseline:
    base = Baseline()
    if not path.exists():
        return base
    pending: list[str] = []
    for raw in path.read_text().splitlines():
        line = raw.rstrip("\n")
        if not line.strip():
            pending = []
            continue
        if line.lstrip().startswith("#"):
            pending.append(line)
            continue
        if line.count("\t") < 2:
            raise ValueError(
                f"{path}: malformed baseline entry {line!r} "
                f"(expected 'rule<TAB>path<TAB>message')")
        base.entries[line] = pending
        pending = []
    return base


def save_baseline(path: Path, findings: list[Finding],
                  old: Baseline | None = None) -> None:
    """Write the current findings as the new baseline, preserving the
    justification comments of entries that survive from ``old`` and stamping
    ``# TODO: justify`` on new ones (a human replaces it in review)."""
    old = old if old is not None else Baseline()
    lines = [
        "# repro-lint baseline (docs/analysis.md): accepted findings, one",
        "# 'rule<TAB>path<TAB>message' entry per record, preceded by its",
        "# one-line justification.  Regenerate with",
        "#   python -m repro_torch.analysis --update-baseline [paths...]",
        "",
    ]
    seen: set[str] = set()
    for f in findings:
        fp = f.fingerprint()
        if fp in seen:
            continue
        seen.add(fp)
        comments = old.entries.get(fp) or ["# TODO: justify this suppression"]
        lines.extend(comments)
        lines.append(fp)
        lines.append("")
    path.write_text("\n".join(lines).rstrip("\n") + "\n")
