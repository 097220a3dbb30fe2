"""``python -m repro_torch.analysis`` — the port's repro-lint command line.

Usage::

    python -m repro_torch.analysis [options] [paths...]

Paths default to ``src/repro_torch`` under the detected repo root.  Exit-code
contract (scripts and CI depend on it):

* **0** — no findings after baseline suppression (and, under ``--strict``,
  no stale baseline entries either);
* **1** — at least one unsuppressed finding, or ``--strict`` with stale
  baseline entries;
* **2** — usage error (unknown rule, malformed baseline, bad path).

The baseline at ``<root>/lint_baseline_torch.txt`` is loaded automatically when
present (``--no-baseline`` ignores it; ``--baseline FILE`` points elsewhere);
``--update-baseline`` rewrites it from the current findings, preserving
existing justification comments.  See docs/analysis.md for the rule catalog
and the baseline workflow.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from .base import collect_modules, get_rules, run_rules
from .baseline import DEFAULT_BASELINE, load_baseline, save_baseline

_ROOT_MARKERS = (".git", "pytest.ini", "Makefile")


def detect_root(start: Path) -> Path:
    """Nearest ancestor of ``start`` carrying a repo marker, else ``start``."""
    cur = start.resolve()
    if cur.is_file():
        cur = cur.parent
    for cand in (cur, *cur.parents):
        if any((cand / m).exists() for m in _ROOT_MARKERS):
            return cand
    return cur


def _common_root(paths: list[Path], explicit: Path | None) -> Path:
    if explicit is not None:
        return explicit.resolve()
    root = detect_root(paths[0])
    # every analyzed file must be expressible repo-relative; fall back to the
    # deepest common ancestor for out-of-tree paths (test fixtures, /tmp)
    for p in paths:
        rp = p.resolve()
        while not rp.is_relative_to(root):
            root = root.parent
    return root


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repro-lint: AST-based checker for this repo's "
                    "correctness conventions (docs/analysis.md)")
    ap.add_argument("paths", nargs="*", type=Path,
                    help="files/directories to analyze "
                         "(default: src/repro_torch)")
    ap.add_argument("--root", type=Path, default=None,
                    help="repo root for relative paths + baseline lookup "
                         "(default: auto-detect)")
    ap.add_argument("--baseline", type=Path, default=None,
                    help=f"baseline file (default: <root>/{DEFAULT_BASELINE} "
                         f"when it exists)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore any baseline file")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline from current findings "
                         "(keeps existing justification comments)")
    ap.add_argument("--strict", action="store_true",
                    help="also fail on stale baseline entries (the CI mode)")
    ap.add_argument("--select", default=None, metavar="RULE[,RULE...]",
                    help="run only these rules")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    return ap


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    if args.list_rules:
        for rule in get_rules():
            print(f"{rule.name:<16} {rule.description}")
        return 0

    try:
        select = (None if args.select is None
                  else [s for s in args.select.split(",") if s])
        rules = get_rules(select)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    paths = args.paths
    if not paths:
        root = detect_root(Path.cwd()) if args.root is None else args.root
        default = Path(root) / "src" / "repro_torch"
        if not default.exists():
            print(f"error: no paths given and {default} does not exist",
                  file=sys.stderr)
            return 2
        paths = [default]
    for p in paths:
        if not p.exists():
            print(f"error: no such path: {p}", file=sys.stderr)
            return 2

    root = _common_root(paths, args.root)
    ctx = collect_modules(paths, root)
    findings = run_rules(ctx, rules)

    baseline_path = (args.baseline if args.baseline is not None
                     else root / DEFAULT_BASELINE)
    try:
        baseline = (load_baseline(baseline_path) if not args.no_baseline
                    else load_baseline(Path("/nonexistent")))
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.update_baseline:
        save_baseline(baseline_path, findings, old=baseline)
        print(f"baseline: wrote {len({f.fingerprint() for f in findings})} "
              f"entr{'y' if len(findings) == 1 else 'ies'} to "
              f"{baseline_path}")
        return 0

    kept, suppressed, stale = baseline.apply(findings)

    for f in kept:
        print(f.render())
    n_files = len(ctx.modules)
    summary = (f"repro-lint: {len(kept)} finding(s) in {n_files} file(s)"
               + (f", {len(suppressed)} baseline-suppressed" if suppressed
                  else ""))
    status = 0
    if kept:
        status = 1
    if stale:
        for fp in stale:
            print(f"stale baseline entry (fix landed? delete it): "
                  f"{fp.replace(chr(9), ' | ')}",
                  file=sys.stderr)
        if args.strict:
            status = status or 1
    print(summary, file=sys.stderr if status else sys.stdout)
    return status


if __name__ == "__main__":
    sys.exit(main())
