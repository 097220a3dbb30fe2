"""Rule ``docs-sync``: README/docs cross-links and module coverage.

The framework port of ``scripts/check_docs_sync.py`` (the script is now a
thin alias over this rule, same REQUIRED_DOCUMENTED semantics and the same
failure messages):

* every docs/*.md referenced from README.md or another doc exists;
* every docs/*.md on disk is reachable from README.md (no orphans);
* every ``src/repro_torch/...py`` path mentioned in docs exists on disk;
* the mapped subsystems in :data:`REQUIRED_DOCUMENTED` exist *and* are
  mentioned somewhere in README.md or docs/ — the architecture map must not
  go stale silently.

Runs only when the analyzed tree's root actually carries a README.md and a
docs/ directory (fixture projects without docs produce no findings).
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Iterator

from .base import Finding, ProjectContext, Rule, register_rule

LINK_RE = re.compile(r"\(((?:docs/)?[\w.-]+\.md)(?:#[\w-]+)?\)")
SRC_RE = re.compile(r"`(src/repro_torch/[\w/.]+\.py)`")

# Modules the docs must both mention and that must exist on disk — the
# subsystem map in docs/architecture.md and the solver guide go stale
# silently otherwise.  The port's counterparts of the JAX package's list
# (core/torch_solvers.py for core/jax_solvers.py); the link graph is the
# same repo's README and docs/, so both copies check the same links.
REQUIRED_DOCUMENTED = (
    "src/repro_torch/core/torch_solvers.py",
    "src/repro_torch/kernels/minplus.py",
    "src/repro_torch/serve/gateway.py",
    "src/repro_torch/serve/failures.py",
    "src/repro_torch/core/trainpipe.py",
    "src/repro_torch/analysis/base.py",
    "src/repro_torch/analysis/baseline.py",
    "src/repro_torch/analysis/cli.py",
)


def doc_links(path: Path, root: Path) -> set[Path]:
    """docs/*.md paths referenced by markdown links in `path` (repo-relative)."""
    out = set()
    for target in LINK_RE.findall(path.read_text()):
        if target.startswith("docs/"):
            out.add(root / target)
        elif path.parent == root / "docs":
            out.add(root / "docs" / target)
    return out


def docs_sync_errors(root: Path) -> tuple[list[str], int]:
    """(error messages, number of docs reachable from README) — the exact
    checks and messages of the original scripts/check_docs_sync.py."""
    errors: list[str] = []
    readme = root / "README.md"
    reachable = doc_links(readme, root)
    for doc in sorted((root / "docs").glob("*.md")):
        reachable |= doc_links(doc, root)

    for ref in sorted(reachable):
        if not ref.exists():
            errors.append(f"broken doc link: {ref.relative_to(root)}")

    readme_reachable = doc_links(readme, root)
    frontier = list(readme_reachable)
    while frontier:  # transitive closure from README
        doc = frontier.pop()
        if not doc.exists():
            continue
        for ref in doc_links(doc, root):
            if ref not in readme_reachable:
                readme_reachable.add(ref)
                frontier.append(ref)
    for doc in sorted((root / "docs").glob("*.md")):
        if doc not in readme_reachable:
            errors.append(f"orphaned doc (not reachable from README.md): "
                          f"{doc.relative_to(root)}")

    # source modules referenced by full path in docs must exist on disk ...
    all_docs = [readme] + sorted((root / "docs").glob("*.md"))
    docs_text = "\n".join(d.read_text() for d in all_docs)
    for mod in sorted(set(SRC_RE.findall(docs_text))):
        if not (root / mod).exists():
            errors.append(f"doc references missing source module: {mod}")
    # ... and the mapped subsystems must stay documented (by basename)
    for mod in REQUIRED_DOCUMENTED:
        path = root / mod
        if not path.exists():
            errors.append(f"required module missing from tree: {mod}")
        if path.name not in docs_text:
            errors.append(f"module {mod} is not mentioned anywhere in "
                          f"README.md or docs/ (update docs/architecture.md "
                          f"and docs/solvers.md)")
    return errors, len(readme_reachable)


@register_rule
class DocsSyncRule(Rule):
    name = "docs-sync"
    description = ("README/docs links resolve, no orphaned docs, "
                   "REQUIRED_DOCUMENTED modules exist and stay documented")

    def check_project(self, ctx: ProjectContext) -> Iterator[Finding]:
        root = ctx.root
        if not ((root / "README.md").exists() and (root / "docs").is_dir()):
            return
        errors, _ = docs_sync_errors(root)
        for msg in errors:
            yield Finding(self.name, "README.md", 1, msg,
                          "see docs/analysis.md (docs-sync) for the doc "
                          "graph conventions")
