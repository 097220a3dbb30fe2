"""Rules ``no-shim-import`` and ``unused-import``: import hygiene.

* ``no-shim-import`` — the warn-once ``*_solve`` deprecation shims exist for
  *external* callers only; internal modules importing them would re-entrench
  the legacy API (and their first call burns the one-per-process warning an
  actual user should see).  The shim name list is derived from the
  ``deprecated_solver_alias(...)`` assignments themselves, so a new shim is
  covered the moment it is created.

* ``unused-import`` — the pyflakes-F401 tier as a native rule (the generic
  complement ruff provides where installed; this keeps the gate hermetic).
  Conventions honored: ``from __future__`` imports, ``# noqa`` lines and
  re-export ``__init__.py`` files without ``__all__`` are skipped; any
  simple-identifier string constant in the module (``__all__`` entries,
  registry name tables) counts as a use.
"""
from __future__ import annotations

import ast
from typing import Iterator

from .astutil import call_name
from .base import Finding, ModuleInfo, ProjectContext, Rule, register_rule


@register_rule
class ShimImportRule(Rule):
    name = "no-shim-import"
    description = ("internal modules never import the deprecated warn-once "
                   "*_solve shims (deprecated_solver_alias)")

    def check_project(self, ctx: ProjectContext) -> Iterator[Finding]:
        shims: dict[str, str] = {}  # alias name -> defining module
        for module in ctx.modules:
            for node in ast.walk(module.tree):
                if (isinstance(node, ast.Assign)
                        and isinstance(node.value, ast.Call)
                        and call_name(node.value)
                        == "deprecated_solver_alias"):
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            shims[tgt.id] = module.relpath
        if not shims:
            return
        for module in ctx.modules:
            noqa = module.noqa_lines()
            for node in ast.walk(module.tree):
                if not isinstance(node, ast.ImportFrom):
                    continue
                if node.lineno in noqa:
                    continue
                for alias in node.names:
                    src = shims.get(alias.name)
                    if src is None or src == module.relpath:
                        continue
                    yield Finding(
                        self.name, module.relpath, node.lineno,
                        f"imports deprecated shim {alias.name!r}",
                        f"call the registered solver through the engine "
                        f"instead: solve(ProblemInstance(...), "
                        f"solver=<name>) — the shim in {src} exists only "
                        f"for external callers")


@register_rule
class UnusedImportRule(Rule):
    name = "unused-import"
    description = ("imported names must be used (F401 tier; __init__.py "
                   "re-exports and # noqa lines are exempt)")

    def check_module(self, module: ModuleInfo,
                     ctx: ProjectContext) -> Iterator[Finding]:
        is_init = module.relpath.endswith("__init__.py")
        has_all = any(
            isinstance(n, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__"
                for t in n.targets)
            for n in module.tree.body)
        if is_init and not has_all:
            return  # re-export module: imports ARE the interface

        noqa = module.noqa_lines()
        imported: list[tuple[str, int]] = []  # (bound name, line)
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    bound = alias.asname or alias.name.split(".")[0]
                    imported.append((bound, node.lineno))
            elif isinstance(node, ast.ImportFrom):
                if node.module == "__future__":
                    continue
                for alias in node.names:
                    if alias.name == "*":
                        return  # star imports defeat static use tracking
                    imported.append((alias.asname or alias.name,
                                     node.lineno))

        used: set[str] = set()
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Name):
                used.add(node.id)
            elif (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)
                    and node.value.isidentifier()):
                used.add(node.value)  # __all__ entries, name tables

        for name, line in imported:
            if name in used or line in noqa:
                continue
            yield Finding(
                self.name, module.relpath, line,
                f"imported name {name!r} is never used",
                "delete the import (or mark an intentional re-export with "
                "# noqa)")
