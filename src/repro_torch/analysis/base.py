"""repro-lint core: the Rule protocol, Finding records, and project context.

The framework is deliberately tiny and stdlib-only (``ast`` + ``pathlib``) so
``python -m repro_torch.analysis`` runs anywhere the repo checks out — CI's
docs-sync job installs no scientific stack, and the linter must not drag one
in.

Two rule granularities cover everything in the catalog:

* **per-module** rules implement :meth:`Rule.check_module` and get one parsed
  :class:`ModuleInfo` at a time (most AST rules);
* **project** rules implement :meth:`Rule.check_project` and get the whole
  :class:`ProjectContext` — for cross-file invariants (cache-key families
  must stay arity-disjoint *across* modules, docs-sync reads markdown, the
  solver-registry rule follows calls between solver modules).

A rule may implement both; ``run_rules`` calls whichever are overridden.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path
from typing import Iterable, Iterator


@dataclass(frozen=True)
class Finding:
    """One diagnostic: which rule fired, where, what, and how to fix it.

    ``message`` is the finding's stable identity half (with ``rule`` and
    ``path``) for baseline matching — keep line numbers and other drift-prone
    detail out of it so a baseline entry survives unrelated edits to the
    file.  ``suggestion`` is the actionable remediation shown under the
    finding; it never participates in matching.
    """

    rule: str
    path: str  # repo-relative, '/'-separated
    line: int
    message: str
    suggestion: str = ""
    col: int = 0

    def fingerprint(self) -> str:
        """Line-independent identity used by the baseline file."""
        return f"{self.rule}\t{self.path}\t{self.message}"

    def render(self) -> str:
        loc = f"{self.path}:{self.line}:{self.col}"
        out = f"{loc}: [{self.rule}] {self.message}"
        if self.suggestion:
            out += f"\n    fix: {self.suggestion}"
        return out


@dataclass
class ModuleInfo:
    """One parsed source file: path, text, and its ``ast`` tree."""

    path: Path  # absolute
    relpath: str  # repo-relative, '/'-separated
    source: str
    tree: ast.Module

    @classmethod
    def parse(cls, path: Path, root: Path) -> "ModuleInfo":
        source = path.read_text()
        rel = path.resolve().relative_to(root).as_posix()
        return cls(path, rel, source, ast.parse(source, filename=str(path)))

    def line(self, node: ast.AST) -> int:
        return getattr(node, "lineno", 1)

    def noqa_lines(self) -> set[int]:
        """Line numbers carrying a ``# noqa`` marker (any code)."""
        out = set()
        for i, text in enumerate(self.source.splitlines(), start=1):
            if "# noqa" in text:
                out.add(i)
        return out


@dataclass
class ProjectContext:
    """Everything a cross-file rule can see: the repo root, every parsed
    module under the analyzed paths, and parse failures (reported as findings
    by ``run_rules``, so a syntax error can't silently hide a whole file)."""

    root: Path
    modules: list[ModuleInfo] = field(default_factory=list)
    parse_errors: list[Finding] = field(default_factory=list)

    def module(self, relpath: str) -> ModuleInfo | None:
        for m in self.modules:
            if m.relpath == relpath:
                return m
        return None

    def modules_under(self, prefix: str) -> list[ModuleInfo]:
        return [m for m in self.modules if m.relpath.startswith(prefix)]


class Rule:
    """Base class for lint rules.

    Subclasses set ``name`` (the rule id used in reports, ``--select`` and
    the baseline file) and ``description`` (one line for ``--list-rules``),
    then override :meth:`check_module` and/or :meth:`check_project`.
    """

    name: str = ""
    description: str = ""

    def check_module(self, module: ModuleInfo,
                     ctx: ProjectContext) -> Iterator[Finding]:
        return iter(())

    def check_project(self, ctx: ProjectContext) -> Iterator[Finding]:
        return iter(())


# -------------------------------------------------------------- rule registry
_RULES: dict[str, Rule] = {}


def register_rule(cls: type[Rule]) -> type[Rule]:
    """Class decorator adding a rule to the catalog (mirrors the solver
    registry idiom: registration *is* discovery — the CLI and docs list
    whatever is registered, nothing else to update)."""
    inst = cls()
    if not inst.name:
        raise ValueError(f"rule class {cls.__name__} must set a name")
    if inst.name in _RULES:
        raise ValueError(f"rule {inst.name!r} is already registered")
    _RULES[inst.name] = inst
    return cls


def rule_names() -> tuple[str, ...]:
    _ensure_rules_loaded()
    return tuple(sorted(_RULES))


def get_rules(select: Iterable[str] | None = None) -> list[Rule]:
    """The selected rule instances (all registered rules by default).
    Unknown names raise with the known catalog, mirroring ``get_solver``."""
    _ensure_rules_loaded()
    if select is None:
        return [_RULES[n] for n in sorted(_RULES)]
    out = []
    for name in select:
        if name not in _RULES:
            raise ValueError(f"unknown rule {name!r}; registered rules: "
                             f"{sorted(_RULES)}")
        out.append(_RULES[name])
    return out


_RULES_LOADED = False


def _ensure_rules_loaded() -> None:
    # Importing the rule modules runs their @register_rule decorators; lazy
    # for the same reason the solver registry is (standalone import, no
    # cycles, cheap repeated lookups).
    global _RULES_LOADED
    if _RULES_LOADED:
        return
    from . import (rules_cache, rules_determinism, rules_docs,  # noqa: F401
                   rules_hygiene, rules_registry, rules_spec)
    _RULES_LOADED = True


# --------------------------------------------------------------- the run
def collect_modules(paths: list[Path], root: Path) -> ProjectContext:
    """Parse every ``*.py`` under ``paths`` into a :class:`ProjectContext`.
    Unparseable files become findings under the pseudo-rule ``parse-error``
    instead of crashing the run."""
    ctx = ProjectContext(root=root)
    seen: set[Path] = set()
    files: list[Path] = []
    for p in paths:
        p = p.resolve()
        cands = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in cands:
            if f not in seen:
                seen.add(f)
                files.append(f)
    for f in files:
        try:
            ctx.modules.append(ModuleInfo.parse(f, root))
        except SyntaxError as e:
            rel = f.resolve().relative_to(root).as_posix()
            ctx.parse_errors.append(Finding(
                "parse-error", rel, e.lineno or 1,
                f"file does not parse: {e.msg}"))
    return ctx


def run_rules(ctx: ProjectContext,
              rules: Iterable[Rule] | None = None) -> list[Finding]:
    """Run the rule catalog over a collected context; findings come back in
    (path, line, rule) order plus any parse errors first."""
    findings: list[Finding] = list(ctx.parse_errors)
    for rule in (get_rules() if rules is None else rules):
        for m in ctx.modules:
            findings.extend(rule.check_module(m, ctx))
        findings.extend(rule.check_project(ctx))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule, f.message))
    return findings


def run_analysis(paths: list[Path], root: Path,
                 select: Iterable[str] | None = None) -> list[Finding]:
    """One-call API (the tests' entry point): parse + run selected rules."""
    return run_rules(collect_modules(paths, root), get_rules(select))
