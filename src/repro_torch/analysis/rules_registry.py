"""Rule ``solver-registry``: capability declarations match solver bodies.

``@register_solver(name, schedules=...)`` is the single source of capability
truth — the sweep spec validator, the serve planner and ``solve()`` all trust
it.  A declaration that drifts from the body fails in two directions, both
flagged here:

* **declared but unreachable** — the solver declares ``PIPE`` but no code
  reachable from its body ever branches on the pipelined schedule (no
  ``request.schedule == PIPE`` test, no call into a pipe-handling helper):
  pipelined requests would silently get sequential plans;
* **handled but undeclared** — the body (transitively) contains a pipelined
  code path but the registration omits ``PIPE``: the capability gate would
  reject requests the solver actually models, or worse, a later widening of
  the declaration would "work" untested.

Reachability is a conservative intra-project call-graph walk: bare-name
calls resolved through local defs and ``from`` imports, stopping at the
engine/evaluator layer (``ensure_solver_supported``, ``PlanEvaluator`` and
friends are the *gate* and the *pricer* — every solver touches them, so
traversing them would make the check vacuous).  A ``schedule == PIPE`` test
whose branch only raises counts as a *guard*, not as handling — rejecting
pipe without declaring it is exactly right.
"""
from __future__ import annotations

import ast
from pathlib import PurePosixPath
from typing import Iterator

from .astutil import call_name
from .base import Finding, ModuleInfo, ProjectContext, Rule, register_rule

# engine / evaluation machinery: never traversed (see module docstring)
BOUNDARY_CALLEES = frozenset({
    "ensure_solver_supported", "solver_supports", "get_solver", "solve",
    "solve_batch", "register_solver", "PlanEvaluator", "EvalCache",
})
BOUNDARY_MODULES = frozenset({
    "engine", "plan", "costmodel", "problem", "network", "topology",
})

SCHEDULE_NAMES = {"SEQ": "seq", "PIPE": "pipe"}


@register_rule
class SolverRegistryRule(Rule):
    name = "solver-registry"
    description = ("@register_solver schedules= declarations match what the "
                   "solver body (transitively) actually handles")

    def check_project(self, ctx: ProjectContext) -> Iterator[Finding]:
        index = _FunctionIndex(ctx)
        for module, fn, reg_line, declared in _registrations(ctx):
            if declared is None:
                continue  # meta solver or schedules we cannot evaluate
            handles, guards = _pipe_evidence(index, module, fn)
            if "pipe" in declared and not handles:
                yield Finding(
                    self.name, module.relpath, reg_line,
                    f"solver {fn.name!r} declares schedule 'pipe' but no "
                    f"reachable code branches on the pipelined schedule",
                    "either drop PIPE from the registration's schedules= or "
                    "add the pipelined code path (a request.schedule == "
                    "PIPE branch / a *pipe helper call)")
            if "pipe" not in declared and handles:
                yield Finding(
                    self.name, module.relpath, reg_line,
                    f"solver {fn.name!r} handles pipelined requests without "
                    f"declaring schedule 'pipe'",
                    "add PIPE to the registration's schedules= so the "
                    "capability gate (solver_supports) stops rejecting "
                    "requests the body actually models")


# ---------------------------------------------------------------- extraction
def _registrations(ctx: ProjectContext):
    """(module, function-def, registration-line, declared-schedules|None)
    for every ``register_solver`` application — decorator form and the
    ``register_solver(...)(fn)`` call form."""
    for module in ctx.modules:
        local_fns = {n.name: n for n in module.tree.body
                     if isinstance(n, ast.FunctionDef)}
        for node in module.tree.body:
            if isinstance(node, ast.FunctionDef):
                for deco in node.decorator_list:
                    if (isinstance(deco, ast.Call)
                            and call_name(deco) == "register_solver"):
                        yield (module, node, deco.lineno,
                               _declared_schedules(deco))
            else:
                for call in ast.walk(node):
                    # register_solver(name, ...)(fn)
                    if (isinstance(call, ast.Call)
                            and isinstance(call.func, ast.Call)
                            and call_name(call.func) == "register_solver"
                            and len(call.args) == 1
                            and isinstance(call.args[0], ast.Name)):
                        fn = local_fns.get(call.args[0].id)
                        if fn is not None:
                            yield (module, fn, call.lineno,
                                   _declared_schedules(call.func))


def _declared_schedules(reg_call: ast.Call) -> frozenset[str] | None:
    """The statically evaluable declared-schedule set; None when the solver
    is meta or the declaration cannot be resolved (no finding either way)."""
    schedules: frozenset[str] | None = frozenset({"seq", "pipe"})  # default
    for kw in reg_call.keywords:
        if kw.arg == "meta" and isinstance(kw.value, ast.Constant) \
                and kw.value.value:
            return None
        if kw.arg != "schedules":
            continue
        if isinstance(kw.value, (ast.Tuple, ast.List)):
            out = set()
            for el in kw.value.elts:
                if isinstance(el, ast.Name) and el.id in SCHEDULE_NAMES:
                    out.add(SCHEDULE_NAMES[el.id])
                elif (isinstance(el, ast.Constant)
                        and el.value in ("seq", "pipe")):
                    out.add(el.value)
                else:
                    return None
            schedules = frozenset(out)
        elif isinstance(kw.value, ast.Name) and kw.value.id == "SCHEDULES":
            schedules = frozenset({"seq", "pipe"})
        else:
            return None
    return schedules


# -------------------------------------------------------------- reachability
class _FunctionIndex:
    """Project-wide bare-name call resolution: local module defs first, then
    ``from``-imports of other analyzed modules (relative or
    ``repro_torch.``-absolute)."""

    def __init__(self, ctx: ProjectContext):
        self.ctx = ctx
        self.defs: dict[str, dict[str, ast.FunctionDef]] = {}
        self.imports: dict[str, dict[str, tuple[str, str]]] = {}
        by_path = {m.relpath: m for m in ctx.modules}
        for m in ctx.modules:
            self.defs[m.relpath] = {
                n.name: n for n in m.tree.body
                if isinstance(n, ast.FunctionDef)}
            imp: dict[str, tuple[str, str]] = {}
            for node in ast.walk(m.tree):
                if not isinstance(node, ast.ImportFrom) or node.module is None:
                    continue
                target = _resolve_module(m.relpath, node, by_path)
                if target is None:
                    continue
                for alias in node.names:
                    imp[alias.asname or alias.name] = (target, alias.name)
            self.imports[m.relpath] = imp

    def resolve(self, relpath: str,
                name: str) -> tuple[str, ast.FunctionDef] | None:
        fn = self.defs.get(relpath, {}).get(name)
        if fn is not None:
            return relpath, fn
        imp = self.imports.get(relpath, {}).get(name)
        if imp is not None:
            target, orig = imp
            if PurePosixPath(target).stem in BOUNDARY_MODULES:
                return None
            fn = self.defs.get(target, {}).get(orig)
            if fn is not None:
                return target, fn
        return None


def _resolve_module(relpath: str, node: ast.ImportFrom,
                    by_path: dict) -> str | None:
    """Map an ImportFrom to an analyzed module's relpath (or None)."""
    parts = node.module.split(".")
    if node.level:  # relative: walk up from the importing module's package
        base = PurePosixPath(relpath).parent
        for _ in range(node.level - 1):
            base = base.parent
        cand = (base.joinpath(*parts)).as_posix() + ".py"
    else:  # absolute: match by dotted-path suffix against analyzed modules
        suffix = "/".join(parts) + ".py"
        cands = [p for p in by_path if p.endswith(suffix)]
        cand = cands[0] if len(cands) == 1 else None
    return cand if cand in by_path else None


def _pipe_evidence(index: _FunctionIndex, module: ModuleInfo,
                   fn: ast.FunctionDef) -> tuple[bool, bool]:
    """(handles, guards): walk the conservative call graph from ``fn`` and
    look for pipelined-schedule evidence (see module docstring)."""
    handles = guards = False
    visited: set[tuple[str, str]] = set()
    stack: list[tuple[str, ast.FunctionDef]] = [(module.relpath, fn)]
    while stack:
        relpath, cur = stack.pop()
        if (relpath, cur.name) in visited:
            continue
        visited.add((relpath, cur.name))
        h, g = _scan_body(cur)
        handles |= h
        guards |= g
        for node in ast.walk(cur):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
                callee = node.func.id
                if callee in BOUNDARY_CALLEES:
                    continue
                if "pipe" in callee.lower():
                    handles = True  # calling a pipe helper IS handling
                target = index.resolve(relpath, callee)
                if target is not None:
                    stack.append(target)
    return handles, guards


def _scan_body(fn: ast.FunctionDef) -> tuple[bool, bool]:
    """Pipe evidence inside one function body: ``== PIPE`` comparisons are
    *handling* unless the enclosing if-branch consists solely of raises
    (then they are a guard)."""
    handles = guards = False
    guard_compares: set[ast.AST] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.If) and _mentions_pipe(node.test) and all(
                isinstance(s, ast.Raise) for s in node.body):
            guards = True
            for sub in ast.walk(node.test):
                guard_compares.add(sub)
    for node in ast.walk(fn):
        if isinstance(node, ast.Compare) and node not in guard_compares \
                and _mentions_pipe(node):
            handles = True
    return handles, guards


def _mentions_pipe(expr: ast.AST) -> bool:
    for sub in ast.walk(expr):
        if isinstance(sub, ast.Name) and sub.id == "PIPE":
            return True
        if isinstance(sub, ast.Constant) and sub.value == "pipe":
            return True
    return False
