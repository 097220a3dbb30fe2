"""SolverEngine: capability-aware solver registry + the uniform solve() entry.

Every solver is a function with the uniform protocol

    fn(net, profile, request, K, candidates, *, cache=None, **kwargs)
      -> SolveResult

registered under a name with *declared capabilities*::

    @register_solver("bcd", schedules=(SEQ, PIPE), optimal=False,
                     description="paper Alg. 1 heuristic")
    def bcd_solve(net, profile, request, K, candidates, ...): ...

The registry is the single source of solver names (``solver_names()``) and
capability rules (``solver_supports()``): the layers that used to hardcode
checks like "ilp models schedule='seq' only" (sweep spec validation, serve
planner dispatch, the ilp pipe-raise) all route through it and get uniform,
actionable errors.  Adding a solver — learned, randomized, or external — is
one decorator; it immediately becomes sweepable (``ScenarioSpec(solver=...)``)
and servable (``ServePlanner(solver=...)``) with no other change.

:func:`solve` is the engine entry point: it takes a
:class:`~repro_torch.core.problem.ProblemInstance`, validates capabilities, runs the
named solver, and wraps the raw :class:`SolveResult` into a
:class:`SolveOutcome` (status ∈ {optimal, feasible, infeasible} + stats).

The ``portfolio`` meta-solver (registered here like any other solver) runs a
configurable member set on one shared :class:`EvalCache` and returns the best
feasible outcome plus per-member stats.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

from .costmodel import PIPE, SCHEDULES, SEQ, effective_microbatches
from .plan import EvalCache
from .problem import (INFEASIBLE, OPTIMAL, ProblemInstance, SolveOutcome,
                      SolveResult)


@dataclass(frozen=True)
class SolverInfo:
    """One registry entry: the solve function plus its declared capabilities."""

    name: str
    fn: Callable[..., SolveResult]
    schedules: tuple[str, ...]  # execution schedules the solver models
    optimal: bool  # provably latency-minimal when feasible
    meta: bool  # composes other registered solvers (e.g. portfolio)
    description: str
    # Optional vectorized entry: batch_fn(problems, *, cache=None, **kw) ->
    # list[SolveResult] aligned with `problems`.  solve_batch() dispatches to
    # it when present and falls back to a scalar solve() loop when not.
    batch_fn: Callable[..., list] | None = None

    def capabilities(self) -> dict:
        """Plain-data capability record (the --list-solvers CLI prints it)."""
        return {
            "name": self.name,
            "schedules": list(self.schedules),
            "optimal": self.optimal,
            "meta": self.meta,
            "batched": self.batch_fn is not None,
            "description": self.description,
        }


_REGISTRY: dict[str, SolverInfo] = {}


def register_solver(
    name: str,
    *,
    schedules: tuple[str, ...] = SCHEDULES,
    optimal: bool = False,
    meta: bool = False,
    description: str = "",
    batch: Callable[..., list] | None = None,
) -> Callable:
    """Decorator registering a solver function under ``name``.

    ``schedules`` declares which execution schedules the solver's objective
    models — a solver without ``PIPE`` is rejected (by ``solver_supports``)
    for requests whose effective pipeline depth exceeds 1, instead of each
    caller re-implementing that rule.  ``batch`` optionally supplies a
    vectorized ``batch(problems, *, cache=None, **kw) -> list[SolveResult]``
    entry that :func:`solve_batch` dispatches through.
    """
    schedules = tuple(schedules)
    unknown = [s for s in schedules if s not in SCHEDULES]
    if unknown or not schedules:
        raise ValueError(f"schedules must be a non-empty subset of "
                         f"{SCHEDULES}, got {schedules}")

    def deco(fn: Callable[..., SolveResult]) -> Callable[..., SolveResult]:
        if name in _REGISTRY:
            raise ValueError(f"solver {name!r} is already registered")
        doc = description or next(
            iter((fn.__doc__ or "").strip().splitlines()), "")
        _REGISTRY[name] = SolverInfo(name, fn, schedules, optimal, meta, doc,
                                     batch)
        return fn

    return deco


def unregister_solver(name: str) -> None:
    """Remove a registered solver (no-op if absent) — for tests and plugins."""
    _REGISTRY.pop(name, None)


_BUILTINS_LOADED = False


def _ensure_builtins() -> None:
    # Importing the solver modules runs their @register_solver decorators.
    # Lazy so `repro_torch.core.engine` works standalone and import cycles can't
    # form (the solver modules import this module at their top level).  The
    # flag keeps the hot registry lookups (every solve/solve_batch item) from
    # re-walking the import machinery.
    global _BUILTINS_LOADED
    if _BUILTINS_LOADED:
        return
    from . import baselines, bcd, exact, ilp, torch_solvers  # noqa: F401
    _BUILTINS_LOADED = True


def solver_names() -> tuple[str, ...]:
    """All registered solver names — THE solver-name list every layer uses."""
    _ensure_builtins()
    return tuple(_REGISTRY)


def get_solver(name: str) -> SolverInfo:
    """Registry lookup with a uniform, actionable unknown-name error."""
    _ensure_builtins()
    info = _REGISTRY.get(name)
    if info is None:
        raise ValueError(f"unknown solver {name!r}; registered solvers: "
                         f"{sorted(_REGISTRY)}")
    return info


def solver_capabilities() -> list[dict]:
    """Capability records of every registered solver (stable registry order)."""
    return [info.capabilities() for info in
            (_REGISTRY[n] for n in solver_names())]


def solver_supports(
    name: str,
    problem: ProblemInstance | None = None,
    *,
    schedule: str | None = None,
    batch_size: int | None = None,
    n_microbatches: int = 1,
) -> tuple[bool, str]:
    """THE capability query: can ``name`` solve this problem?

    Returns ``(ok, reason)``; ``reason`` is an actionable message naming the
    solvers that *do* support the instance.  Pass a full
    :class:`ProblemInstance`, or — before one can be built, e.g. while
    validating a declarative spec — the ``schedule``/``batch_size``/
    ``n_microbatches`` triple.  Raises ``ValueError`` for unknown names.
    """
    info = get_solver(name)
    if problem is not None:
        schedule = problem.request.schedule
        M = problem.request.microbatches()
    else:
        schedule = SEQ if schedule is None else schedule
        if schedule != PIPE:
            M = 1
        elif batch_size is not None:
            M = effective_microbatches(batch_size, n_microbatches)
        else:
            M = max(1, int(n_microbatches))
    effective = PIPE if (schedule == PIPE and M > 1) else SEQ
    if effective not in info.schedules:
        alt = sorted(n for n, i in _REGISTRY.items()
                     if effective in i.schedules and not i.meta)
        kind = "pipelined" if effective == PIPE else "sequential"
        return False, (
            f"solver {name!r} models schedule(s) {list(info.schedules)} only, "
            f"but the request is schedule={schedule!r} with {M} effective "
            f"microbatches; use one of {alt} for {kind} requests")
    return True, ""


def ensure_solver_supported(
    name: str,
    problem: ProblemInstance | None = None,
    **kwargs,
) -> SolverInfo:
    """Like :func:`solver_supports` but raises ``ValueError(reason)``."""
    ok, reason = solver_supports(name, problem, **kwargs)
    if not ok:
        raise ValueError(reason)
    return get_solver(name)


# Unique-instance count below which solve_batch prefers the scalar loop even
# when the solver registers a batch function.  Batched dispatch has fixed
# per-call overhead (encode/pad/device round trip) that only amortizes
# across enough instances.  The value is the JAX package's, taken from its
# CPU benchmark (BENCH_solver.json, warm batched dfts_jax on a CPU); the
# port keeps it unchanged until the card's own crossover is measured.
# Override per call with ``min_batch=`` (1 forces batched dispatch).
SOLVE_BATCH_MIN_BATCH = 4


# ---------------------------------------------------------------- entry point
def solve(
    problem: ProblemInstance,
    solver: str = "bcd",
    *,
    cache: EvalCache | None = None,
    **solver_kwargs,
) -> SolveOutcome:
    """Solve ``problem`` with the named registered solver.

    Validates capabilities first (uniform errors), then runs the solver with
    the uniform protocol and wraps its raw result into a
    :class:`SolveOutcome`.  Plans are bit-for-bit identical to calling the
    underlying solver function directly with the same arguments.
    """
    info = ensure_solver_supported(solver, problem)
    res = info.fn(*problem.solver_args(), cache=cache, **solver_kwargs)
    if isinstance(res, SolveOutcome):
        return res  # meta-solvers build their outcome (status, stats) inline
    return SolveOutcome.from_result(res, optimal=info.optimal)


def solve_batch(
    problems: list[ProblemInstance],
    solver: str = "bcd",
    *,
    cache: EvalCache | None = None,
    dedup: bool = True,
    min_batch: int | None = None,
    **solver_kwargs,
) -> list[SolveOutcome]:
    """Solve many problems with one named solver; returns aligned outcomes.

    Capability validation is per problem (same uniform errors as
    :func:`solve`, raised before any solving starts).  With ``dedup`` (the
    default), content-hash-equal instances are solved once and the outcome
    object is shared across their slots — sound because solvers are
    deterministic functions of the instance content.  Solvers registered with
    a ``batch`` function get the whole unique set in one call (the batched
    JAX solvers pad it into dense arrays); others fall back to a scalar
    :func:`solve` loop, so every registered solver is batch-dispatchable.

    ``min_batch`` (default :data:`SOLVE_BATCH_MIN_BATCH`, the measured
    batched-vs-scalar crossover) routes unique sets smaller than the
    threshold to the scalar loop even when a batch function is registered —
    tiny sets pay more in batch-dispatch overhead than they save.  Outcomes
    are identical either side of the threshold (the batched solvers are
    bit-for-bit twins of their scalar paths); only wall time changes.
    """
    # Support depends only on (schedule, effective M) — validate each distinct
    # signature once, raising at the *first* offending problem like the naive
    # per-problem loop would.
    seen_sigs: set[tuple[str, int]] = set()
    for p in problems:
        sig = (p.request.schedule, p.request.microbatches())
        if sig not in seen_sigs:
            seen_sigs.add(sig)
            ensure_solver_supported(solver, p)
    info = get_solver(solver)
    if not problems:
        return []

    if dedup:
        order: dict[str, int] = {}  # content hash -> index into `unique`
        unique: list[ProblemInstance] = []
        for p in problems:
            h = p.content_hash()
            if h not in order:
                order[h] = len(unique)
                unique.append(p)
        slot = [order[p.content_hash()] for p in problems]
    else:
        unique = list(problems)
        slot = list(range(len(problems)))

    threshold = SOLVE_BATCH_MIN_BATCH if min_batch is None else min_batch
    if info.batch_fn is not None and len(unique) >= threshold:
        results = info.batch_fn(unique, cache=cache, **solver_kwargs)
        outcomes = [r if isinstance(r, SolveOutcome)
                    else SolveOutcome.from_result(r, optimal=info.optimal)
                    for r in results]
    else:
        outcomes = [solve(p, solver, cache=cache, **solver_kwargs)
                    for p in unique]
    if not dedup:
        return outcomes
    return [outcomes[i] for i in slot]


# ------------------------------------------------------- portfolio meta-solver
# Default member set: the heuristic family.  The optimal-class solvers are
# deliberately not defaulted in (exact *is* the answer wherever it is cheap
# enough to run — a portfolio adds nothing on top, and its pipelined
# bottleneck-cap scan is a small-instance oracle); opt them in per call with
# members=("exact", "bcd", ...).
PORTFOLIO_DEFAULT_MEMBERS = ("bcd", "comp-ms", "comm-ms")


@register_solver("portfolio", schedules=(SEQ, PIPE), meta=True,
                 description="best-of-N meta-solver over registered members "
                             "sharing one EvalCache")
def portfolio_solve(
    net,
    profile,
    request,
    K: int,
    candidates: list[list[str]],
    members: tuple[str, ...] | list[str] | None = None,
    cache: EvalCache | None = None,
    member_kwargs: dict[str, dict] | None = None,
) -> SolveOutcome:
    """Run every member solver on one shared cache; keep the best feasible.

    ``members`` defaults to :data:`PORTFOLIO_DEFAULT_MEMBERS`; unknown names
    raise, members that don't support the instance's schedule are skipped and
    recorded as ``unsupported`` in the per-member stats.  ``member_kwargs``
    maps member name -> extra kwargs for that member.  The returned outcome
    is the winning member's plan (objective <= every member's by
    construction), with ``stats["members"]`` carrying each member's status,
    objective, and wall time, and ``stats["winner"]`` the winning name.
    """
    t0 = time.perf_counter()
    cache = cache if cache is not None else EvalCache()
    names = tuple(members) if members is not None else PORTFOLIO_DEFAULT_MEMBERS
    if not names:
        raise ValueError("portfolio needs at least one member solver")
    extra = member_kwargs or {}

    best: SolveOutcome | None = None
    stats: dict = {"members": {}, "winner": None}
    for m in names:
        info = get_solver(m)
        if info.meta:
            raise ValueError(f"portfolio members must be base solvers, got "
                             f"meta-solver {m!r}")
        ok, reason = solver_supports(
            m, schedule=request.schedule, batch_size=request.batch_size,
            n_microbatches=request.n_microbatches)
        if not ok:
            stats["members"][m] = {"status": "unsupported", "reason": reason}
            continue
        res = info.fn(net, profile, request, K, candidates, cache=cache,
                      **extra.get(m, {}))
        out = (res if isinstance(res, SolveOutcome)
               else SolveOutcome.from_result(res, optimal=info.optimal))
        stats["members"][m] = {
            "status": out.status,
            "objective": None if out.plan is None else out.objective,
            "wall_time_s": out.wall_time_s,
            "iterations": out.iterations,
        }
        if out.plan is not None and (best is None
                                     or out.objective < best.objective):
            best = out
            stats["winner"] = m

    wall = time.perf_counter() - t0
    if best is None:
        return SolveOutcome(None, None, wall, solver="portfolio",
                            status=INFEASIBLE, stats=stats)
    # If an optimal-class member was feasible, min over members attains the
    # optimum, so the portfolio outcome inherits the optimality guarantee.
    optimal = any(get_solver(m).optimal
                  and stats["members"][m].get("objective") is not None
                  for m in names if m in stats["members"]
                  and stats["members"][m]["status"] != "unsupported")
    return SolveOutcome(best.plan, best.latency, wall, best.iterations,
                        list(best.history), "portfolio",
                        status=OPTIMAL if optimal else best.status,
                        stats=stats)
