"""SweepRunner: execute ScenarioSpecs with shared caches, process fan-out, and
an on-disk result cache.

Per-process context caches (module-level, so they survive across scenarios
handled by the same worker):

  * networks keyed by the spec's topology signature — so the cached Dijkstra
    frontiers on ``PhysicalNetwork`` accumulate across grid points;
  * model profiles keyed by profile signature — so the prefix-sum tables are
    built once;
  * ``EvalCache`` keyed by (topology, profile) — batch/mode live in the
    cache's own entry keys, so per-(node, segment) compute/fit tables are
    shared by every scheme, candidate seed, and (b, mode) cell of the grid.

The on-disk cache (``<cache_dir>/<spec_hash>.json``) memoizes finished
scenario results, making warm re-runs of a suite near-instant.

The device belongs to the runner, not to the spec: ``SweepRunner(...,
device="cuda")`` (the default) hands every solver that takes a device
(``dfts_torch``, ``bcd_torch``) that device unless the spec's
``solver_kwargs`` name one; host solvers get their kwargs unchanged.
Outcomes are the same on either device, so a spec's key and hash carry no
device and one disk-cache entry serves both.  The worker pool runs under
``spawn``: a forked child cannot initialise CUDA again.
"""
from __future__ import annotations

import json
import multiprocessing
import os
import time
from concurrent.futures import FIRST_COMPLETED, ProcessPoolExecutor, wait
from dataclasses import asdict, dataclass
from pathlib import Path

import torch

from ..core import (EvalCache, LatencyBreakdown, Plan, PlanEvaluator,
                    SolveOutcome, get_solver, solve, solve_batch)
from ..core.torch_solvers import resolve_device
from ..serve.planner import device_kwargs
from .spec import ScenarioSpec


@dataclass
class ScenarioResult:
    """Structured outcome of one grid point (JSON round-trippable).

    Serve scenarios (``spec.n_requests > 1``) fill the fleet fields instead of
    the single-plan ones: ``latency_s`` is then the mean accepted-chain
    latency, ``served`` holds the per-request admission records (enough to
    replay and re-verify residual-capacity conservation), and ``iterations``
    counts capacity-aware replans.
    """

    spec: ScenarioSpec
    feasible: bool
    status: str | None = None  # SolveOutcome status, or "error" (see `error`)
    solver_stats: dict | None = None  # SolveOutcome.stats (portfolio members, ...)
    error: str | None = None  # exception repr when the scenario crashed
    latency_s: float | None = None
    computation_s: float | None = None
    transmission_s: float | None = None
    propagation_s: float | None = None
    bubble_s: float | None = None  # pipeline drain term; None/0 for seq
    wall_time_s: float = 0.0
    iterations: int = 0
    segments: list | None = None
    placement: list | None = None
    paths: list | None = None
    tail_path: list | None = None
    from_cache: bool = False
    # serve-layer (fleet) fields
    n_accepted: int | None = None
    acceptance_ratio: float | None = None
    latency_p50_s: float | None = None
    latency_p95_s: float | None = None
    latency_p99_s: float | None = None
    served: list | None = None  # per-request admission records
    # per-mode (IF vs TR) admission breakdown of mixed training fleets
    # (docs/training.md): acceptance + latency percentiles split by mode
    mode_split: dict | None = None
    # event-driven sim scenarios (spec.sim, docs/sim.md)
    blocking_probability: float | None = None
    peak_concurrent: int | None = None
    n_retried: int | None = None
    sim: dict | None = None  # SimOutcome.sim_summary(): curves, epochs, ...
    # cache observability (docs/gateway.md): hit rates over the scenario run
    eval_cache_hit_rate: float | None = None
    plan_cache_hit_rate: float | None = None
    # gateway scenarios (spec.gateway): GatewayOutcome.gateway_stats summary
    gateway: dict | None = None
    # failure scenarios (spec.failure_rate / spec.failures, docs/failures.md):
    # survivability metrics from FailureOutcome.failure_summary()
    n_failed: int | None = None
    n_restored: int | None = None
    restore_p95_s: float | None = None
    moved_bytes: float | None = None

    def to_dict(self) -> dict:
        d = asdict(self)
        d["spec"] = self.spec.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ScenarioResult":
        d = dict(d)
        d["spec"] = ScenarioSpec.from_dict(d["spec"])
        return cls(**d)

    def plan(self) -> Plan | None:
        if not self.feasible:
            return None
        return Plan(segments=[tuple(s) for s in self.segments],
                    placement=list(self.placement),
                    paths=[list(p) for p in self.paths],
                    tail_path=list(self.tail_path or []))


# ------------------------------------------------------- per-process context
_NETS: dict = {}
_PROFILES: dict = {}
_EVAL_CACHES: dict = {}


def _context(spec: ScenarioSpec):
    topo_key = json.dumps([spec.topology, spec.topology_kwargs, spec.drop_nodes,
                           spec.drop_links], sort_keys=True)
    prof_key = json.dumps([spec.profile, spec.profile_kwargs], sort_keys=True)
    net = _NETS.get(topo_key)
    if net is None:
        net = _NETS[topo_key] = spec.build_network()
    profile = _PROFILES.get(prof_key)
    if profile is None:
        profile = _PROFILES[prof_key] = spec.build_profile()
    # batch/mode are part of EvalCache entry keys, so one cache per
    # (network, profile) pair is shared across every cell of the grid
    ev_key = (topo_key, prof_key)
    cache = _EVAL_CACHES.get(ev_key)
    if cache is None:
        cache = _EVAL_CACHES[ev_key] = EvalCache()
    return net, profile, cache


def clear_context() -> None:
    """Drop the per-process memo tables (tests use this to force cold runs)."""
    _NETS.clear()
    _PROFILES.clear()
    _EVAL_CACHES.clear()


def _run_serve_scenario(spec: ScenarioSpec, net, profile, cache,
                        device: str | torch.device = "cuda") -> ScenarioResult:
    """One fleet scenario (spec.n_requests > 1) through repro_torch.serve: a
    static admission round, the event-driven `ServeSim` (``spec.sim``), or
    the long-running `ServeGateway` (``spec.gateway``, docs/gateway.md),
    its solver on ``device`` where it takes one."""
    from ..serve import GatewayConfig, ServeGateway, ServePlanner, ServeSim

    solver_kwargs = device_kwargs(spec.solver, spec.solver_kwargs, device)
    fleet = spec.build_fleet(net)
    # failure_rate == 0 and no explicit schedule -> failures is None, so the
    # failure-free drivers are bit-for-bit the pre-failure code path
    failures = spec.build_failures(net, fleet) or None
    if spec.sim:
        runner = ServeSim(net, profile, solver=spec.solver, cache=cache,
                          retry=spec.retry, solver_kwargs=solver_kwargs)
        outcome = runner.run(fleet, policy=spec.policy, failures=failures)
    elif spec.gateway:
        gw = ServeGateway(
            net, profile, solver=spec.solver, policy=spec.policy,
            config=GatewayConfig(batch_window_s=spec.batch_window_s,
                                 max_queue=spec.max_queue,
                                 slo_latency_s=spec.slo_latency_s,
                                 retry=spec.retry),
            cache=cache, solver_kwargs=solver_kwargs)
        outcome = gw.run_stream(fleet, failures=failures)
    else:
        planner = ServePlanner(net, profile, solver=spec.solver, cache=cache,
                               solver_kwargs=solver_kwargs)
        outcome = planner.admit(fleet, policy=spec.policy)
    s = outcome.summary()
    res = ScenarioResult(
        spec, outcome.n_accepted > 0,
        status=outcome.status,
        solver_stats=outcome.solver_stats(),
        latency_s=s["latency_mean_s"],
        wall_time_s=outcome.wall_time_s,
        iterations=outcome.n_replanned,
        n_accepted=outcome.n_accepted,
        acceptance_ratio=outcome.acceptance_ratio,
        latency_p50_s=s["latency_p50_s"],
        latency_p95_s=s["latency_p95_s"],
        latency_p99_s=s["latency_p99_s"],
        served=[sr.to_dict() for sr in outcome.served],
        mode_split=outcome.mode_split(),
    )
    cs = outcome.cache_stats or {}
    res.eval_cache_hit_rate = cs.get("eval_cache", {}).get("hit_rate")
    res.plan_cache_hit_rate = cs.get("plan_cache", {}).get("hit_rate")
    if spec.sim or spec.gateway:
        res.blocking_probability = outcome.blocking_probability
        res.peak_concurrent = outcome.peak_concurrent
        res.n_retried = outcome.n_retried
        res.sim = outcome.sim_summary()
        if failures is not None:
            fs = outcome.failure_summary()
            res.n_failed = fs["n_failed"]
            res.n_restored = fs["n_restored"]
            res.restore_p95_s = fs["restore_p95_s"]
            res.moved_bytes = fs["moved_bytes"]
    if spec.gateway:
        res.gateway = outcome.gateway_stats
    return res


def _presolve_key(spec: ScenarioSpec, problem) -> tuple:
    """Identity under which a batch-presolved outcome may substitute for a
    scalar solve: same solver, same solver kwargs, same instance content."""
    return (spec.solver, json.dumps(spec.solver_kwargs, sort_keys=True,
                                    default=str), problem.content_hash())


def run_scenario(spec: ScenarioSpec, use_context_cache: bool = True,
                 presolved: dict | None = None,
                 device: str | torch.device = "cuda") -> ScenarioResult:
    """Solve one grid point in-process, the solver on ``device`` where it
    takes one (the card by default; without one this raises unless
    ``device="cpu"``).

    ``presolved`` optionally maps :func:`_presolve_key` identities to
    :class:`SolveOutcome`s computed up front by a batched solver dispatch
    (see :meth:`SweepRunner._batch_presolve`); hits skip the scalar solve.
    """
    if use_context_cache:
        net, profile, cache = _context(spec)
    else:
        net, profile, cache = spec.build_network(), spec.build_profile(), None
    if spec.n_requests > 1:
        return _run_serve_scenario(spec, net, profile, cache, device)
    problem = spec.problem(net, profile)
    res: SolveOutcome | None = None
    if presolved:
        res = presolved.get(_presolve_key(spec, problem))
    if res is None:
        res = solve(problem, spec.solver, cache=cache,
                    **device_kwargs(spec.solver, spec.solver_kwargs, device))
    if not res.feasible:
        return ScenarioResult(spec, False, status=res.status,
                              solver_stats=res.stats or None,
                              wall_time_s=res.wall_time_s,
                              iterations=res.iterations)
    lb: LatencyBreakdown = res.latency
    p = res.plan
    return ScenarioResult(
        spec, True,
        status=res.status,
        solver_stats=res.stats or None,
        latency_s=lb.total_s,
        computation_s=lb.computation_s,
        transmission_s=lb.transmission_s,
        propagation_s=lb.propagation_s,
        bubble_s=lb.bubble_s,
        wall_time_s=res.wall_time_s,
        iterations=res.iterations,
        segments=[list(s) for s in p.segments],
        placement=list(p.placement),
        paths=[list(path) for path in p.paths],
        tail_path=list(p.tail_path),
    )


def verify_result(result: ScenarioResult, atol: float = 1e-9) -> bool:
    """Re-evaluate a (possibly reloaded) result against the freshly built
    scenario — the artifact round-trip check.

    Single-chain results re-check the plan and its recorded latency; serve
    results replay the admission records in order and confirm the accepted
    chains never oversubscribe any residual link/node capacity, plus the
    recorded acceptance bookkeeping.  Sim results replay the full event trace
    (commits at admit times, releases at departures) with conservation
    re-checked after every event (`repro_torch.serve.replay_verify_sim`).
    """
    spec = result.spec
    if result.error is not None:
        return False  # a crashed scenario has nothing verifiable
    if spec.n_requests > 1:
        from ..serve import ServedRequest, replay_verify, replay_verify_sim

        served = [ServedRequest.from_dict(d) for d in (result.served or [])]
        if len(served) != spec.n_requests:
            return False
        n_acc = sum(s.accepted for s in served)
        if n_acc != result.n_accepted:
            return False
        if abs((n_acc / len(served)) - result.acceptance_ratio) > atol:
            return False
        net, profile = spec.build_network(), spec.build_profile()
        if spec.sim or spec.gateway:
            # gateway traces carry the same admit/depart timestamps as sim
            # traces, so the event-replay verifier covers both drivers
            n_blocked = sum(1 for s in served
                            if not s.accepted and s.reason == "capacity")
            if abs((n_blocked / len(served))
                   - (result.blocking_probability or 0.0)) > atol:
                return False
            # the failure schedule is deterministic from the spec, so the
            # verifier replays the exact marks the run was produced under
            failures = spec.build_failures(net, spec.build_fleet(net)) or None
            return replay_verify_sim(net, profile, served, failures=failures)
        return replay_verify(net, profile, served)
    if not result.feasible:
        return True
    net, profile = spec.build_network(), spec.build_profile()
    ev = PlanEvaluator(net, profile, spec.request())
    plan = result.plan()
    ev.check(plan)
    return abs(ev.latency_s(plan) - result.latency_s) <= atol


def _worker(args: tuple[dict, bool, str]) -> dict:
    spec_dict, use_context_cache, device = args
    return run_scenario(ScenarioSpec.from_dict(spec_dict),
                        use_context_cache=use_context_cache,
                        device=device).to_dict()


class SweepRunner:
    """Executes a list of ScenarioSpecs with optional process fan-out and an
    on-disk result cache keyed by spec content hash.

    ``workers`` follows one explicit mapping (see :meth:`resolve_workers`,
    covered by tests and docs/sweep.md): ``0`` or ``1`` runs serially
    in-process (the default), ``n >= 2`` fans out over ``n`` worker
    processes, and ``None`` or any negative value expands to
    ``os.cpu_count()``.

    ``use_context_cache=False`` rebuilds the network/profile and uses a fresh
    EvalCache for every scenario — required when solver *wall time* is the
    measurement (warm shared caches would flatter whichever scheme runs last).

    ``device`` is where the solvers that take one run, in this process and
    in every worker (``"cuda"`` by default); it is resolved here, so without
    a card the runner raises unless ``device="cpu"``.  Workers are spawned,
    never forked.
    """

    def __init__(self, cache_dir: str | Path | None = None,
                 workers: int | None = 0, use_disk_cache: bool = True,
                 use_context_cache: bool = True,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.cache_dir = Path(cache_dir) if cache_dir else None
        self.workers = self.resolve_workers(workers)
        self.use_disk_cache = use_disk_cache and self.cache_dir is not None
        self.use_context_cache = use_context_cache
        self.last_stats: dict = {}

    @staticmethod
    def resolve_workers(workers: int | None) -> int:
        """The one place the ``workers`` argument is interpreted:

        * ``0`` or ``1`` -> serial, in-process (no pool is created);
        * ``n >= 2``     -> ``n`` worker processes;
        * ``None`` / negative -> ``os.cpu_count()`` (use every core).
        """
        if workers is None or workers < 0:
            return os.cpu_count() or 1
        return workers

    # ------------------------------------------------------------- disk cache
    def _cache_path(self, spec: ScenarioSpec) -> Path:
        return self.cache_dir / f"{spec.spec_hash()}.json"

    def _load_cached(self, spec: ScenarioSpec) -> ScenarioResult | None:
        path = self._cache_path(spec)
        if not path.exists():
            return None
        try:
            res = ScenarioResult.from_dict(json.loads(path.read_text()))
        except (json.JSONDecodeError, KeyError, TypeError):
            return None
        # tolerate label/tag edits: only the solve-relevant key must match
        if res.spec.key() != spec.key():
            return None
        res.spec = spec
        res.from_cache = True
        return res

    def _store(self, result: ScenarioResult) -> None:
        self.cache_dir.mkdir(parents=True, exist_ok=True)
        self._cache_path(result.spec).write_text(json.dumps(result.to_dict()))

    # -------------------------------------------------------------------- run
    def _batch_presolve(self, specs: list[ScenarioSpec]) -> dict:
        """Vectorized pre-pass for the serial path: group single-chain
        scenarios by (solver, solver_kwargs), and for solvers registered
        with a batch entry (``capabilities()["batched"]``) dispatch each
        group through :func:`repro_torch.core.solve_batch` once, on the
        runner's device.  Returns the ``presolved`` map
        :func:`run_scenario` consumes; scenarios not in it
        (serve fleets, scalar-only solvers, unknown solvers) fall through to
        the ordinary scalar solve.  Disabled with ``use_context_cache=False``
        — that mode exists to measure honest per-scenario wall time, which a
        shared warm batch would flatter."""
        if not self.use_context_cache:
            return {}
        groups: dict[tuple, list[ScenarioSpec]] = {}
        for spec in specs:
            if spec.n_requests > 1:
                continue
            try:
                info = get_solver(spec.solver)
            except ValueError:
                continue  # unknown solver: let run_scenario raise per-item
            if info.batch_fn is None:
                continue
            kw = json.dumps(spec.solver_kwargs, sort_keys=True, default=str)
            groups.setdefault((spec.solver, kw), []).append(spec)
        presolved: dict = {}
        for (solver, _), members in groups.items():
            if len(members) < 2:
                continue  # nothing to amortize
            try:
                problems = [s.problem(*_context(s)[:2]) for s in members]
                outs = solve_batch(problems, solver, **device_kwargs(
                    solver, members[0].solver_kwargs, self.device))
            except Exception:  # noqa: BLE001 — presolve is best-effort
                continue  # scalar path will solve (and surface errors) per item
            for s, p, o in zip(members, problems, outs):
                presolved[_presolve_key(s, p)] = o
        return presolved

    @staticmethod
    def _error_result(spec: ScenarioSpec, exc: BaseException) -> ScenarioResult:
        """A crashed scenario becomes an infeasible `status="error"` record —
        the sweep keeps going and the failure stays visible in the artifact."""
        return ScenarioResult(spec, False, status="error",
                              error=f"{type(exc).__name__}: {exc}")

    def run(self, specs: list[ScenarioSpec]) -> list[ScenarioResult]:
        """Execute every spec; one scenario crashing never loses the sweep.

        Per-scenario exceptions (worker or in-process) are captured into
        `status="error"` results; completed results are still stored to the
        disk cache (errored ones are not, so a transient failure is retried
        on the next run), and ``last_stats["n_errors"]`` reports the count.
        """
        t0 = time.perf_counter()
        results: list[ScenarioResult | None] = [None] * len(specs)
        misses: list[int] = []
        for idx, spec in enumerate(specs):
            if self.use_disk_cache:
                hit = self._load_cached(spec)
                if hit is not None:
                    results[idx] = hit
                    continue
            misses.append(idx)

        if misses and self.workers >= 2 and len(misses) > 1:
            # submit() instead of map(): map() re-raises the first worker
            # exception when iterated, losing every other result of the sweep
            with ProcessPoolExecutor(
                    max_workers=self.workers,
                    mp_context=multiprocessing.get_context("spawn")) as pool:
                futures = {
                    pool.submit(_worker, (specs[i].to_dict(),
                                          self.use_context_cache,
                                          str(self.device))): i
                    for i in misses}
                not_done = set(futures)
                while not_done:
                    done, not_done = wait(not_done, return_when=FIRST_COMPLETED)
                    for fut in done:
                        idx = futures[fut]
                        try:
                            res = ScenarioResult.from_dict(fut.result())
                            res.spec = specs[idx]  # identity incl. name/tags
                        except Exception as exc:  # noqa: BLE001 — per-item capture
                            res = self._error_result(specs[idx], exc)
                        results[idx] = res
        else:
            presolved = self._batch_presolve([specs[i] for i in misses])
            for idx in misses:
                try:
                    results[idx] = run_scenario(
                        specs[idx], use_context_cache=self.use_context_cache,
                        presolved=presolved, device=self.device)
                except Exception as exc:  # noqa: BLE001 — per-item capture
                    results[idx] = self._error_result(specs[idx], exc)

        if self.use_disk_cache:
            for idx in misses:
                if results[idx].error is None:
                    self._store(results[idx])

        out = [r for r in results if r is not None]
        n_errors = sum(1 for r in out if r.error is not None)
        self.last_stats = {
            "n_scenarios": len(specs),
            "n_cache_hits": len(specs) - len(misses),
            "n_solved": len(misses) - n_errors,
            "n_errors": n_errors,
            "errors": {specs[i].scenario_id(): results[i].error
                       for i in misses if results[i].error is not None},
            "wall_time_s": time.perf_counter() - t0,
        }
        return out
