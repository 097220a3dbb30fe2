"""ServePlanner — concurrent multi-request admission onto one fabric.

Admission round (one call to :meth:`ServePlanner.admit`):

1. **Pre-solve** every distinct request shape once against the *snapshot*
   (the uncontended base network) with shared caches — one `EvalCache`
   (batch/mode-keyed) and the network's dense frontier matrices, so the
   vectorized DFTS relaxations are shared across the whole fleet.  With a
   :class:`~repro_torch.serve.plancache.PlanCache` attached, shapes already solved
   by *earlier* rounds/ticks are reused too (the gateway's cross-stream
   dedup); misses go through one `solve_batch` call.
2. **Order** the fleet with the chosen admission policy (pre-solved solo
   latencies feed the latency-greedy policy).
3. **Admit** in order through the shared :class:`AdmissionCore`: a request's
   snapshot plan is checked against the live residuals; if it no longer fits,
   capacity-aware **replanning** re-runs the solver against the materialized
   residual network (reduced link rates and node capacities) before the
   request is declared blocked.  Accepted plans are committed and their
   latency is evaluated on the residual fabric they were admitted onto, so
   per-request latencies reflect contention.

The solvers themselves are the paper's single-chain solvers — their
formulation has no link capacities, so every plan (snapshot or replanned) is
re-verified against the residuals before commit.
"""
from __future__ import annotations

import inspect
import time
from dataclasses import dataclass, field

import numpy as np

from ..core import (EvalCache, ModelProfile, PhysicalNetwork, Plan,
                        PlanEvaluator, SolveOutcome, get_solver, solve,
                        solve_batch)
from ..core.torch_solvers import resolve_device

from .admission import INF, AdmissionCore, ServedRequest
from .plancache import PlanCache
from .policies import POLICIES
from .requests import ServeRequest
from .residual import ResidualState

__all__ = ["INF", "ServedRequest", "ServeOutcome", "ServePlanner",
           "device_kwargs", "replay_verify"]


def device_kwargs(solver: str, solver_kwargs: dict | None = None,
                  device: str = "cuda") -> dict:
    """``solver_kwargs`` for ``solver``, with the device of a solver that
    takes one (``dfts_torch``, ``bcd_torch``) resolved: the one the kwargs
    name, else ``device``, the card by default.  Without a card a CUDA
    device raises (``resolve_device``); the serve stack never falls back to
    the CPU unless the caller asks for it.  Host solvers' kwargs pass
    unchanged."""
    kw = dict(solver_kwargs or {})
    if "device" in inspect.signature(get_solver(solver).fn).parameters:
        kw["device"] = resolve_device(kw.get("device", device))
    return kw


@dataclass
class ServeOutcome:
    """Result of one admission round, in admission order."""

    policy: str
    solver: str
    served: list[ServedRequest] = field(default_factory=list)
    wall_time_s: float = 0.0
    n_presolved: int = 0  # distinct request shapes actually solved in step 1
    # planning-engine cache counters of the round (EvalCache hits/misses,
    # PlanCache hits/misses/evictions when one is attached) — see
    # solver_stats(); empty when the driver recorded none.
    cache_stats: dict = field(default_factory=dict)

    @property
    def n_requests(self) -> int:
        return len(self.served)

    @property
    def n_accepted(self) -> int:
        return sum(s.accepted for s in self.served)

    @property
    def n_replanned(self) -> int:
        return sum(s.accepted and s.replanned for s in self.served)

    @property
    def acceptance_ratio(self) -> float:
        return self.n_accepted / self.n_requests if self.served else 0.0

    @property
    def status(self) -> str:
        """Aggregate engine status of the round: ``optimal`` when every
        accepted chain's winning solve (snapshot or replan) was optimal,
        ``feasible`` when at least one chain was admitted, ``infeasible``
        otherwise.  This is per-chain solver optimality — the admission
        *order* itself is a heuristic either way."""
        acc = [s.status for s in self.served if s.accepted]
        if not acc:
            return "infeasible"
        return "optimal" if all(st == "optimal" for st in acc) else "feasible"

    def solver_stats(self) -> dict:
        """Per-round solve bookkeeping for sweep artifacts (``solver_stats``
        column): distinct shapes pre-solved, replans, per-status counts, and
        the planning-engine cache counters."""
        counts: dict[str, int] = {}
        for s in self.served:
            if s.status is not None:
                counts[s.status] = counts.get(s.status, 0) + 1
        return {"n_presolved": self.n_presolved,
                "n_replanned": self.n_replanned,
                "statuses": counts,
                "cache": self.cache_stats}

    def accepted_latencies(self) -> list[float]:
        return [s.latency_s for s in self.served
                if s.accepted and s.latency_s is not None]

    def latency_percentiles(self, qs: tuple[float, ...] = (50, 95, 99)) -> dict:
        lats = self.accepted_latencies()
        if not lats:
            return {f"p{int(q)}": None for q in qs}
        arr = np.asarray(sorted(lats))
        return {f"p{int(q)}": float(np.percentile(arr, q)) for q in qs}

    def summary(self) -> dict:
        pct = self.latency_percentiles()
        lats = self.accepted_latencies()
        return {
            "policy": self.policy,
            "solver": self.solver,
            "status": self.status,
            "n_requests": self.n_requests,
            "n_accepted": self.n_accepted,
            "n_replanned": self.n_replanned,
            "acceptance_ratio": self.acceptance_ratio,
            "latency_mean_s": float(np.mean(lats)) if lats else None,
            "latency_p50_s": pct["p50"],
            "latency_p95_s": pct["p95"],
            "latency_p99_s": pct["p99"],
            "wall_time_s": self.wall_time_s,
            "n_presolved": self.n_presolved,
        }

    def mode_split(self) -> dict:
        """Per-mode (IF vs TR) admission breakdown of the round: how training
        and inference chains fared under shared-fabric contention
        (docs/training.md).  Keys are the modes present in the fleet; each
        carries the per-mode acceptance and latency percentiles the mixed
        training sweep reports on."""
        by_mode: dict[str, list[ServedRequest]] = {}
        for s in self.served:
            by_mode.setdefault(s.request.mode, []).append(s)
        out: dict[str, dict] = {}
        for m in sorted(by_mode):
            rows = by_mode[m]
            lats = sorted(s.latency_s for s in rows
                          if s.accepted and s.latency_s is not None)
            arr = np.asarray(lats) if lats else None
            n_acc = sum(s.accepted for s in rows)
            out[m] = {
                "n_requests": len(rows),
                "n_accepted": n_acc,
                "acceptance_ratio": n_acc / len(rows),
                "latency_mean_s": float(np.mean(arr)) if lats else None,
                **{f"latency_p{int(q)}_s":
                   (float(np.percentile(arr, q)) if lats else None)
                   for q in (50, 95, 99)},
            }
        return out


class ServePlanner:
    """Admits fleets of :class:`ServeRequest` onto one `PhysicalNetwork`.

    The default solver is ``bcd_torch`` on the card (bit-identical to the
    JAX package's default ``bcd``); ``solver_kwargs={"device": "cpu"}``
    runs it on the CPU (``device_kwargs``)."""

    def __init__(self, net: PhysicalNetwork, profile: ModelProfile,
                 solver: str = "bcd_torch", replan: bool = True,
                 cache: EvalCache | None = None,
                 plan_cache: PlanCache | None = None,
                 solver_kwargs: dict | None = None):
        # uniform unknown-solver error from the registry
        self.solver_kwargs = device_kwargs(solver, solver_kwargs)
        self.net = net
        self.profile = profile
        self.solver_name = solver
        self.replan = replan
        # snapshot cache: batch/mode are part of EvalCache keys, so one cache
        # serves the whole heterogeneous fleet against the base network
        self.cache = cache if cache is not None else EvalCache()
        # optional cross-round snapshot-outcome cache (the gateway's Layer 2):
        # keyed by ProblemInstance content hash, so recurring shapes skip the
        # solver entirely on later rounds/ticks
        self.plan_cache = plan_cache
        # request-shape tuple -> content hash.  The sha256-of-canonical-JSON
        # identity is ~50us per request; under a streaming gateway the same
        # few shapes recur for the whole run, so the hash is computed once
        # per shape instead of once per request.  The tuple is strictly finer
        # than the content identity (pipe with M=1 normalizes to seq in the
        # hash), which can only cost a duplicate hash, never alias two keys.
        self._key_memo: dict[tuple, str] = {}

    def _solve_key(self, r: ServeRequest) -> str:
        ident = (r.model_id, r.source, r.destination, r.batch_size, r.mode,
                 r.K, r.candidates, r.schedule, r.n_microbatches)
        key = self._key_memo.get(ident)
        if key is None:
            key = self._key_memo[ident] = r.solve_key(self.net, self.profile)
        return key

    def _solve(self, net: PhysicalNetwork, request: ServeRequest,
               cache: EvalCache | None) -> SolveOutcome:
        return solve(request.problem(net, self.profile), self.solver_name,
                     cache=cache, **self.solver_kwargs)

    def presolve(self, requests: list[ServeRequest]
                 ) -> tuple[dict[str, SolveOutcome], dict[int, str],
                            dict[int, float]]:
        """Solve each distinct request shape once on the snapshot network,
        deduped by ProblemInstance content hash (the engine-wide instance
        identity) and — when a :class:`PlanCache` is attached — by what
        earlier rounds already solved.  Returns (outcome by key, key by
        request id, solo-latency estimate by request id — the policies'
        ordering input)."""
        keys: dict[int, str] = {}
        seen: set[str] = set()
        order: list[str] = []  # first-seen key order (scalar-loop parity)
        problems: list = []
        presolved: dict[str, SolveOutcome] = {}
        for r in requests:
            key = keys[r.request_id] = self._solve_key(r)
            if key in seen:
                continue
            seen.add(key)
            if self.plan_cache is not None:
                hit = self.plan_cache.get(key)
                if hit is not None:
                    presolved[key] = hit
                    continue
            order.append(key)
            problems.append(r.problem(self.net, self.profile))
        outcomes = (solve_batch(problems, self.solver_name, cache=self.cache,
                                **self.solver_kwargs) if problems else [])
        presolved.update(zip(order, outcomes))
        if self.plan_cache is not None:
            for key, out in zip(order, outcomes):
                self.plan_cache.put(key, out)
        estimates = {r.request_id: presolved[keys[r.request_id]].latency_s
                     for r in requests}
        return presolved, keys, estimates

    def attempt(self, state: ResidualState, r: ServeRequest,
                snapshot: SolveOutcome,
                res_net_cache: dict | None = None
                ) -> tuple[Plan | None, bool, str | None, str]:
        """One admission attempt against the live residuals: try the
        snapshot plan, else replan on the materialized residual network.
        Returns ``(plan | None, replanned, status, reason)`` — the capacity
        half of :class:`AdmissionCore.try_admit`.

        ``res_net_cache`` (a per-mode dict) memoizes the materialized
        residual network across *consecutive failed* attempts — the caller
        must clear it whenever `state` changes (any commit/release), since a
        stale residual view would admit against freed/occupied capacity that
        no longer matches."""
        plan = snapshot.plan
        if plan is None:
            return None, False, snapshot.status, "no-plan"
        if state.fits(self.profile, r, plan):
            return plan, False, snapshot.status, ""
        if self.replan:
            # replan only capacity-blocked requests: if even the uncontended
            # snapshot had no feasible plan, the strictly tighter residual
            # network cannot have one either
            res_net = (res_net_cache.get(r.mode)
                       if res_net_cache is not None else None)
            if res_net is None:
                res_net = state.materialize(r.mode)
                if res_net_cache is not None:
                    res_net_cache[r.mode] = res_net
            res = self._solve(res_net, r, self.cache.fork_fits())
            if res.plan is not None and state.fits(self.profile, r, res.plan):
                return res.plan, True, res.status, ""
        return None, False, snapshot.status, "capacity"

    def planned_latency_s(self, state: ResidualState, r: ServeRequest,
                          plan: Plan) -> float:
        """The latency `plan` would see on the residual fabric as it stands —
        evaluated on the state's live keep-saturated view (saturated links
        clamped, not dropped: a zero-demand tail may legitimately cross
        them), *without* committing.  The SLO gate and the commit path both
        read this one number."""
        ev = PlanEvaluator(state.live_view(), self.profile,
                           r.chain_request(), cache=self.cache.fork_fits())
        return ev.latency_s(plan)

    def commit_latency_s(self, state: ResidualState, r: ServeRequest,
                         plan: Plan) -> float:
        """Commit an admitted plan and return its latency, evaluated on the
        residual fabric the request was admitted onto."""
        latency = self.planned_latency_s(state, r, plan)
        state.commit(self.profile, r, plan)
        return latency

    def round_cache_stats(self) -> dict:
        """The planning-engine cache counters a driver stamps on its outcome."""
        stats = {"eval_cache": self.cache.stats()}
        if self.plan_cache is not None:
            stats["plan_cache"] = self.plan_cache.stats()
        return stats

    def admit(self, requests: list[ServeRequest],
              policy: str = "fcfs") -> ServeOutcome:
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {sorted(POLICIES)}")
        t0 = time.perf_counter()

        # 1. pre-solve each distinct request shape on the snapshot, deduped by
        # ProblemInstance content hash (the engine-wide instance identity)
        presolved, keys, estimates = self.presolve(requests)

        # 2. policy order
        order = POLICIES[policy](requests, estimates)

        # 3. admission with residual accounting + capacity-aware replanning —
        # the static round is the simplest AdmissionCore driver: one pass, no
        # timestamps, no retries
        core = AdmissionCore(self, presolved, keys)
        for r in order:
            core.try_admit(r)
        assert core.conservation_ok()
        return ServeOutcome(policy=policy, solver=self.solver_name,
                            served=core.served,
                            wall_time_s=time.perf_counter() - t0,
                            n_presolved=len(presolved),
                            cache_stats=self.round_cache_stats())


def replay_verify(net: PhysicalNetwork, profile: ModelProfile,
                  served: list[ServedRequest]) -> bool:
    """Re-verify a (possibly reloaded) admission outcome from scratch: replay
    the accepted plans in admission order against a fresh ResidualState and
    confirm each fits as it is committed — i.e. accepted chains never
    oversubscribe a link or node — and that plans are structurally valid."""
    state = ResidualState(net)
    for s in served:
        if not s.accepted:
            continue
        assert s.plan is not None
        PlanEvaluator(net, profile, s.request.chain_request()).check(s.plan)
        if not state.fits(profile, s.request, s.plan):
            return False
        state.commit(profile, s.request, s.plan)
    return state.conservation_ok(profile)
