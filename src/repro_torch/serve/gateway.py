"""ServeGateway — the long-running admission control plane (Layer 3).

The static round plans a fleet once; the simulator replays a finite trace.
A *gateway* is the always-on object a serving deployment would actually run
(ROADMAP item 2): requests stream in via :meth:`submit`, admission happens in
**ticks** (:meth:`tick`), and :meth:`drain` closes the stream and returns the
full outcome.  One tick:

1. **releases** every committed chain whose ``depart_s`` is due, then (with
   ``retry``) re-attempts the retry queue against the freed residuals —
   mirroring the simulator's "drain all departures first" rule at tick
   granularity;
2. **presolves** the tick's arrival batch in one shot: content-hash lookups
   against the warm cross-stream :class:`~repro_torch.serve.plancache.PlanCache`,
   with the misses solved by a single ``solve_batch`` call (one batched device
   dispatch per tick, not N Python solves);
3. **admits** the batch in policy order through the shared
   :class:`~repro_torch.serve.admission.AdmissionCore` — the same
   snapshot-fits → residual-replan → commit machinery as the static round
   and the simulator, plus the gateway-only gates:

   * **backpressure** — :meth:`submit` rejects on a full bounded queue
     (reason ``"queue-full"``) before any planning happens;
   * **SLO** — an admissible plan whose contended latency exceeds
     ``slo_latency_s`` is rejected before commit (reason ``"slo"``).

Timestamps are *stream* time (request ``arrival_s``), supplied by the caller
per tick; per-tick wall-clock cost is measured separately into
:class:`GatewayStats`.  :meth:`run_stream` is the batch-window driver used by
the CLI / benchmark / sweep: it partitions a fleet's arrivals into windows of
``batch_window_s`` and submits+ticks each window.

Anchor invariant (docs/gateway.md, pinned in ``tests/test_gateway.py``): a
gateway fed an entire fleet in one tick with an unbounded queue, no SLO, and
a cold cache reproduces the static :meth:`ServePlanner.admit` round
bit-for-bit (same plans, latencies, statuses, decision order).
"""
from __future__ import annotations

import heapq
import itertools
import time
from dataclasses import dataclass, field

import numpy as np

from ..core import EvalCache, ModelProfile, PhysicalNetwork

from .admission import AdmissionCore, ServedRequest
from .failures import FailureEvent, MigrationCostModel
from .plancache import PlanCache
from .planner import ServePlanner
from .policies import POLICIES
from .requests import ServeRequest
from .sim import _DEPART, SimOutcome

_INF = float("inf")


@dataclass(frozen=True)
class GatewayConfig:
    """Control-plane knobs (the planning engine has its own, on the planner).

    ``batch_window_s`` — arrival-grouping window of :meth:`run_stream`
    (0 = one tick per distinct arrival timestamp, the simulator's
    granularity).  ``max_queue`` — bounded admission queue; `submit` rejects
    (``"queue-full"``) once this many requests await a tick.  ``slo_latency_s``
    — reject plans whose contended latency exceeds this before commit.
    ``retry`` — park capacity-blocked requests and re-attempt on departures.
    """

    batch_window_s: float = 0.0
    max_queue: int | None = None  # None = unbounded
    slo_latency_s: float | None = None  # None = no SLO gate
    retry: bool = False

    def __post_init__(self) -> None:
        if self.batch_window_s < 0:
            raise ValueError("batch_window_s must be >= 0")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError("max_queue must be >= 1 or None")
        if self.slo_latency_s is not None and self.slo_latency_s <= 0:
            raise ValueError("slo_latency_s must be > 0 or None")


@dataclass
class GatewayStats:
    """Per-tick observability: wall time, queue depth, cache hit rates."""

    ticks: list[dict] = field(default_factory=list)
    n_submitted: int = 0
    n_queue_rejected: int = 0  # backpressure rejections at submit()

    def record_tick(self, **row) -> None:
        self.ticks.append(row)

    @property
    def n_ticks(self) -> int:
        return len(self.ticks)

    def tick_wall_percentiles(self,
                              qs: tuple[float, ...] = (50, 95, 99)) -> dict:
        walls = [t["wall_s"] for t in self.ticks]
        if not walls:
            return {f"p{int(q)}": None for q in qs}
        arr = np.asarray(sorted(walls))
        return {f"p{int(q)}": float(np.percentile(arr, q)) for q in qs}

    def summary(self) -> dict:
        walls = [t["wall_s"] for t in self.ticks]
        admitted = sum(t["n_admitted"] for t in self.ticks)
        wall = sum(walls)
        return {
            "n_ticks": self.n_ticks,
            "n_submitted": self.n_submitted,
            "n_queue_rejected": self.n_queue_rejected,
            "tick_wall_total_s": wall,
            "tick_wall_mean_s": wall / self.n_ticks if self.ticks else None,
            "tick_wall_pct": self.tick_wall_percentiles(),
            "max_queue_depth": max((t["queue_depth"] for t in self.ticks),
                                   default=0),
            "admissions_per_s": admitted / wall if wall > 0 else None,
        }


@dataclass
class GatewayOutcome(SimOutcome):
    """A drained gateway stream: the sim trace fields + control-plane stats.

    ``served`` records carry the same admit/depart timestamps as a simulator
    trace, so ``replay_verify_sim`` re-verifies gateway traces unchanged
    (``"slo"`` / ``"queue-full"`` rejections never touched the fabric and are
    skipped by the replay like any other rejection).
    """

    gateway_stats: dict = field(default_factory=dict)
    failures: list = field(default_factory=list)  # injected FailureEvents

    @property
    def n_slo_rejected(self) -> int:
        return sum(1 for s in self.served
                   if not s.accepted and s.reason == "slo")

    @property
    def n_queue_rejected(self) -> int:
        return sum(1 for s in self.served
                   if not s.accepted and s.reason == "queue-full")

    def summary(self) -> dict:
        s = super().summary()
        s.update({
            "n_slo_rejected": self.n_slo_rejected,
            "n_queue_rejected": self.n_queue_rejected,
            "gateway": self.gateway_stats,
        })
        return s


class ServeGateway:
    """Always-on admission over one fabric: ``submit() / tick() / drain()``.

    Owns a :class:`ServePlanner` wired to a warm :class:`PlanCache` (Layer 2)
    and an :class:`AdmissionCore` (Layer 1) whose presolved maps grow
    incrementally as new shapes stream in.  See the module docstring for the
    tick anatomy and docs/gateway.md for the full contract.
    """

    def __init__(self, net: PhysicalNetwork, profile: ModelProfile,
                 solver: str = "bcd_torch", replan: bool = True,
                 policy: str = "fcfs",
                 config: GatewayConfig | None = None,
                 cache: EvalCache | None = None,
                 plan_cache: PlanCache | None = None,
                 solver_kwargs: dict | None = None,
                 cost_model: MigrationCostModel | None = None):
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {sorted(POLICIES)}")
        self.config = config if config is not None else GatewayConfig()
        self.policy = policy
        self.planner = ServePlanner(
            net, profile, solver=solver, replan=replan, cache=cache,
            plan_cache=plan_cache if plan_cache is not None else PlanCache(),
            solver_kwargs=solver_kwargs)
        self.core = AdmissionCore(
            self.planner, {}, {}, retry=self.config.retry,
            slo_latency_s=self.config.slo_latency_s, record_events=True,
            cost_model=cost_model)
        self.stats = GatewayStats()
        self.queue: list[ServeRequest] = []  # submitted, awaiting a tick
        self.estimates: dict[int, float] = {}  # solo latencies (policy input)
        self._departures: list[tuple] = []  # (depart_s, prio, seq, record)
        self._seq = itertools.count()  # deterministic heap tie-break
        self._failures: list[FailureEvent] = []  # injected, time-ordered
        self._fail_i = 0  # next failure event not yet applied
        self.now = 0.0  # stream time of the last tick
        self._t0 = time.perf_counter()
        self._drained = False

    def inject_failures(self, events: list[FailureEvent]) -> None:
        """Register a substrate failure schedule (docs/failures.md): events
        are applied in timestamp order as stream time advances past them —
        interleaved with due departures, failures after the departures of
        their instant.  Must be called before the events' timestamps pass."""
        if self._drained:
            raise RuntimeError("gateway already drained")
        self._failures = sorted(self._failures[self._fail_i:] + list(events),
                                key=lambda e: e.t_s)
        self._fail_i = 0

    # ----------------------------------------------------------- control plane
    def submit(self, requests: list[ServeRequest] | ServeRequest) -> int:
        """Enqueue requests for the next tick; returns how many were accepted
        into the queue.  With a bounded queue, overflow requests are rejected
        immediately (reason ``"queue-full"``) — backpressure costs no
        planning work and never touches the fabric."""
        if self._drained:
            raise RuntimeError("gateway already drained")
        if isinstance(requests, ServeRequest):
            requests = [requests]
        accepted = 0
        cap = self.config.max_queue
        for r in requests:
            self.stats.n_submitted += 1
            if cap is not None and len(self.queue) >= cap:
                self.stats.n_queue_rejected += 1
                self.core.served.append(ServedRequest(
                    r, False, reason="queue-full"))
                continue
            self.queue.append(r)
            accepted += 1
        return accepted

    def _release_due(self, now: float) -> int:
        """Advance substrate time to `now`: process every due departure and
        injected failure event in timestamp order (departures before the
        failures of their instant, same-instant failures as one batch), then
        re-attempt parked victims and the retry queue once against the
        settled residuals (the sim's drain-departures-first rule,
        tick-grained)."""
        released = 0
        changed = False
        while True:
            t_dep = self._departures[0][0] if self._departures else _INF
            t_fail = (self._failures[self._fail_i].t_s
                      if self._fail_i < len(self._failures) else _INF)
            t = min(t_dep, t_fail)
            if t > now:
                break
            if t_dep <= t_fail:
                _, _, _, rec = heapq.heappop(self._departures)
                if self.core.depart(rec, t_dep):
                    released += 1
            else:
                j = self._fail_i
                while (j < len(self._failures)
                       and self._failures[j].t_s == t_fail):
                    j += 1
                self.core.apply_failures(self._failures[self._fail_i:j],
                                         t_fail)
                self._fail_i = j
                changed = True
        if (released or changed) and self.config.retry:
            if self.core.fail_parked:
                self.core.drain_failed(now)  # keep scheduled departures
            if self.core.pending:  # kills free capacity too, not just departs
                for rec in self.core.drain_pending(now):
                    self._push_depart(rec)
        return released

    def _push_depart(self, rec: ServedRequest) -> None:
        if rec.depart_s is not None:
            heapq.heappush(self._departures,
                           (rec.depart_s, _DEPART, next(self._seq), rec))

    def tick(self, now: float | None = None) -> dict:
        """One admission tick at stream time `now` (default: the latest
        arrival in the queue).  Returns the tick's stats row."""
        if self._drained:
            raise RuntimeError("gateway already drained")
        wall0 = time.perf_counter()
        batch, self.queue = self.queue, []
        if now is None:
            now = max([self.now] + [r.arrival_s for r in batch])
        self.now = max(self.now, now)

        released = self._release_due(self.now)

        # Layer 2: one batched presolve for the tick's new shapes — PlanCache
        # hits skip the solver, misses share a single solve_batch dispatch.
        plan_cache = self.planner.plan_cache
        hits0, misses0 = plan_cache.hits, plan_cache.misses
        presolved, keys, estimates = self.planner.presolve(batch)
        self.core.presolved.update(presolved)
        self.core.keys.update(keys)
        self.estimates.update(estimates)

        n_admitted = n_rejected = 0
        for r in POLICIES[self.policy](batch, self.estimates):
            rec = self.core.try_admit(r, self.now)
            if rec is not None:
                self._push_depart(rec)
                n_admitted += 1
            elif r not in self.core.pending:
                n_rejected += 1

        row = {
            "tick": self.stats.n_ticks,
            "t": self.now,
            "wall_s": time.perf_counter() - wall0,
            "n_arrivals": len(batch),
            "n_released": released,
            "n_admitted": n_admitted,
            "n_rejected": n_rejected,
            "n_pending": len(self.core.pending),
            "queue_depth": len(self.queue),
            "concurrent": self.core.concurrent,
            "plan_cache_hits": plan_cache.hits - hits0,
            "plan_cache_misses": plan_cache.misses - misses0,
        }
        self.stats.record_tick(**row)
        return row

    def drain(self, horizon_s: float | None = None) -> GatewayOutcome:
        """Close the stream: tick any queued arrivals, release every chain
        departing by `horizon_s` (default: all of them), finally reject the
        still-pending retries, and return the full outcome."""
        if self._drained:
            raise RuntimeError("gateway already drained")
        if self.queue:
            self.tick()
        horizon = self.now
        while True:
            t_dep = self._departures[0][0] if self._departures else _INF
            t_fail = (self._failures[self._fail_i].t_s
                      if self._fail_i < len(self._failures) else _INF)
            t = min(t_dep, t_fail)
            if t == _INF or (horizon_s is not None and t > horizon_s):
                break
            horizon = max(horizon, t)
            # advance one instant at a time so retries see the same
            # all-departures-at-this-instant residuals as the simulator
            self._release_due(t)
        self.core.reject_pending(horizon)
        self._drained = True
        assert self.core.conservation_ok()
        stats = self.stats.summary()
        stats["plan_cache"] = self.planner.plan_cache.stats()
        stats["eval_cache"] = self.planner.cache.stats()
        return GatewayOutcome(
            policy=self.policy, solver=self.planner.solver_name,
            served=self.core.served,
            wall_time_s=time.perf_counter() - self._t0,
            n_presolved=len(self.core.presolved),
            cache_stats=self.planner.round_cache_stats(),
            retry=self.config.retry, horizon_s=horizon,
            timeline=self.core.timeline, gateway_stats=stats,
            failures=list(self._failures))

    # -------------------------------------------------------------- stream API
    def run_stream(self, requests: list[ServeRequest],
                   failures: list[FailureEvent] | None = None
                   ) -> GatewayOutcome:
        """Drive a whole fleet through the gateway: arrivals are grouped into
        ``batch_window_s`` windows (window start = first arrival in it), each
        window is submitted and ticked at its last arrival's timestamp, and
        the stream is drained at the end.  ``failures`` injects a substrate
        failure schedule applied as stream time passes each event."""
        if failures:
            self.inject_failures(failures)
        reqs = sorted(requests, key=lambda r: (r.arrival_s, r.request_id))
        i = 0
        while i < len(reqs):
            w_end = reqs[i].arrival_s + self.config.batch_window_s
            j = i
            while j < len(reqs) and reqs[j].arrival_s <= w_end:
                j += 1
            self.submit(reqs[i:j])
            self.tick(now=reqs[j - 1].arrival_s)
            i = j
        return self.drain()
