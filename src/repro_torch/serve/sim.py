"""ServeSim — deterministic event-driven serving under churn (docs/sim.md).

The static :meth:`ServePlanner.admit` round admits a fleet once and every
accepted chain holds its reservation forever.  Real serving is a *process*:
chains arrive, hold fabric capacity for a finite time, and leave — the
multi-cloud SFC setting (Bhamare et al.) and the companion SFC architecture
paper (Hara & Sasabe) both evaluate admission over time.  `ServeSim` replays
that process exactly:

* **events** — one arrival event per distinct arrival timestamp (simultaneous
  arrivals are ordered by the admission policy), one departure event per
  admitted chain with a finite ``duration_s``.  Events are processed in
  timestamp order; at equal timestamps departures are processed first, so
  capacity freed "now" is available to arrivals "now".
* **arrivals** run the same snapshot-fits / residual-replan / commit
  admission as the static round (the shared
  :class:`~repro_torch.serve.admission.AdmissionCore`), against the residual state
  *at that instant*.
* **departures** release the departing chain's exact :class:`PlanDemand`
  through :meth:`ResidualState.release` — bit-identical floats to the ones
  its commit added, so conservation holds at every event.
* an optional **retry queue** parks capacity-blocked requests and re-attempts
  them (in arrival order) whenever a departure frees room; requests still
  queued when the event stream drains are finally rejected.

* **failures** (docs/failures.md) — ``link_down`` / ``node_down`` /
  ``recover`` events interleave with the stream: same-instant failures are
  applied as one batch *after* that instant's departures and *before* its
  arrivals, victims are detected through the ResidualState reverse index,
  released, and migrated (or parked/killed) by
  :meth:`AdmissionCore.apply_failures`.

With every ``duration_s = inf`` there are no departures and the simulation
degenerates to the static admission round — bit-for-bit, which is the
anchoring invariant (`tests/test_sim.py`).  With no failure events the run is
bit-for-bit the PR 7 behaviour (`tests/test_failures.py`).

`replay_verify_sim` re-verifies a (possibly reloaded) trace from scratch:
plans re-checked structurally, every commit re-checked against the residuals
at its admission instant (a down resource has exactly zero capacity while
down), migration audit entries re-derived, and conservation re-checked after
*every* event.  :func:`replay_verify_sim_report` returns the first violation
as an actionable message instead of a bare bool.
"""
from __future__ import annotations

import heapq
import itertools
import time
from dataclasses import dataclass, field

import numpy as np

from ..core import ModelProfile, PhysicalNetwork, PlanEvaluator

from .admission import (INF, AdmissionCore, ServedRequest, _plan_from_dict)
from .failures import FailureEvent, MigrationCostModel, migration_delta
from .planner import ServeOutcome, ServePlanner
from .policies import POLICIES
from .requests import ServeRequest
from .residual import ResidualState

# Event priorities at equal timestamps: departures release capacity first,
# then failures hit the settled fabric, then arrivals (and retry/restore
# drains) contend for what is left.
_DEPART, _FAIL, _ARRIVE = 0, 1, 2


@dataclass
class SimOutcome(ServeOutcome):
    """One simulation run: the static round's fields plus the event trace.

    ``served`` is in *decision* order (the order admit/reject decisions were
    made); accepted records carry ``admit_s`` / ``depart_s`` / ``n_retries``,
    which is the full trace — `replay_verify_sim` needs nothing else.
    ``timeline`` is the per-event audit log (admit/depart/reject with the
    concurrent-chain count after each event), from which the time-series
    metrics derive.
    """

    retry: bool = False
    horizon_s: float = 0.0  # timestamp of the last processed event
    timeline: list = field(default_factory=list)

    # ------------------------------------------------------------ churn metrics
    @property
    def n_departed(self) -> int:
        return sum(1 for e in self.timeline if e["event"] == "depart")

    @property
    def n_retried(self) -> int:
        """Chains admitted only after >= 1 failed capacity attempt."""
        return sum(1 for s in self.served if s.accepted and s.n_retries > 0)

    @property
    def n_blocked(self) -> int:
        """Requests finally rejected for capacity (not infeasibility)."""
        return sum(1 for s in self.served
                   if not s.accepted and s.reason == "capacity")

    @property
    def blocking_probability(self) -> float:
        """Erlang-style blocking: capacity rejections over offered requests
        (``no-plan`` rejections are infeasible on an empty fabric too, so
        they are not *blocking* — they count in the denominator only)."""
        return self.n_blocked / self.n_requests if self.served else 0.0

    @property
    def peak_concurrent(self) -> int:
        return max((e["concurrent"] for e in self.timeline), default=0)

    def concurrent_curve(self) -> list[tuple[float, int]]:
        """(t, concurrently held chains) after every event."""
        return [(e["t"], e["concurrent"]) for e in self.timeline]

    def acceptance_curve(self) -> list[tuple[float, float]]:
        """(t, cumulative accepted / decided) after every admit/reject."""
        out, acc, dec = [], 0, 0
        for e in self.timeline:
            if e["event"] == "admit":
                acc, dec = acc + 1, dec + 1
            elif e["event"] == "reject":
                dec += 1
            else:
                continue
            out.append((e["t"], acc / dec))
        return out

    def epoch_percentiles(self, n_epochs: int = 4,
                          qs: tuple[float, ...] = (50, 95, 99)) -> list[dict]:
        """Latency percentiles of admitted chains, bucketed by admit-time
        epoch (the horizon split into `n_epochs` equal windows) — shows how
        contention moves the latency distribution over the run."""
        end = self.horizon_s
        width = end / n_epochs if end > 0 else 1.0

        def admit_time(s: ServedRequest) -> float:
            # explicit None check: admit_s == 0.0 is a legitimate admission
            # at t=0, not a missing timestamp (records imported from a static
            # round fall back to their arrival instant)
            return s.admit_s if s.admit_s is not None else s.request.arrival_s

        epochs = []
        for e in range(n_epochs):
            lo, hi = e * width, (e + 1) * width
            lats = [s.latency_s for s in self.served
                    if s.accepted and s.latency_s is not None
                    and lo <= admit_time(s)
                    and (admit_time(s) < hi or e == n_epochs - 1)]
            row = {"epoch": e, "start_s": lo, "end_s": hi, "n": len(lats)}
            for q in qs:
                row[f"p{int(q)}"] = (float(np.percentile(np.asarray(lats), q))
                                     if lats else None)
            epochs.append(row)
        return epochs

    # -------------------------------------------------------- failure metrics
    # Derived from the served records alone, so they work for any driver's
    # outcome (sim, gateway); all-zero on failure-free runs.
    @property
    def n_failed(self) -> int:
        """Disruption incidents: every time a failure took a chain down
        (counting each migration of a multiply-hit chain, plus kills)."""
        return self.n_restored + self.n_killed

    @property
    def n_restored(self) -> int:
        """Disruptions resolved by a successful migration."""
        return sum(len(s.migrations) for s in self.served if s.accepted)

    @property
    def n_killed(self) -> int:
        """Chains that ended down: released by a failure, never restored."""
        return sum(1 for s in self.served
                   if s.accepted and s.failed_s is not None)

    @property
    def restored_fraction(self) -> float | None:
        return self.n_restored / self.n_failed if self.n_failed else None

    def restore_latencies(self) -> list[float]:
        """Disruption seconds of every completed migration (outage +
        restage time, per the run's :class:`MigrationCostModel`)."""
        return [m["disruption_s"] for s in self.served if s.accepted
                for m in s.migrations]

    def restore_percentiles(self,
                            qs: tuple[float, ...] = (50, 95, 99)) -> dict:
        lats = self.restore_latencies()
        if not lats:
            return {f"p{int(q)}": None for q in qs}
        arr = np.asarray(sorted(lats))
        return {f"p{int(q)}": float(np.percentile(arr, q)) for q in qs}

    @property
    def moved_bytes(self) -> float:
        """Parameter + smashed bytes restaged by all migrations."""
        return sum(m["moved_bytes"] for s in self.served if s.accepted
                   for m in s.migrations)

    def failure_summary(self) -> dict:
        pct = self.restore_percentiles()
        return {
            "n_failed": self.n_failed,
            "n_restored": self.n_restored,
            "n_killed": self.n_killed,
            "restored_fraction": self.restored_fraction,
            "restore_p50_s": pct["p50"],
            "restore_p95_s": pct["p95"],
            "restore_p99_s": pct["p99"],
            "moved_bytes": self.moved_bytes,
            "moved_param_bytes": sum(
                m["moved_param_bytes"] for s in self.served if s.accepted
                for m in s.migrations),
            "moved_smashed_bytes": sum(
                m["moved_smashed_bytes"] for s in self.served if s.accepted
                for m in s.migrations),
        }

    def _has_failures(self) -> bool:
        return bool(self.n_failed or getattr(self, "failures", None))

    def sim_summary(self) -> dict:
        """The JSON-able churn block sweep artifacts store alongside the
        static summary fields (``ScenarioResult.sim``)."""
        s = {
            "retry": self.retry,
            "horizon_s": self.horizon_s,
            "n_departed": self.n_departed,
            "n_retried": self.n_retried,
            "n_blocked": self.n_blocked,
            "blocking_probability": self.blocking_probability,
            "peak_concurrent": self.peak_concurrent,
            "concurrent_curve": [[t, n] for t, n in self.concurrent_curve()],
            "acceptance_curve": [[t, a] for t, a in self.acceptance_curve()],
            "epochs": self.epoch_percentiles(),
        }
        # only on failure runs, so failure-free artifacts stay bit-identical
        if self._has_failures():
            s["failures"] = self.failure_summary()
        return s

    def summary(self) -> dict:
        s = super().summary()
        s.update({
            "retry": self.retry,
            "horizon_s": self.horizon_s,
            "n_departed": self.n_departed,
            "n_retried": self.n_retried,
            "blocking_probability": self.blocking_probability,
            "peak_concurrent": self.peak_concurrent,
        })
        if self._has_failures():
            s["failures"] = self.failure_summary()
        return s


@dataclass
class FailureOutcome(SimOutcome):
    """A simulation run with substrate failures: the sim trace plus the
    applied failure schedule (`ServeSim.run(..., failures=...)` returns this
    whenever a schedule — even an empty one — was supplied).  The
    survivability metrics live on :class:`SimOutcome` (they derive from the
    served records); the schedule rides along for replay verification."""

    failures: list = field(default_factory=list)  # FailureEvent, time order

    def sim_summary(self) -> dict:
        s = super().sim_summary()
        s.setdefault("failures", self.failure_summary())
        s["failure_events"] = [ev.to_dict() for ev in self.failures]
        return s


class ServeSim:
    """Event-driven dynamic admission on one fabric.

    Thin orchestration over the existing machinery: pre-solve + per-arrival
    admission delegate to a :class:`ServePlanner` (same solver registry,
    caches, and replan behaviour), capacity accounting to
    :class:`ResidualState` (`commit` on admit, `release` on departure).
    """

    def __init__(self, net: PhysicalNetwork, profile: ModelProfile,
                 solver: str = "bcd_torch", replan: bool = True,
                 retry: bool = False, cache=None,
                 solver_kwargs: dict | None = None,
                 cost_model: MigrationCostModel | None = None):
        self.planner = ServePlanner(net, profile, solver=solver, replan=replan,
                                    cache=cache, solver_kwargs=solver_kwargs)
        self.retry = retry
        self.cost_model = cost_model

    def run(self, requests: list[ServeRequest], policy: str = "fcfs",
            failures: list[FailureEvent] | None = None) -> SimOutcome:
        """Run the fleet through the event loop.  ``failures`` injects a
        substrate failure schedule (docs/failures.md) and switches the return
        type to :class:`FailureOutcome`; without it the run is bit-for-bit
        the failure-free simulator."""
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {sorted(POLICIES)}")
        t0 = time.perf_counter()
        planner = self.planner
        presolved, keys, estimates = planner.presolve(requests)

        # one arrival event per distinct timestamp; the admission policy
        # orders simultaneous arrivals (so a batch fleet reproduces the
        # static round's policy order exactly)
        batches: dict[float, list[ServeRequest]] = {}
        for r in requests:
            batches.setdefault(r.arrival_s, []).append(r)
        tick = itertools.count()  # deterministic heap tie-break
        heap: list[tuple] = [(t, _ARRIVE, next(tick), batch)
                             for t, batch in batches.items()]
        fail_events = sorted(failures or [], key=lambda e: e.t_s)
        heap += [(ev.t_s, _FAIL, next(tick), ev) for ev in fail_events]
        heapq.heapify(heap)

        core = AdmissionCore(planner, presolved, keys, retry=self.retry,
                             record_events=True, cost_model=self.cost_model)
        horizon = 0.0

        def push_depart(rec: ServedRequest) -> None:
            if rec.depart_s is not None:
                heapq.heappush(heap, (rec.depart_s, _DEPART, next(tick), rec))

        while heap:
            t, prio, _, payload = heapq.heappop(heap)
            horizon = max(horizon, t)
            if prio == _ARRIVE:
                for r in POLICIES[policy](payload, estimates):
                    rec = core.try_admit(r, t)
                    if rec is not None:
                        push_depart(rec)
                continue
            if prio == _DEPART:
                core.depart(payload, t)
            else:  # _FAIL: this instant's failures apply as one batch
                evs = [payload]
                while heap and heap[0][0] == t and heap[0][1] == _FAIL:
                    evs.append(heapq.heappop(heap)[3])
                core.apply_failures(evs, t)
            # once this instant's departures *and* failures have all
            # settled, re-attempt parked victims, then the retry queue (in
            # arrival order), against the freed/degraded residuals
            more_now = (heap and heap[0][0] == t and heap[0][1] != _ARRIVE)
            if not more_now:
                if core.fail_parked:
                    core.drain_failed(t)
                if self.retry and core.pending:
                    for rec in core.drain_pending(t):
                        push_depart(rec)

        # the event stream drained with these still queued: final rejections
        core.reject_pending(horizon)
        assert core.conservation_ok()
        kw = dict(
            policy=policy, solver=planner.solver_name, served=core.served,
            wall_time_s=time.perf_counter() - t0, n_presolved=len(presolved),
            cache_stats=planner.round_cache_stats(),
            retry=self.retry, horizon_s=horizon, timeline=core.timeline)
        if failures is None:
            return SimOutcome(**kw)
        return FailureOutcome(failures=fail_events, **kw)


# Replay priorities at equal timestamps, mirroring the simulator's causal
# order within one instant: departures release first, then failure marks
# flip capacity, then failure releases take victims down, then drain-phase
# commits (migrations, restores, retries), then first-try arrival commits.
_R_DEPART, _R_MARK, _R_RELEASE, _R_COMMIT, _R_FIRST = 0, 1, 2, 3, 4


def replay_verify_sim(net: PhysicalNetwork, profile: ModelProfile,
                      served: list[ServedRequest],
                      failures: list[FailureEvent] | None = None) -> bool:
    """Re-verify a (possibly reloaded) sim trace from scratch; see
    :func:`replay_verify_sim_report` for the checks (this is its bool
    form — the two never disagree)."""
    return replay_verify_sim_report(net, profile, served, failures) is None


def replay_verify_sim_report(net: PhysicalNetwork, profile: ModelProfile,
                             served: list[ServedRequest],
                             failures: list[FailureEvent] | None = None
                             ) -> str | None:
    """Re-verify a sim/gateway trace event-by-event; ``None`` if it holds,
    else an actionable description of the first violation.

    Rebuilds the event stream from the served records (commit at ``admit_s``,
    each migration entry as a release at ``t_down`` + recommit of the next
    plan at ``t_restored``, kills as final releases at ``failed_s``, release
    at ``depart_s``) interleaved with the failure schedule's capacity marks,
    and replays it against a fresh :class:`ResidualState`:

    * every plan is structurally re-checked against the base topology;
    * every commit must fit the residuals *at its instant* — including the
      exactly-zero capacity of any resource down at that instant;
    * every migration entry's moved bytes must re-derive from its old/new
      plans, and its disruption must cover the outage interval;
    * conservation (tallies, base capacities, and the resource->chains
      reverse index) must hold after every single event;
    * after each instant with failure marks, no committed chain may span a
      down resource (``ResidualState.down_ok``).
    """
    events: list[tuple[float, int, int, tuple]] = []
    for i, ev in enumerate(sorted(failures or [], key=lambda e: e.t_s)):
        events.append((ev.t_s, _R_MARK, i, ("mark", ev, None)))
    for seq, s in enumerate(served):
        if not s.accepted:
            continue
        rid = s.request.request_id
        if s.plan is None:
            return f"accepted record request_id={rid} has no plan"
        t = s.admit_s if s.admit_s is not None else s.request.arrival_s
        # the chain's plan timeline: plans[j] holds from its commit to the
        # j-th migration's release (the record's plan is the current one)
        try:
            plans = [_plan_from_dict(m["old_plan"]) for m in s.migrations]
        except (KeyError, TypeError):
            return (f"request_id={rid}: malformed migration entries "
                    f"(missing old_plan)")
        plans.append(s.plan)
        first = _R_COMMIT if s.n_retries > 0 else _R_FIRST
        events.append((t, first, seq, ("commit", s, plans[0])))
        prev_restored = t
        for j, m in enumerate(s.migrations):
            if m["t_down"] < prev_restored - _EPS_T or \
                    m["t_restored"] < m["t_down"] - _EPS_T:
                return (f"request_id={rid}: migration {j} timestamps out of "
                        f"order (down {m['t_down']}, restored "
                        f"{m['t_restored']})")
            prev_restored = m["t_restored"]
            want = migration_delta(profile, s.request, plans[j], plans[j + 1])
            got = m.get("moved_bytes")
            if got is None or abs(got - want["moved_bytes"]) > \
                    1e-6 * max(1.0, want["moved_bytes"]):
                return (f"request_id={rid}: migration {j} moved_bytes "
                        f"mismatch (recorded {got}, re-derived "
                        f"{want['moved_bytes']})")
            if m["disruption_s"] < (m["t_restored"] - m["t_down"]) - _EPS_T:
                return (f"request_id={rid}: migration {j} disruption_s "
                        f"{m['disruption_s']} shorter than its outage "
                        f"interval")
            events.append((m["t_down"], _R_RELEASE, seq,
                           ("release", s, plans[j])))
            events.append((m["t_restored"], _R_COMMIT, seq,
                           ("commit", s, plans[j + 1])))
        if s.failed_s is not None:  # killed: released by a failure, never back
            if s.failed_s < prev_restored - _EPS_T:
                return (f"request_id={rid}: failed_s {s.failed_s} precedes "
                        f"its last restoration at {prev_restored}")
            events.append((s.failed_s, _R_RELEASE, seq,
                           ("release", s, plans[-1])))
        elif s.depart_s is not None and s.depart_s != INF:
            events.append((s.depart_s, _R_DEPART, seq,
                           ("release", s, plans[-1])))
    events.sort(key=lambda e: (e[0], e[1], e[2]))
    state = ResidualState(net)
    i = 0
    while i < len(events):
        t = events[i][0]
        saw_mark = False
        while i < len(events) and events[i][0] == t:
            _, _, _, (kind, payload, plan) = events[i]
            i += 1
            if kind == "mark":
                saw_mark = True
                ev = payload
                if ev.kind == "recover":
                    if ev.node is not None:
                        state.recover_node(ev.node)
                    else:
                        state.recover_link(*ev.link)
                elif ev.kind == "node_down":
                    state.fail_node(ev.node)
                else:
                    state.fail_link(*ev.link)
                continue
            s = payload
            rid = s.request.request_id
            if kind == "commit":
                try:
                    PlanEvaluator(net, profile,
                                  s.request.chain_request()).check(plan)
                except (AssertionError, KeyError) as exc:
                    return (f"request_id={rid}: structurally invalid plan "
                            f"at t={t}: {exc}")
                if not state.footprint_clear(plan):
                    return (f"request_id={rid}: commit at t={t} touches a "
                            f"down resource (down_nodes="
                            f"{sorted(state.down_nodes)}, down_links="
                            f"{sorted(state.down_links)})")
                if not state.fits(profile, s.request, plan):
                    return (f"request_id={rid}: commit at t={t} exceeds "
                            f"residual capacity")
                state.commit(profile, s.request, plan)
            else:
                try:
                    state.release(profile, s.request, plan)
                except KeyError:
                    return (f"request_id={rid}: release at t={t} of a "
                            f"chain/plan that was never committed")
            if not state.conservation_ok(profile):
                return (f"conservation broken after {kind} of "
                        f"request_id={rid} at t={t}")
        if saw_mark and not state.down_ok():
            return (f"a committed chain still spans a down resource after "
                    f"the failure events at t={t}")
    return None


_EPS_T = 1e-9  # timestamp-ordering slack in the replay checks
