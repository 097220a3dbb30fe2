"""AdmissionCore — the one admission engine under every serve driver.

Layer 1 of the serve stack (docs/gateway.md): the snapshot-fits →
residual-replan → commit/release/retry state machine that used to live twice
(inline in :meth:`ServePlanner.admit` and again in :meth:`ServeSim.run`) is
one object here, and the three drivers are thin loops over it:

* the **static round** (`ServePlanner.admit`) feeds the whole policy-ordered
  fleet through :meth:`AdmissionCore.try_admit` with no timestamps;
* the **simulator** (`ServeSim.run`) walks its event heap, calling
  :meth:`try_admit` on arrivals, :meth:`release` on departures, and
  :meth:`drain_pending` after the departures of an instant have all drained;
* the **gateway** (`ServeGateway`) does the same per tick, with the extra
  control-plane knobs (bounded queues, SLO rejection) layered on top.

The core owns the mutable admission state — the :class:`ResidualState`, the
decision records, the retry queue and per-request retry counts, the event
timeline, and the residual-network memo shared across consecutive *failed*
attempts (any commit/release invalidates it).  All policy decisions (ordering,
when to tick, when to give up) stay in the drivers; all capacity decisions
live here, so the three drivers cannot drift apart.

``slo_latency_s`` is the gateway's SLO gate: when set, an otherwise-admissible
plan whose contended latency exceeds the budget is rejected *before* commit
(reason ``"slo"``) — the fabric is never touched, so the residual memo stays
valid.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..core import Plan, SolveOutcome, solve_batch

from .failures import (FailureEvent, MigrationCostModel, migration_delta,
                       standby_network)
from .requests import ServeRequest
from .residual import ResidualState

INF = float("inf")


def _plan_dict(plan: Plan) -> dict:
    return {"segments": [list(s) for s in plan.segments],
            "placement": list(plan.placement),
            "paths": [list(p) for p in plan.paths],
            "tail_path": list(plan.tail_path)}


def _plan_from_dict(d: dict) -> Plan:
    return Plan(segments=[tuple(s) for s in d["segments"]],
                placement=list(d["placement"]),
                paths=[list(p) for p in d["paths"]],
                tail_path=list(d["tail_path"]))


@dataclass
class ServedRequest:
    """Admission outcome of one request (in admission/decision order)."""

    request: ServeRequest
    accepted: bool
    replanned: bool = False
    latency_s: float | None = None
    plan: Plan | None = None
    reason: str = ""  # "" | "no-plan" | "capacity" | "slo" | "queue-full"
    status: str | None = None  # SolveOutcome.status of the winning solve
    # Event-driven fields (ServeSim / ServeGateway); None for static rounds.
    admit_s: float | None = None  # admission timestamp (>= arrival on retry)
    depart_s: float | None = None  # admit_s + duration_s when finite
    n_retries: int = 0  # failed capacity attempts before the final decision
    # Failure/migration fields (docs/failures.md).  ``plan`` always holds the
    # *current* plan; each completed migration appends an audit entry (old
    # plan, cause, timestamps, moved bytes, disruption seconds) here.
    migrations: list = field(default_factory=list)
    # set while the chain is down (released by a failure, not yet restored);
    # a record that ends with failed_s != None was killed by the failure
    failed_s: float | None = None
    # pre-planned disjoint backup for HA chains (promoted on failure)
    standby: Plan | None = None

    def to_dict(self) -> dict:
        r = self.request
        d = {
            "request_id": r.request_id,
            "source": r.source,
            "destination": r.destination,
            "batch_size": r.batch_size,
            "mode": r.mode,
            "K": r.K,
            "candidates": [list(c) for c in r.candidates],
            "arrival_s": r.arrival_s,
            "rate_rps": r.rate_rps,
            "model_id": r.model_id,
            "schedule": r.schedule,
            "n_microbatches": r.n_microbatches,
            # inf round-trips as null so the artifacts stay strict JSON
            "duration_s": None if r.duration_s == INF else r.duration_s,
            "ha": r.ha,
            "accepted": self.accepted,
            "replanned": self.replanned,
            "latency_s": self.latency_s,
            "reason": self.reason,
            "status": self.status,
            "admit_s": self.admit_s,
            "depart_s": self.depart_s,
            "n_retries": self.n_retries,
        }
        if self.plan is not None:
            d["segments"] = [list(s) for s in self.plan.segments]
            d["placement"] = list(self.plan.placement)
            d["paths"] = [list(p) for p in self.plan.paths]
            d["tail_path"] = list(self.plan.tail_path)
        if self.migrations:
            d["migrations"] = [dict(m) for m in self.migrations]
        if self.failed_s is not None:
            d["failed_s"] = self.failed_s
        if self.standby is not None:
            d["standby"] = _plan_dict(self.standby)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ServedRequest":
        duration = d.get("duration_s")
        req = ServeRequest(
            request_id=d["request_id"], source=d["source"],
            destination=d["destination"], batch_size=d["batch_size"],
            mode=d["mode"], K=d["K"],
            candidates=tuple(tuple(c) for c in d["candidates"]),
            arrival_s=d["arrival_s"], rate_rps=d["rate_rps"],
            model_id=d["model_id"], schedule=d.get("schedule", "seq"),
            n_microbatches=d.get("n_microbatches", 1),
            duration_s=INF if duration is None else duration,
            ha=d.get("ha", False))
        plan = None
        if "segments" in d:
            plan = _plan_from_dict(d)
        standby = d.get("standby")
        return cls(req, d["accepted"], d["replanned"], d["latency_s"], plan,
                   d.get("reason", ""), d.get("status"), d.get("admit_s"),
                   d.get("depart_s"), d.get("n_retries", 0),
                   migrations=[dict(m) for m in d.get("migrations", [])],
                   failed_s=d.get("failed_s"),
                   standby=_plan_from_dict(standby) if standby else None)


class AdmissionCore:
    """The shared admission state machine (see module docstring).

    ``presolved`` / ``keys`` are the planner's snapshot-solve maps; the
    gateway grows them incrementally (``presolved.update(...)``) as new
    shapes stream in.  ``record_events`` turns on the timeline audit log —
    events carry the timestamp the driver passes to each call, so the static
    round (no timestamps) leaves the timeline empty.
    """

    def __init__(self, planner, presolved: dict[str, SolveOutcome],
                 keys: dict[int, str], *, retry: bool = False,
                 slo_latency_s: float | None = None,
                 record_events: bool = False,
                 cost_model: MigrationCostModel | None = None):
        self.planner = planner
        self.presolved = presolved
        self.keys = keys
        self.retry = retry
        self.slo_latency_s = slo_latency_s
        self.record_events = record_events
        self.cost_model = (cost_model if cost_model is not None
                           else MigrationCostModel())

        self.state = ResidualState(planner.net)
        self.served: list[ServedRequest] = []
        self.timeline: list[dict] = []
        self.pending: list[ServeRequest] = []  # capacity-blocked, awaiting retry
        self.retries: dict[int, int] = {}
        self.concurrent = 0
        # request_id -> live accepted record: what a failure event's victim
        # ids (from the ResidualState reverse index) resolve to
        self.live: dict[int, ServedRequest] = {}
        # victims taken down by a failure, awaiting restoration (retry mode);
        # restoration is attempted on departures/recoveries, in park order
        self.fail_parked: list[ServedRequest] = []
        # request_id -> resource name of the failure that took it down (the
        # `cause` stamped on the migration entry if restored later)
        self._down_cause: dict[int, str] = {}
        # Residual-network memo for planner.attempt, shared across the
        # *failed* attempts between two state changes (the state is unchanged
        # between them); any commit or release invalidates it.
        self.res_memo: dict = {}

    def snapshot_for(self, r: ServeRequest) -> SolveOutcome:
        return self.presolved[self.keys[r.request_id]]

    def _event(self, event: str, request_id: int, t: float | None) -> None:
        if self.record_events and t is not None:
            self.timeline.append({"t": t, "event": event,
                                  "request_id": request_id,
                                  "concurrent": self.concurrent})

    def try_admit(self, r: ServeRequest,
                  t: float | None = None) -> ServedRequest | None:
        """One admission attempt (at instant `t` when event-driven); commits
        on success and returns the accepted record — the driver schedules the
        departure from its ``depart_s``.  Returns None when the request was
        rejected-and-recorded or parked on the retry queue."""
        snapshot = self.snapshot_for(r)
        chosen, replanned, status, reason = self.planner.attempt(
            self.state, r, snapshot, res_net_cache=self.res_memo)
        if chosen is not None and self.slo_latency_s is not None:
            latency = self.planner.planned_latency_s(self.state, r, chosen)
            if latency > self.slo_latency_s:
                # nothing was committed: the residual memo stays valid
                self.served.append(ServedRequest(
                    r, False, replanned=replanned, latency_s=latency,
                    plan=chosen, reason="slo", status=status,
                    n_retries=self.retries.get(r.request_id, 0)))
                self._event("reject", r.request_id, t)
                return None
        if chosen is None:
            if reason == "capacity" and self.retry:
                self.retries[r.request_id] = \
                    self.retries.get(r.request_id, 0) + 1
                if r not in self.pending:
                    self.pending.append(r)
            else:
                self.served.append(ServedRequest(
                    r, False, plan=snapshot.plan, reason=reason,
                    status=status, n_retries=self.retries.get(r.request_id, 0)))
                self._event("reject", r.request_id, t)
            return None
        latency = self.planner.commit_latency_s(self.state, r, chosen)
        self.res_memo.clear()  # the residual state just changed
        depart = None
        if t is not None and r.duration_s != INF:
            depart = t + r.duration_s
        rec = ServedRequest(
            r, True, replanned=replanned, latency_s=latency, plan=chosen,
            status=status, admit_s=t, depart_s=depart,
            n_retries=self.retries.get(r.request_id, 0))
        if r.ha:
            rec.standby = self._plan_standby(r, chosen)
        self.served.append(rec)
        self.live[r.request_id] = rec
        self.concurrent += 1
        self._event("admit", r.request_id, t)
        return rec

    def release(self, rec: ServedRequest, t: float | None = None) -> None:
        """A departing chain returns its exact demand to the fabric."""
        self.state.release(self.planner.profile, rec.request, rec.plan)
        self.res_memo.clear()  # the residual state just changed
        self.live.pop(rec.request.request_id, None)
        self.concurrent -= 1
        self._event("depart", rec.request.request_id, t)

    def depart(self, rec: ServedRequest, t: float | None = None) -> bool:
        """Departure-event entry point, failure-aware: a chain killed (or
        still parked) by a failure holds no reservation, so its scheduled
        departure only finalizes the record.  Returns whether a release
        actually happened."""
        if rec.request.request_id not in self.live or rec.failed_s is not None:
            # down when its service window ended: stays killed
            try:
                self.fail_parked.remove(rec)
            except ValueError:
                pass
            return False
        self.release(rec, t)
        return True

    # --------------------------------------------------------------- failures
    def apply_failure(self, ev: FailureEvent,
                      t: float | None = None) -> list[ServedRequest]:
        """Single-event convenience wrapper over :meth:`apply_failures`."""
        return self.apply_failures([ev], t)

    def apply_failures(self, events: list[FailureEvent],
                       t: float | None = None) -> list[ServedRequest]:
        """Apply one *instant's* substrate events at `t` (docs/failures.md).

        All marks land first, in schedule order — ``recover`` restores a
        resource's capacity, a down event zeroes it — so same-instant
        failures are simultaneous: no victim is migrated onto a resource
        that dies in the same instant.  Victims (found through the
        ResidualState reverse index, deduped in first-event order) are then
        *all* released — the survivors' residual network is fully settled
        before any replanning — then their shapes are batch-presolved once
        against the degraded residuals via ``solve_batch`` and each victim
        is recommitted: standby promotion first (HA), then the batch seed,
        then a fresh capacity-aware attempt; a victim with no feasible new
        plan is parked for retry (``retry=True``) or killed.  Parked victims
        are re-attempted by :meth:`drain_failed` whenever capacity returns.
        Returns the victim records."""
        t_at = t if t is not None else 0.0
        causes: dict[int, str] = {}  # rid -> first failure that hit it
        for ev in events:
            if ev.kind == "recover":
                if ev.node is not None:
                    self.state.recover_node(ev.node)
                else:
                    self.state.recover_link(*ev.link)
                self._event("recover", -1, t)
                continue
            if ev.kind == "node_down":
                victim_ids = self.state.fail_node(ev.node)
            else:
                victim_ids = self.state.fail_link(*ev.link)
            self._event(ev.kind, -1, t)
            for rid in victim_ids:
                causes.setdefault(rid, ev.resource)
        self.res_memo.clear()
        victims = [self.live[rid] for rid in causes]
        for rec in victims:  # take every victim down before replanning any
            rid = rec.request.request_id
            self.state.release(self.planner.profile, rec.request, rec.plan)
            del self.live[rid]
            self.concurrent -= 1
            rec.failed_s = t_at
            self._down_cause[rid] = causes[rid]
            self._event("disrupt", rid, t)
        if victims:
            self.res_memo.clear()
            seeds = self._presolve_degraded(victims)
            for rec in victims:  # recommit in take-down order
                rid = rec.request.request_id
                plan, via = self._replacement_plan(rec, seed=seeds.get(rid))
                if plan is not None:
                    self._restore(rec, plan, t, cause=causes[rid], via=via)
                elif self.retry:
                    self.fail_parked.append(rec)
        return victims

    def _presolve_degraded(self, victims: list[ServedRequest]
                           ) -> dict[int, Plan | None]:
        """One ``solve_batch`` dispatch per mode over the degraded residual
        network for all victims of an event — the migration counterpart of
        the admission presolve."""
        by_mode: dict[str, list[ServedRequest]] = {}
        for rec in victims:
            by_mode.setdefault(rec.request.mode, []).append(rec)
        seeds: dict[int, Plan | None] = {}
        planner = self.planner
        for mode, recs in by_mode.items():
            net = self.state.materialize(mode)
            problems = [rec.request.problem(net, planner.profile)
                        for rec in recs]
            outs = solve_batch(problems, planner.solver_name,
                               cache=planner.cache.fork_fits(),
                               **planner.solver_kwargs)
            for rec, out in zip(recs, outs):
                seeds[rec.request.request_id] = out.plan
        return seeds

    def _replacement_plan(self, rec: ServedRequest,
                          seed: Plan | None = None
                          ) -> tuple[Plan | None, str]:
        """A new plan for a downed chain against the *current* residuals:
        standby promotion, the event's batch-presolve seed, then a fresh
        snapshot/replan attempt."""
        r = rec.request
        profile = self.planner.profile
        if rec.standby is not None and self.state.fits(profile, r,
                                                       rec.standby):
            return rec.standby, "standby"
        if seed is not None and self.state.fits(profile, r, seed):
            return seed, "replan"
        plan, _, _, _ = self.planner.attempt(self.state, r,
                                             self.snapshot_for(r),
                                             res_net_cache=self.res_memo)
        return plan, "replan"

    def _restore(self, rec: ServedRequest, plan: Plan, t: float | None,
                 cause: str | None = None, via: str = "replan") -> None:
        """Recommit a downed chain on `plan`, appending the migration audit
        entry (old plan, moved bytes, disruption seconds)."""
        r = rec.request
        t_at = t if t is not None else 0.0
        old_plan = rec.plan
        delta = migration_delta(self.planner.profile, r, old_plan, plan)
        if cause is None:
            cause = self._down_cause.get(r.request_id, "")
        self._down_cause.pop(r.request_id, None)
        rec.migrations.append({
            "t_down": rec.failed_s, "t_restored": t_at,
            "cause": cause, "via": via, "old_plan": _plan_dict(old_plan),
            "disruption_s": ((t_at - rec.failed_s)
                             + self.cost_model.restage_s(
                                 delta["moved_bytes"])),
            **delta,
        })
        rec.latency_s = self.planner.commit_latency_s(self.state, r, plan)
        rec.plan = plan
        rec.failed_s = None
        self.res_memo.clear()
        self.live[r.request_id] = rec
        self.concurrent += 1
        self._event("migrate", r.request_id, t)

    def _plan_standby(self, r: ServeRequest, primary: Plan) -> Plan | None:
        """HA standby preplanning at admit time: solve the chain once more on
        the disjoint fabric (primary hosts/links blocked) so a single failure
        can never take both plans down.  The backup is *not* committed — it
        reserves nothing until promoted."""
        net = standby_network(self.planner.net, r, primary)
        out = self.planner._solve(net, r, self.planner.cache.fork_fits())
        return out.plan

    def drain_failed(self, t: float | None = None) -> list[ServedRequest]:
        """Re-attempt parked victims (in park order) against the current
        residuals — called by the drivers whenever capacity returns (a
        departure or a recovery).  A victim whose service window already
        ended while down stays killed.  Restored chains keep their original
        departure schedule."""
        restored, still = [], []
        for rec in self.fail_parked:
            if (t is not None and rec.depart_s is not None
                    and rec.depart_s <= t):
                continue  # expired while down: killed
            plan, via = self._replacement_plan(rec)
            if plan is None:
                still.append(rec)
                continue
            self._restore(rec, plan, t, via=via)
            restored.append(rec)
        self.fail_parked = still
        return restored

    def drain_pending(self, t: float | None = None) -> list[ServedRequest]:
        """Re-attempt the retry queue in arrival order against the current
        residuals; returns the newly admitted records (the driver schedules
        their departures)."""
        admitted = []
        for r in sorted(self.pending, key=lambda r: (r.arrival_s,
                                                     r.request_id)):
            rec = self.try_admit(r, t)
            if rec is not None:
                self.pending.remove(r)
                admitted.append(rec)
        return admitted

    def reject_pending(self, t: float | None = None) -> None:
        """Final rejections: the event stream drained with these still queued."""
        for r in sorted(self.pending, key=lambda r: (r.arrival_s,
                                                     r.request_id)):
            snapshot = self.snapshot_for(r)
            self.served.append(ServedRequest(
                r, False, plan=snapshot.plan, reason="capacity",
                status=snapshot.status,
                n_retries=self.retries.get(r.request_id, 0)))
            self._event("reject", r.request_id, t)
        self.pending.clear()

    def conservation_ok(self) -> bool:
        return self.state.conservation_ok(self.planner.profile)
