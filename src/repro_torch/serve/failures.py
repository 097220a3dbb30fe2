"""Failure events, migration costs, and HA standby planning (docs/failures.md).

The paper's planner assumes a static substrate; a production MSL/MSI fabric
loses links and nodes while chains are in flight (Bhamare et al. fold exactly
this resource loss into the multi-cloud SFC problem).  This module holds the
*data* side of the failure engine:

* :class:`FailureEvent` — ``link_down`` / ``node_down`` / ``recover`` at a
  stream timestamp, the event kind ServeSim and the gateway interleave with
  arrivals and departures (departures < failures < arrivals at equal
  timestamps, so capacity freed "now" is re-checked against the degraded
  fabric "now");
* :class:`MigrationCostModel` + :func:`migration_delta` — what a migration
  *costs*: the parameter and smashed-data bytes that must move to the
  segments' new hosts, converted into restage seconds;
* :func:`standby_network` — the solve fabric for HA standby preplanning: the
  primary plan's intermediate hosts stripped of capacity and its links
  removed, so the backup solved on it is placement- and path-disjoint
  (Neutron's active/standby L3 HA routing state is the precedent);
* :func:`generate_failures` — deterministic seeded Poisson failure schedules
  for sweeps, with exponential downtimes and protected endpoints.

The *mechanism* — victim detection via the :class:`ResidualState` reverse
index, release → batched degraded-presolve → recommit/park — lives in
:meth:`AdmissionCore.apply_failure`.
"""
from __future__ import annotations

import random
from dataclasses import dataclass

from ..core import (LinkSpec, ModelProfile, NodeSpec, PhysicalNetwork,
                        Plan)

from .requests import ServeRequest
from .residual import plan_footprint

FAILURE_KINDS = ("link_down", "node_down", "recover")


@dataclass(frozen=True)
class FailureEvent:
    """One substrate event: a link or node going down, or recovering.

    Exactly one of ``node`` / ``link`` is set.  Link failures are undirected
    (both directions lose capacity); a node failure takes every incident link
    with it.  A ``recover`` names the resource it restores.
    """

    t_s: float
    kind: str  # link_down | node_down | recover
    node: str | None = None
    link: tuple[str, str] | None = None

    def __post_init__(self) -> None:
        if self.kind not in FAILURE_KINDS:
            raise ValueError(f"kind must be one of {FAILURE_KINDS}, "
                             f"got {self.kind!r}")
        if (self.node is None) == (self.link is None):
            raise ValueError("exactly one of node/link must be set")
        if self.link is not None:
            object.__setattr__(self, "link", tuple(self.link))

    @property
    def resource(self) -> str:
        """Human-readable resource name (used in causes and reports)."""
        if self.node is not None:
            return f"node:{self.node}"
        return f"link:{self.link[0]}-{self.link[1]}"

    def to_dict(self) -> dict:
        return {"t_s": self.t_s, "kind": self.kind, "node": self.node,
                "link": list(self.link) if self.link else None}

    @classmethod
    def from_dict(cls, d: dict) -> "FailureEvent":
        link = d.get("link")
        return cls(d["t_s"], d["kind"], node=d.get("node"),
                   link=tuple(link) if link else None)


@dataclass(frozen=True)
class MigrationCostModel:
    """How long restaging a migrated chain takes beyond the outage itself.

    ``reload_bps`` — sustained rate at which moved parameter/smashed bytes
    are restaged onto the new hosts (paper Table II's disk/NIC order of
    magnitude: 1 Gbit/s default).  ``restart_s`` — fixed per-migration
    restart overhead (process spawn, re-jit, checkpoint open).  A migration's
    disruption is ``(t_restored - t_down) + restart_s + moved_bytes * 8 /
    reload_bps``.
    """

    reload_bps: float = 1e9
    restart_s: float = 0.0

    def __post_init__(self) -> None:
        if self.reload_bps <= 0:
            raise ValueError("reload_bps must be > 0")
        if self.restart_s < 0:
            raise ValueError("restart_s must be >= 0")

    def restage_s(self, moved_bytes: float) -> float:
        return self.restart_s + moved_bytes * 8.0 / self.reload_bps


def migration_delta(profile: ModelProfile, request: ServeRequest,
                    old_plan: Plan, new_plan: Plan) -> dict:
    """The bytes a migration actually moves: for every (segment, node)
    assignment of the new plan that the old plan did not already have, the
    segment's parameters plus its batch-scaled peak smashed data must be
    shipped to the new host.  Assignments the plans share are already staged
    and move nothing."""
    old = set(zip(old_plan.segments, old_plan.placement))
    param = smashed = 0.0
    for seg, node in zip(new_plan.segments, new_plan.placement):
        if (tuple(seg), node) in old or (seg, node) in old:
            continue
        lo, hi = seg
        param += profile.seg_mem_bytes(lo, hi)
        smashed += request.batch_size * profile.seg_peak_smashed(
            lo, hi, request.mode)
    return {"moved_param_bytes": param, "moved_smashed_bytes": smashed,
            "moved_bytes": param + smashed}


def standby_network(base: PhysicalNetwork, request: ServeRequest,
                    primary: Plan) -> PhysicalNetwork:
    """The fabric a disjoint standby plan is solved on: the primary's
    intermediate placement nodes keep routability but lose all hosting
    capacity, and every directed link of the primary's subpaths is removed —
    so any feasible solve yields a backup sharing no intermediate host and
    no link with the active plan (single link/node failures can never take
    both down at once).  Source and destination are pinned by the chain
    itself and stay usable."""
    links, _ = plan_footprint(primary)
    blocked = (set(primary.placement)
               - {request.source, request.destination})
    out = PhysicalNetwork()
    for name, spec in base.nodes.items():
        if name in blocked:
            out.add_node(NodeSpec(name, spec.compute, 0.0, 0.0))
        else:
            out.add_node(NodeSpec(name, spec.compute, spec.mem_capacity,
                                  spec.disk_capacity))
    for (u, v), spec in base.links.items():
        if (u, v) in links or (v, u) in links:
            continue
        if u in blocked or v in blocked:
            continue  # transit through a blocked host is not disjoint either
        out.add_link(u, v, LinkSpec(spec.bw_fw, spec.bw_bw,
                                    spec.delay_fw, spec.delay_bw))
    return out


def generate_failures(net: PhysicalNetwork, *, rate_per_s: float,
                      horizon_s: float, seed: int = 0,
                      mean_downtime_s: float | None = None,
                      protect: tuple[str, ...] = (),
                      node_fraction: float = 0.3) -> list[FailureEvent]:
    """Deterministic seeded failure schedule: Poisson(rate_per_s) events over
    ``[0, horizon_s)``, each hitting a uniformly chosen link (or, with
    probability ``node_fraction``, a node outside ``protect`` — sources and
    destinations are typically protected so chains stay definable).  With
    ``mean_downtime_s`` every failure is paired with an Exponential-delayed
    ``recover``; without it failures are permanent.  A resource already down
    at the draw is skipped (no nested outages), keeping the schedule's
    semantics identical under set-based down-state replay."""
    if rate_per_s <= 0 or horizon_s <= 0:
        return []
    rng = random.Random(seed * 60013 + 7)
    links = sorted({tuple(sorted((u, v))) for (u, v) in net.links})
    nodes = [n for n in sorted(net.nodes) if n not in protect]
    if not links and not nodes:
        return []
    events: list[FailureEvent] = []
    down_until: dict[tuple, float] = {}
    t = 0.0
    while True:
        t += rng.expovariate(rate_per_s)
        if t >= horizon_s:
            break
        # both draws always happen so the stream is choice-independent
        hit_node = (rng.random() < node_fraction and nodes) or not links
        idx = rng.randrange(len(nodes) if hit_node else len(links))
        if hit_node:
            key: tuple = ("node", nodes[idx])
            ev = FailureEvent(t, "node_down", node=nodes[idx])
        else:
            key = ("link",) + links[idx]
            ev = FailureEvent(t, "link_down", link=links[idx])
        up_at = down_until.get(key)
        if up_at is None or (up_at != float("inf") and up_at <= t):
            events.append(ev)
            if mean_downtime_s is not None:
                dt = rng.expovariate(1.0 / mean_downtime_s)
                down_until[key] = t + dt
                events.append(FailureEvent(t + dt, "recover", node=ev.node,
                                           link=ev.link))
            else:
                down_until[key] = float("inf")
    events.sort(key=lambda e: e.t_s)  # recovers interleave with later failures
    return events
