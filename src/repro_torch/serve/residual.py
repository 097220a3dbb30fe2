"""Residual-capacity accounting for concurrent service chains.

Accepted chains consume fabric capacity:

* **link bandwidth** — a chain executing ``rate_rps`` times per second ships
  ``b * delta_cut`` bytes per execution across every link of the cut's
  subpath, i.e. a sustained flow of ``b * delta * 8 * rate`` bits/s, charged
  against the link's forward rate (and its backward rate for the gradient
  flow when training, per the paper's R^BW_{i,j} convention).  *Pipelined*
  chains reserve their **steady-state occupancy** instead: a full pipeline
  streams one batch per bottleneck-stage period tau, so it can never ship
  faster than ``b * delta * 8 / tau`` bits/s — the effective reserved rate is
  ``min(rate_rps, 1/tau)``, which admits heavily-loaded pipelined chains where
  the naive accounting would reserve an unattainable flow (docs/pipeline.md);
* **node memory / disk** — a placed sub-model [lo, hi] holds its parameters
  plus the batch-scaled peak smashed data in memory (exactly the left side of
  constraints (14)-(15)) for as long as the chain is admitted.

:class:`ResidualState` tracks the running usage, answers "does this plan
still fit?", and materializes the *residual network* — the same topology with
capacities reduced by current usage — that capacity-aware replanning solves
against.  The paper's solvers know nothing about link capacities (their
formulation has none), so a replanned chain is always re-checked against the
residuals before being committed.
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

from ..core import (BW, FW, TR, EvalCache, LinkSpec, ModelProfile,
                        NodeSpec, PhysicalNetwork, Plan, PlanEvaluator,
                        round_trip_bottleneck_s)

from .requests import ServeRequest

# Absolute + relative slack for capacity comparisons (float sums of demands).
_EPS_ABS = 1e-9
_EPS_REL = 1e-12

# Floor (bits/s) a kept residual link is clamped to in the direction a mode
# does not reserve — keeps edge costs finite without admitting real flow.
_MIN_RATE_BPS = 1e-3


def _fits_cap(used: float, cap: float) -> bool:
    return used <= cap + _EPS_ABS + _EPS_REL * abs(cap)


def plan_footprint(plan: Plan) -> tuple[set[tuple[str, str]], set[str]]:
    """Every resource a committed plan depends on: the directed links of all
    its subpaths (including the zero-demand tail) and the nodes it places
    sub-models on *or* routes through.  This is the failure-domain of the
    plan — losing any of these kills the chain — which is deliberately wider
    than its :class:`PlanDemand` (a tail subpath reserves no bandwidth but
    still dies with its links)."""
    links: set[tuple[str, str]] = set()
    nodes: set[str] = set(plan.placement)
    for path in list(plan.paths) + [plan.tail_path]:
        nodes.update(path)
        links.update(zip(path, path[1:]))
    return links, nodes


@dataclass(frozen=True)
class PlanDemand:
    """The capacity footprint of one accepted chain."""

    link_fw_bps: dict[tuple[str, str], float]
    link_bw_bps: dict[tuple[str, str], float]
    node_mem_bytes: dict[str, float]
    node_disk_bytes: dict[str, float]


def effective_rate_rps(profile: ModelProfile, request: ServeRequest,
                       plan: Plan, net: PhysicalNetwork,
                       cache: EvalCache | None = None) -> float:
    """The execution rate a chain's bandwidth reservation is based on.

    Sequential chains reserve the requested sustained rate.  A pipelined chain
    (M > 1) streams microbatches through its bottleneck stage tau, completing
    at most one batch per tau seconds regardless of M, so its steady-state
    link occupancy corresponds to ``min(rate_rps, 1/tau)`` — reserving more
    would hold bandwidth the chain can physically never use.  A pipelined
    *training* chain's steady-state period is the round-trip
    ``tau_fw + tau_bw`` (the bottleneck stage runs one forward and one
    backward pass per microbatch — docs/training.md), so its clamp is
    ``min(rate_rps, 1/(tau_fw + tau_bw))``.  tau is computed against the
    *base* fabric's compute/link models so the reservation is stable across
    residual views."""
    chain = request.chain_request()
    if chain.microbatches() <= 1:
        return request.rate_rps
    ev = PlanEvaluator(net, profile, chain, cache=cache)
    tau = (round_trip_bottleneck_s(ev, plan) if chain.mode == TR
           else ev.bottleneck_s(plan))
    if tau <= 0.0:
        return request.rate_rps
    return min(request.rate_rps, 1.0 / tau)


def plan_demand(profile: ModelProfile, request: ServeRequest,
                plan: Plan, net: PhysicalNetwork | None = None,
                cache: EvalCache | None = None) -> PlanDemand:
    """Per-link flow (bits/s) and per-node memory/disk (bytes) of a plan.

    ``net`` enables the pipelined steady-state occupancy rate
    (:func:`effective_rate_rps`); without it the requested rate is reserved
    (the sequential behaviour).  ``cache`` collapses the repeated
    segment-compute lookups behind the bottleneck computation across the many
    fits/commit/conservation calls of an admission round."""
    b = request.batch_size
    training = request.mode == TR
    rate = (effective_rate_rps(profile, request, plan, net, cache)
            if net is not None else request.rate_rps)
    link_fw: dict[tuple[str, str], float] = defaultdict(float)
    link_bw: dict[tuple[str, str], float] = defaultdict(float)
    for k, path in enumerate(plan.paths):
        cut = plan.segments[k][1]
        fw_bps = b * profile.cut_bytes(cut, FW) * 8.0 * rate
        bw_bps = (b * profile.cut_bytes(cut, BW) * 8.0 * rate
                  if training else 0.0)
        for u, v in zip(path, path[1:]):
            link_fw[(u, v)] += fw_bps
            link_bw[(u, v)] += bw_bps
    # the tail subpath ships psi_K = 0 — no bandwidth reservation
    node_mem: dict[str, float] = defaultdict(float)
    node_disk: dict[str, float] = defaultdict(float)
    for (lo, hi), node in zip(plan.segments, plan.placement):
        mem = profile.seg_mem_bytes(lo, hi)
        mem += b * profile.seg_peak_smashed(lo, hi, request.mode)
        node_mem[node] += mem
        node_disk[node] += profile.seg_disk_bytes(lo, hi)
    return PlanDemand(dict(link_fw), dict(link_bw), dict(node_mem),
                      dict(node_disk))


@dataclass
class ResidualState:
    """Running capacity usage of one fabric under a set of accepted chains."""

    base: PhysicalNetwork
    used_link_fw: dict[tuple[str, str], float] = field(
        default_factory=lambda: defaultdict(float))
    used_link_bw: dict[tuple[str, str], float] = field(
        default_factory=lambda: defaultdict(float))
    used_mem: dict[str, float] = field(default_factory=lambda: defaultdict(float))
    used_disk: dict[str, float] = field(default_factory=lambda: defaultdict(float))
    committed: list[tuple[ServeRequest, Plan]] = field(default_factory=list)
    # shared compute-time memo for the pipelined bottleneck lookups behind
    # plan_demand — one cache per fabric state, reused across the whole round
    eval_cache: EvalCache = field(default_factory=EvalCache, repr=False)
    # per-key committed-chain counts mirroring each tally.  Float tallies
    # accumulate summation residue over long commit/release streams (each
    # `+= f` / `-= f` pair can leave ~ulp(peak) behind), so "this key should
    # be empty now" cannot be decided from the float alone once the residue
    # outgrows _EPS_ABS.  The counts are exact integer bookkeeping: when the
    # last contributing chain departs, release snaps the key to exactly zero
    # instead of trusting the drifted float.
    _cnt_link_fw: dict[tuple[str, str], int] = field(
        default_factory=lambda: defaultdict(int), repr=False, compare=False)
    _cnt_link_bw: dict[tuple[str, str], int] = field(
        default_factory=lambda: defaultdict(int), repr=False, compare=False)
    _cnt_mem: dict[str, int] = field(
        default_factory=lambda: defaultdict(int), repr=False, compare=False)
    _cnt_disk: dict[str, int] = field(
        default_factory=lambda: defaultdict(int), repr=False, compare=False)
    # Failure state (docs/failures.md): resources currently down.  A down
    # link is absent from every materialized view (capacity exactly zero); a
    # down node keeps routability metadata but loses its memory/disk *and*
    # every incident link, so nothing can be placed on it or routed through
    # it.  Both directions of an undirected failure are recorded.
    down_nodes: set[str] = field(default_factory=set)
    down_links: set[tuple[str, str]] = field(default_factory=set)
    # Reverse index resource -> {request_id: multiplicity}: which committed
    # chains' footprints touch each directed link / node, in commit order
    # (dict insertion order).  Lets a failure event find its victims in
    # O(affected) instead of scanning every committed chain.
    _hosted_links: dict[tuple[str, str], dict[int, int]] = field(
        default_factory=dict, repr=False, compare=False)
    _hosted_nodes: dict[str, dict[int, int]] = field(
        default_factory=dict, repr=False, compare=False)
    # request_id -> monotone commit sequence number, so victim sets gathered
    # from several resources can be ordered by commit time in O(n log n)
    _commit_seq: dict[int, int] = field(
        default_factory=dict, repr=False, compare=False)
    _seq_counter: int = field(default=0, repr=False, compare=False)
    # id(plan) -> (plan, links, nodes): memoized plan_footprint, identity-
    # checked like _demand_memo
    _footprint_memo: dict = field(default_factory=dict, repr=False,
                                  compare=False)
    # (request demand identity, id(plan)) -> (plan, profile, PlanDemand).
    # One admission computes the same demand three times (fits, commit,
    # eventually release) and a streaming gateway sees the same few
    # (shape, snapshot-plan) pairs thousands of times; the demand is a pure
    # function of those inputs on the fixed base fabric, so memoize it.  The
    # stored plan/profile references both pin the ids against reuse and are
    # identity-checked on lookup.
    _demand_memo: dict = field(default_factory=dict, repr=False, compare=False)
    # lazily-built keep-saturated materialized view, updated *incrementally*
    # on commit/release (only the links/nodes a plan touches) so the
    # per-admission latency evaluation does not rebuild the whole topology
    _live: PhysicalNetwork | None = field(default=None, init=False,
                                          repr=False, compare=False)

    # ---------------------------------------------------------------- queries
    def _demand(self, profile: ModelProfile, request: ServeRequest,
                plan: Plan) -> PlanDemand:
        """Memoized :func:`plan_demand` (see ``_demand_memo``): keyed by the
        request fields the demand is a function of plus the plan's identity,
        so clones of a recurring shape admitted against a cached snapshot
        plan share one computation."""
        ident = (request.model_id, request.source, request.destination,
                 request.batch_size, request.mode, request.rate_rps,
                 request.schedule, request.n_microbatches)
        key = (ident, id(plan))
        hit = self._demand_memo.get(key)
        if hit is not None and hit[0] is plan and hit[1] is profile:
            return hit[2]
        d = plan_demand(profile, request, plan, self.base, self.eval_cache)
        self._demand_memo[key] = (plan, profile, d)
        return d

    def _footprint(self, plan: Plan) -> tuple[set[tuple[str, str]], set[str]]:
        """Memoized :func:`plan_footprint` (identity-checked, like
        :meth:`_demand`)."""
        hit = self._footprint_memo.get(id(plan))
        if hit is not None and hit[0] is plan:
            return hit[1], hit[2]
        links, nodes = plan_footprint(plan)
        self._footprint_memo[id(plan)] = (plan, links, nodes)
        return links, nodes

    def footprint_clear(self, plan: Plan) -> bool:
        """Does `plan` avoid every down resource?  A down link or node has
        exactly zero capacity — any plan whose footprint touches one cannot
        be committed, including zero-demand tail subpaths."""
        if not (self.down_nodes or self.down_links):
            return True
        links, nodes = self._footprint(plan)
        if self.down_nodes and not self.down_nodes.isdisjoint(nodes):
            return False
        if self.down_links and not self.down_links.isdisjoint(links):
            return False
        return True

    def fits(self, profile: ModelProfile, request: ServeRequest,
             plan: Plan) -> bool:
        """Would committing `plan` keep every link/node within capacity?
        Down resources have zero capacity: any plan touching one never fits."""
        if not self.footprint_clear(plan):
            return False
        d = self._demand(profile, request, plan)
        for (u, v), f in d.link_fw_bps.items():
            spec = self.base.links[(u, v)]
            if not _fits_cap(self.used_link_fw[(u, v)] + f, spec.bw_fw):
                return False
            g = d.link_bw_bps.get((u, v), 0.0)
            if g and not _fits_cap(self.used_link_bw[(u, v)] + g, spec.bw_bw):
                return False
        for n, m in d.node_mem_bytes.items():
            if not _fits_cap(self.used_mem[n] + m,
                             self.base.nodes[n].mem_capacity):
                return False
        for n, s in d.node_disk_bytes.items():
            if not _fits_cap(self.used_disk[n] + s,
                             self.base.nodes[n].disk_capacity):
                return False
        return True

    def _index_commit(self, request: ServeRequest, plan: Plan) -> None:
        rid = request.request_id
        links, nodes = self._footprint(plan)
        for link in links:
            hosted = self._hosted_links.setdefault(link, {})
            hosted[rid] = hosted.get(rid, 0) + 1
        for node in nodes:
            hosted = self._hosted_nodes.setdefault(node, {})
            hosted[rid] = hosted.get(rid, 0) + 1
        self._seq_counter += 1
        cnt, seq = self._commit_seq.get(rid, (0, self._seq_counter))
        self._commit_seq[rid] = (cnt + 1, seq)

    def _index_release(self, request: ServeRequest, plan: Plan) -> None:
        rid = request.request_id
        links, nodes = self._footprint(plan)
        for key, index in ((links, self._hosted_links),
                           (nodes, self._hosted_nodes)):
            for k in key:
                hosted = index[k]
                hosted[rid] -= 1
                if hosted[rid] <= 0:
                    del hosted[rid]
                if not hosted:
                    del index[k]
        cnt, seq = self._commit_seq[rid]
        if cnt <= 1:
            del self._commit_seq[rid]
        else:
            self._commit_seq[rid] = (cnt - 1, seq)

    def commit(self, profile: ModelProfile, request: ServeRequest,
               plan: Plan) -> None:
        if not self.footprint_clear(plan):
            raise ValueError(
                f"commit of chain request_id={request.request_id} touches a "
                f"down resource (down_nodes={sorted(self.down_nodes)}, "
                f"down_links={sorted(self.down_links)})")
        d = self._demand(profile, request, plan)
        for k, f in d.link_fw_bps.items():
            self.used_link_fw[k] += f
            self._cnt_link_fw[k] += 1
        for k, g in d.link_bw_bps.items():
            self.used_link_bw[k] += g
            self._cnt_link_bw[k] += 1
        for n, m in d.node_mem_bytes.items():
            self.used_mem[n] += m
            self._cnt_mem[n] += 1
        for n, s in d.node_disk_bytes.items():
            self.used_disk[n] += s
            self._cnt_disk[n] += 1
        self.committed.append((request, plan))
        self._index_commit(request, plan)
        self._update_live(d)

    def release(self, profile: ModelProfile, request: ServeRequest,
                plan: Plan) -> None:
        """Exact inverse of :meth:`commit`: a departing chain returns its
        :class:`PlanDemand` to the fabric.

        The demand comes from the same memo :meth:`commit` populated, so the
        subtracted floats are bit-identical to the ones :meth:`commit`
        added; a key whose last contributor departs (per the exact integer
        counts) is snapped to exactly zero — summation residue from hundreds
        of commit/release cycles on a hot key can exceed any fixed epsilon,
        so emptiness is decided by the count, not the float.  A fully drained
        state therefore compares clean against a fresh one.  Raises ``KeyError``
        if the (request, plan) pair was never committed — releasing a chain
        twice (or one that was never admitted) is a caller bug, and silently
        subtracting would break :meth:`conservation_ok`, which re-derives
        usage from the committed list."""
        for i, (req, pl) in enumerate(self.committed):
            if req == request and pl == plan:
                del self.committed[i]
                break
        else:
            raise KeyError(f"release of uncommitted chain "
                           f"request_id={request.request_id}")
        self._index_release(request, plan)
        d = self._demand(profile, request, plan)
        for tally, cnt, demand in (
                (self.used_link_fw, self._cnt_link_fw, d.link_fw_bps),
                (self.used_link_bw, self._cnt_link_bw, d.link_bw_bps),
                (self.used_mem, self._cnt_mem, d.node_mem_bytes),
                (self.used_disk, self._cnt_disk, d.node_disk_bytes)):
            for k, v in demand.items():
                cnt[k] -= 1
                if cnt[k] <= 0:
                    # last contributor gone: exact-zero snap (see docstring)
                    del cnt[k]
                    tally.pop(k, None)
                    continue
                tally[k] -= v
                if abs(tally[k]) <= _EPS_ABS:
                    del tally[k]
        self._update_live(d)

    # --------------------------------------------------------------- failures
    def _order_victims(self, ids: set[int]) -> list[int]:
        """Victim request ids in commit order (oldest chain first)."""
        return sorted(ids, key=lambda rid: self._commit_seq[rid][1])

    def chains_on_link(self, u: str, v: str) -> list[int]:
        """Committed chains whose footprint crosses link (u, v) in either
        direction, in commit order — O(affected) via the reverse index."""
        ids: set[int] = set()
        ids.update(self._hosted_links.get((u, v), ()))
        ids.update(self._hosted_links.get((v, u), ()))
        return self._order_victims(ids)

    def chains_on_node(self, node: str) -> list[int]:
        """Committed chains hosted on / routed through `node` or crossing any
        of its incident links, in commit order.  A dead node takes its links
        with it, so transit chains are victims too."""
        ids: set[int] = set(self._hosted_nodes.get(node, ()))
        for (u, v), hosted in self._hosted_links.items():
            if u == node or v == node:
                ids.update(hosted)
        return self._order_victims(ids)

    def fail_link(self, u: str, v: str) -> list[int]:
        """Mark the undirected link {u, v} down; returns the affected chain
        ids (commit order).  The caller (the migration engine) must release
        every victim — this method only flips the capacity state."""
        victims = self.chains_on_link(u, v)
        self.down_links.add((u, v))
        self.down_links.add((v, u))
        self._live = None  # full rebuild: the live view loses the link
        return victims

    def fail_node(self, node: str) -> list[int]:
        """Mark `node` down (memory/disk and every incident link gone);
        returns the affected chain ids (commit order)."""
        victims = self.chains_on_node(node)
        self.down_nodes.add(node)
        self._live = None
        return victims

    def recover_link(self, u: str, v: str) -> None:
        self.down_links.discard((u, v))
        self.down_links.discard((v, u))
        self._live = None  # full rebuild: the live view regains the link

    def recover_node(self, node: str) -> None:
        self.down_nodes.discard(node)
        self._live = None

    def _link_down(self, u: str, v: str) -> bool:
        return (u in self.down_nodes or v in self.down_nodes
                or (u, v) in self.down_links)

    def down_ok(self) -> bool:
        """No committed chain's footprint touches a down resource — the
        invariant the replay verifier asserts after every instant with
        failure events (a down resource has exactly zero capacity, so any
        surviving tenancy would be an accounting bug)."""
        for link in self.down_links:
            if self._hosted_links.get(link):
                return False
        for node in self.down_nodes:
            if self.chains_on_node(node):
                return False
        return True

    # ---------------------------------------------------------- materialization
    def materialize(self, mode: str | None = None,
                    keep_saturated: bool = False) -> PhysicalNetwork:
        """The residual network: capacities minus current usage.

        Links with no forward residual are dropped (they can carry no smashed
        data); for training chains (`mode=TR`) links with no backward residual
        are dropped too, since the gradient flow reserves that direction.  A
        kept link's unreserved direction is clamped to a tiny positive floor
        so edge costs stay finite.  Nodes always remain routable — a node with
        exhausted memory can still forward traffic, it just cannot host a
        sub-model (its residual capacity is 0, so `segment_fits` rejects it).

        ``keep_saturated=True`` keeps every link (rates clamped to the floor
        instead of dropping) — used to *evaluate* an admitted plan's latency,
        where zero-demand tail subpaths may legitimately cross saturated
        links.  Prefer :meth:`live_view` for that: it maintains the same view
        incrementally instead of rebuilding the topology per admission.
        """
        out = PhysicalNetwork()
        for name, spec in self.base.nodes.items():
            if name in self.down_nodes:
                # a down node stays in the topology (solvers index candidate
                # nodes by name) but with zero hosting capacity; its links
                # are dropped below, so nothing can route through it either
                out.add_node(NodeSpec(name, spec.compute, 0.0, 0.0))
                continue
            out.add_node(NodeSpec(
                name, spec.compute,
                max(0.0, spec.mem_capacity - self.used_mem[name]),
                max(0.0, spec.disk_capacity - self.used_disk[name])))
        for (u, v), spec in self.base.links.items():
            if self._link_down(u, v):
                continue  # down = capacity exactly zero, even keep_saturated
            fw = spec.bw_fw - self.used_link_fw[(u, v)]
            bw = spec.bw_bw - self.used_link_bw[(u, v)]
            if not keep_saturated:
                if fw <= 0.0:
                    continue
                if mode == TR and bw <= 0.0:
                    continue
            out.add_link(u, v, LinkSpec(max(fw, _MIN_RATE_BPS),
                                        max(bw, _MIN_RATE_BPS),
                                        spec.delay_fw, spec.delay_bw))
        return out

    def live_view(self) -> PhysicalNetwork:
        """The keep-saturated residual view, maintained *incrementally*.

        Bit-identical to ``materialize(keep_saturated=True)`` at every state
        — the update below recomputes exactly the same clamp expressions from
        the same running tallies, but only for the links/nodes the committed
        (released) plan's demand touches, so the per-admission latency
        evaluation in a long-running gateway costs O(plan) instead of
        O(topology).  Treat as read-only; it is patched in place on every
        commit/release.
        """
        if self._live is None:
            self._live = self.materialize(keep_saturated=True)
        return self._live

    def _update_live(self, d: PlanDemand) -> None:
        live = self._live
        if live is None:
            return
        for (u, v) in set(d.link_fw_bps) | set(d.link_bw_bps):
            if self._link_down(u, v):
                continue  # a victim release must not resurrect a down link
            spec = self.base.links[(u, v)]
            fw = spec.bw_fw - self.used_link_fw[(u, v)]
            bw = spec.bw_bw - self.used_link_bw[(u, v)]
            live.links[(u, v)] = LinkSpec(max(fw, _MIN_RATE_BPS),
                                          max(bw, _MIN_RATE_BPS),
                                          spec.delay_fw, spec.delay_bw)
        for name in set(d.node_mem_bytes) | set(d.node_disk_bytes):
            if name in self.down_nodes:
                continue  # rebuilt with zero capacity on the next full view
            spec = self.base.nodes[name]
            live.nodes[name] = NodeSpec(
                name, spec.compute,
                max(0.0, spec.mem_capacity - self.used_mem[name]),
                max(0.0, spec.disk_capacity - self.used_disk[name]))
        # direct spec assignment bypasses add_link/add_node invalidation
        live.clear_routing_cache()

    # ----------------------------------------------------------- verification
    def conservation_ok(self, profile: ModelProfile) -> bool:
        """Recompute usage from the committed plans and confirm (a) it matches
        the running tallies, (b) nothing exceeds base capacity, and (c) the
        resource -> hosting-chains reverse index matches a fresh re-derivation
        (it is what failure events trust to find their victims)."""
        want_links: dict[tuple[str, str], dict[int, int]] = {}
        want_nodes: dict[str, dict[int, int]] = {}
        for request, plan in self.committed:
            links, nodes = self._footprint(plan)
            rid = request.request_id
            for link in links:
                hosted = want_links.setdefault(link, {})
                hosted[rid] = hosted.get(rid, 0) + 1
            for node in nodes:
                hosted = want_nodes.setdefault(node, {})
                hosted[rid] = hosted.get(rid, 0) + 1
        if (want_links != self._hosted_links
                or want_nodes != self._hosted_nodes):
            return False
        fw: dict[tuple[str, str], float] = defaultdict(float)
        bwd: dict[tuple[str, str], float] = defaultdict(float)
        mem: dict[str, float] = defaultdict(float)
        disk: dict[str, float] = defaultdict(float)
        for request, plan in self.committed:
            d = self._demand(profile, request, plan)
            for k, f in d.link_fw_bps.items():
                fw[k] += f
            for k, g in d.link_bw_bps.items():
                bwd[k] += g
            for n, m in d.node_mem_bytes.items():
                mem[n] += m
            for n, s in d.node_disk_bytes.items():
                disk[n] += s
        for tracked, recomputed in ((self.used_link_fw, fw),
                                    (self.used_link_bw, bwd),
                                    (self.used_mem, mem),
                                    (self.used_disk, disk)):
            keys = set(tracked) | set(recomputed)
            for k in keys:
                a, b = tracked.get(k, 0.0), recomputed.get(k, 0.0)
                if abs(a - b) > _EPS_ABS + _EPS_REL * max(abs(a), abs(b)):
                    return False
        for (u, v), f in fw.items():
            if not _fits_cap(f, self.base.links[(u, v)].bw_fw):
                return False
        for (u, v), g in bwd.items():
            if g and not _fits_cap(g, self.base.links[(u, v)].bw_bw):
                return False
        for n, m in mem.items():
            if not _fits_cap(m, self.base.nodes[n].mem_capacity):
                return False
        for n, s in disk.items():
            if not _fits_cap(s, self.base.nodes[n].disk_capacity):
                return False
        return True
