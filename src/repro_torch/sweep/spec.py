"""Declarative scenario schema for the sweep engine.

A :class:`ScenarioSpec` names everything needed to reproduce one evaluation
grid point — topology factory + kwargs (with optional fault injection), model
profile, ``ServiceChainRequest`` parameters, candidate-set policy, cut count K,
and solver — as plain JSON-able data.  Specs are hashable (content hash) so
results can be memoized on disk and shipped to worker processes.
"""
from __future__ import annotations

import hashlib
import json
import math
from dataclasses import asdict, dataclass, field

from ..core import (
    IF,
    PIPE,
    SCHEDULES,
    SEQ,
    TR,
    LinkSpec,
    ModelProfile,
    PhysicalNetwork,
    ProblemInstance,
    ServiceChainRequest,
    candidate_sets,
    ensure_solver_supported,
    nsfnet,
    random_network,
    resnet101_profile,
    tpu_pod_topology,
)
from ..serve.policies import POLICY_NAMES
from ..serve.requests import ARRIVALS, HOLD_MODELS

# v8: training as a first-class regime (train_share mixed fleets, mode-split
# contention columns, round-trip TR-pipe latencies — docs/training.md); v7:
# failure events + live migration (failure_rate/failure_downtime_s/
# failures/ha knobs, survivability columns); v6: serving gateway (gateway/
# batch_window_s/max_queue/slo_latency_s knobs, cache hit-rate columns); v5:
# event-driven serving sim (sim/hold_model/duration_s/retry knobs, churn
# metrics + error capture in results); v4: engine dispatch (status + stats)
SUITE_SCHEMA_VERSION = 8

# ------------------------------------------------------------------ topologies
TOPOLOGIES = {
    "nsfnet": nsfnet,
    "random": random_network,
    "tpu_pod": tpu_pod_topology,
}


def apply_faults(
    net: PhysicalNetwork,
    drop_nodes: list[str] | tuple[str, ...] = (),
    drop_links: list[tuple[str, str]] | tuple = (),
) -> PhysicalNetwork:
    """Return a copy of `net` with the given nodes / undirected links removed
    (fault-injected scenario variants; both directions of each link go down)."""
    dead_nodes = set(drop_nodes)
    dead_links = {frozenset(pair) for pair in drop_links}
    out = PhysicalNetwork()
    for name, spec in net.nodes.items():
        if name not in dead_nodes:
            out.add_node(spec)
    for (u, v), spec in net.links.items():
        if u in dead_nodes or v in dead_nodes:
            continue
        if frozenset((u, v)) in dead_links:
            continue
        out.add_link(u, v, LinkSpec(spec.bw_fw, spec.bw_bw,
                                    spec.delay_fw, spec.delay_bw))
    return out


def build_topology(name: str, kwargs: dict | None = None,
                   drop_nodes: tuple = (), drop_links: tuple = ()) -> PhysicalNetwork:
    try:
        factory = TOPOLOGIES[name]
    except KeyError:
        raise KeyError(f"unknown topology {name!r}; have {sorted(TOPOLOGIES)}")
    net = factory(**(kwargs or {}))
    if drop_nodes or drop_links:
        net = apply_faults(net, drop_nodes, drop_links)
    return net


# -------------------------------------------------------------------- profiles
def _group_profile(arch: str, seq_len: int = 2048, mode: str = "train",
                   cache_len: int = 0) -> ModelProfile:
    # Lazy import: repro_torch.msl pulls in the model stack, which only the
    # pod-topology scenarios need.
    from ..configs import ARCHS
    from ..msl import group_profile

    return group_profile(ARCHS[arch], seq_len=seq_len, mode=mode,
                         cache_len=cache_len)


PROFILES = {
    "resnet101": resnet101_profile,
    "group": _group_profile,  # kwargs: arch, seq_len, mode
}


def build_profile(name: str, kwargs: dict | None = None) -> ModelProfile:
    try:
        factory = PROFILES[name]
    except KeyError:
        raise KeyError(f"unknown profile {name!r}; have {sorted(PROFILES)}")
    return factory(**(kwargs or {}))


# ----------------------------------------------------------------------- spec
# Fields excluded from the spec content hash (ScenarioSpec.key/spec_hash).
# THE allowlist the `spec-hash` lint rule (docs/analysis.md) checks: every
# field popped out of the hash must be declared here with a justification,
# so a result-changing knob can never silently fall out of cache identity.
HASH_IRRELEVANT = (
    "name",  # human label only; renaming a scenario must not re-run it
    "tags",  # free-form grouping metadata; never read by the runner
)


@dataclass
class ScenarioSpec:
    """One evaluation grid point, fully determined by plain data."""

    topology: str = "nsfnet"
    topology_kwargs: dict = field(default_factory=dict)
    drop_nodes: list = field(default_factory=list)
    drop_links: list = field(default_factory=list)  # undirected [u, v] pairs
    profile: str = "resnet101"
    profile_kwargs: dict = field(default_factory=dict)
    source: str = "v4"
    destination: str = "v13"
    batch_size: int = 1
    mode: str = IF
    K: int = 3
    schedule: str = SEQ  # seq | pipe — the execution model (docs/pipeline.md)
    n_microbatches: int = 1  # pipeline depth M for schedule="pipe"
    solver: str = "bcd"
    solver_kwargs: dict = field(default_factory=dict)
    candidates: list | None = None  # pinned V^k sets; None -> seeded policy
    candidate_seed: int = 0
    candidates_per_stage: int = 2
    # Serve-layer scenarios (repro_torch.serve): n_requests > 1 turns the grid point
    # into a fleet admission round — batch_size becomes the fleet's base batch
    # and candidate_seed seeds fleet generation (arrivals + per-request V^k).
    n_requests: int = 1
    arrival: str = "batch"  # batch | poisson
    policy: str = "fcfs"  # admission policy (repro_torch.serve.policies)
    # Mixed training fleets (docs/training.md): each request is TR with this
    # probability (IF otherwise), overriding `mode`, from a dedicated seeded
    # stream — a mixed fleet and its train_share=0 twin share identical
    # arrivals/candidates/holds, pairing on ``training_key()``.
    train_share: float = 0.0
    # Event-driven serving sim (repro_torch.serve.sim, docs/sim.md): sim=True runs
    # the fleet through ServeSim instead of one static admission round.
    sim: bool = False
    hold_model: str = "none"  # none | fixed | exp (chain holding times)
    duration_s: float | None = None  # holding time (fixed) / mean (exp)
    retry: bool = False  # re-attempt capacity-blocked requests on departures
    # Serving gateway (repro_torch.serve.gateway, docs/gateway.md): gateway=True
    # streams the fleet through a long-running ServeGateway — batched
    # admission ticks over an incremental residual view with a warm PlanCache
    # — instead of one static round (sim) loop.
    gateway: bool = False
    batch_window_s: float = 0.0  # arrival grouping window per admission tick
    max_queue: int | None = None  # bounded admission queue (None: unbounded)
    slo_latency_s: float | None = None  # reject plans slower than this SLO
    # Substrate failures + live migration (repro_torch.serve.failures,
    # docs/failures.md): failure_rate > 0 injects a seeded link_down/node_down
    # schedule into the sim/gateway run; failure_downtime_s adds paired
    # recover events; `failures` pins an explicit [t_s, kind, target] schedule
    # instead (target: node name, or [u, v] for a link); ha=True pre-plans a
    # disjoint standby per chain, promoted on failure.
    failure_rate: float = 0.0  # substrate failure events per second
    failure_downtime_s: float | None = None  # mean downtime (None: stay down)
    failures: list | None = None  # explicit schedule, overrides failure_rate
    ha: bool = False
    name: str = ""  # optional human label; not part of the content hash
    tags: dict = field(default_factory=dict)  # free-form grouping metadata

    def __post_init__(self) -> None:
        if self.mode not in (IF, TR):
            raise ValueError(f"mode must be IF|TR, got {self.mode!r}")
        if self.schedule not in SCHEDULES:
            raise ValueError(f"schedule must be one of {SCHEDULES}")
        if self.n_microbatches < 1:
            raise ValueError("n_microbatches must be >= 1")
        # The one capability check: unknown solver names and solver/schedule
        # mismatches (e.g. ilp models seq only) both come from the registry.
        ensure_solver_supported(self.solver, schedule=self.schedule,
                                batch_size=self.batch_size,
                                n_microbatches=self.n_microbatches)
        if self.n_requests < 1:
            raise ValueError("n_requests must be >= 1")
        if self.arrival not in ARRIVALS:
            raise ValueError(f"arrival must be one of {ARRIVALS}")
        if self.policy not in POLICY_NAMES:
            raise ValueError(f"policy must be one of {POLICY_NAMES}")
        if self.hold_model not in HOLD_MODELS:
            raise ValueError(f"hold_model must be one of {HOLD_MODELS}")
        if not 0.0 <= self.train_share <= 1.0:
            raise ValueError(f"train_share must be in [0, 1], "
                             f"got {self.train_share!r}")
        if self.train_share > 0.0 and self.n_requests < 2:
            raise ValueError("train_share mixes modes across a fleet; it "
                             "requires n_requests > 1 (set mode=TR for a "
                             "single training chain)")
        if self.sim and self.n_requests < 2:
            raise ValueError("sim=True needs a fleet (n_requests > 1)")
        if self.gateway:
            if self.sim:
                raise ValueError("sim and gateway are mutually exclusive "
                                 "drivers of the same fleet")
            if self.n_requests < 2:
                raise ValueError("gateway=True needs a fleet (n_requests > 1)")
        if self.batch_window_s < 0:
            raise ValueError("batch_window_s must be >= 0")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError("max_queue must be >= 1 (or None for unbounded)")
        if self.slo_latency_s is not None and not self.slo_latency_s > 0:
            raise ValueError("slo_latency_s must be > 0 (or None)")
        if not self.gateway and (self.batch_window_s != 0.0
                                 or self.max_queue is not None
                                 or self.slo_latency_s is not None):
            raise ValueError("batch_window_s / max_queue / slo_latency_s "
                             "require gateway=True")
        if self.hold_model != "none":
            if not (self.sim or self.gateway):
                raise ValueError("hold_model requires sim=True or "
                                 "gateway=True (holding times only act "
                                 "through departures)")
            if self.duration_s is None or not (
                    self.duration_s > 0 and math.isfinite(self.duration_s)):
                raise ValueError(f"hold_model={self.hold_model!r} needs a "
                                 f"positive finite duration_s, got "
                                 f"{self.duration_s!r}")
        elif self.duration_s is not None:
            raise ValueError("duration_s is only meaningful with "
                             "hold_model in ('fixed', 'exp')")
        if self.retry and not (self.sim or self.gateway):
            raise ValueError("retry requires sim=True or gateway=True")
        if self.failure_rate < 0:
            raise ValueError("failure_rate must be >= 0")
        if (self.failure_downtime_s is not None
                and not self.failure_downtime_s > 0):
            raise ValueError("failure_downtime_s must be > 0 (or None)")
        has_failures = (self.failure_rate > 0 or self.failures is not None
                        or self.ha)
        if has_failures and not (self.sim or self.gateway):
            raise ValueError("failure_rate / failures / ha require sim=True "
                             "or gateway=True (failures act on the live "
                             "event timeline)")
        if self.failure_downtime_s is not None and not has_failures:
            raise ValueError("failure_downtime_s is only meaningful with "
                             "failure_rate > 0 or an explicit failures list")
        if self.failures is not None:
            norm = []
            for entry in self.failures:
                if len(entry) != 3:
                    raise ValueError(f"each failures entry must be "
                                     f"[t_s, kind, target], got {entry!r}")
                t_s, kind, target = entry
                norm.append([float(t_s), kind,
                             list(target) if isinstance(target, (list, tuple))
                             else target])
            self.failures = norm
        self.drop_links = [list(p) for p in self.drop_links]
        if self.candidates is not None:
            self.candidates = [list(c) for c in self.candidates]

    # ----------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ScenarioSpec":
        return cls(**d)

    def key(self) -> str:
        """Canonical JSON of the solve-relevant fields (exactly the
        HASH_IRRELEVANT allowlist is excluded — enforced by the `spec-hash`
        lint rule)."""
        d = self.to_dict()
        for f in HASH_IRRELEVANT:
            d.pop(f, None)
        return json.dumps(d, sort_keys=True, separators=(",", ":"))

    def spec_hash(self) -> str:
        return hashlib.sha256(self.key().encode()).hexdigest()[:16]

    def scenario_id(self) -> str:
        sched = f"_pipeM{self.n_microbatches}" if self.schedule == PIPE else ""
        return self.name or (
            f"{self.topology}_{self.profile}_{self.mode}_K{self.K}"
            f"_b{self.batch_size}{sched}_{self.solver}_s{self.candidate_seed}"
            f"_{self.spec_hash()[:6]}"
        )

    def group_key(self) -> str:
        """Canonical key of everything *except* the solver — scenarios sharing a
        group key are the same problem instance solved by different schemes."""
        d = self.to_dict()
        for f in ("name", "tags", "solver", "solver_kwargs"):
            d.pop(f, None)
        return json.dumps(d, sort_keys=True, separators=(",", ":"))

    def schedule_key(self) -> str:
        """Canonical key of everything *except* the schedule — a pipe scenario
        and its seq counterpart (same instance, same solver) share this key,
        which is what the seq-vs-pipe speedup report pairs on."""
        d = self.to_dict()
        for f in ("name", "tags", "schedule", "n_microbatches"):
            d.pop(f, None)
        return json.dumps(d, sort_keys=True, separators=(",", ":"))

    def training_key(self) -> str:
        """Canonical key of everything *except* ``train_share`` — a mixed
        training fleet and its all-IF twin (identical arrivals, candidates,
        and holding times by stream construction) share this key, which is
        what the report's training-contention pairing uses."""
        d = self.to_dict()
        for f in ("name", "tags", "train_share"):
            d.pop(f, None)
        return json.dumps(d, sort_keys=True, separators=(",", ":"))

    def churn_key(self) -> str:
        """Canonical key of everything *except* the churn knobs — a sim
        scenario and its static counterpart (identical fleet, solver, and
        policy) share this key, which is what the report's static-vs-churn
        acceptance-uplift pairing uses."""
        d = self.to_dict()
        for f in ("name", "tags", "sim", "hold_model", "duration_s", "retry",
                  "gateway", "batch_window_s", "max_queue", "slo_latency_s",
                  "failure_rate", "failure_downtime_s", "failures", "ha"):
            d.pop(f, None)
        return json.dumps(d, sort_keys=True, separators=(",", ":"))

    # ------------------------------------------------------------ construction
    def build_network(self) -> PhysicalNetwork:
        return build_topology(self.topology, self.topology_kwargs,
                              tuple(self.drop_nodes),
                              tuple(tuple(p) for p in self.drop_links))

    def build_profile(self) -> ModelProfile:
        return build_profile(self.profile, self.profile_kwargs)

    def build_candidates(self, net: PhysicalNetwork) -> list[list[str]]:
        if self.candidates is not None:
            return [list(c) for c in self.candidates]
        return candidate_sets(self.K, self.candidate_seed, sorted(net.nodes),
                              self.source, self.destination,
                              self.candidates_per_stage)

    def request(self) -> ServiceChainRequest:
        return ServiceChainRequest(self.profile, self.source, self.destination,
                                   self.batch_size, self.mode,
                                   schedule=self.schedule,
                                   n_microbatches=self.n_microbatches)

    def problem(self, net: PhysicalNetwork | None = None,
                profile: ModelProfile | None = None) -> ProblemInstance:
        """The spec's single-chain :class:`ProblemInstance` (built objects can
        be passed in to reuse the runner's per-process context caches).  Fleet
        specs (``n_requests > 1``) describe an admission round, not one solve."""
        if self.n_requests > 1:
            raise ValueError("a fleet spec (n_requests > 1) is an admission "
                             "round, not a single ProblemInstance")
        net = net if net is not None else self.build_network()
        profile = profile if profile is not None else self.build_profile()
        return ProblemInstance(net, profile, self.request(), self.K,
                               tuple(tuple(c) for c in
                                     self.build_candidates(net)))

    def instance_key(self) -> str:
        """Content hash of the spec's problem — the same identity the serve
        layer's presolve dedup uses (``ServeRequest.solve_key``), so sweep
        instance grouping and serve dedup can never disagree."""
        return self.problem().content_hash()

    def build_fleet(self, net: PhysicalNetwork):
        """The seeded request fleet of a serve scenario (n_requests > 1)."""
        from ..serve.requests import generate_fleet

        return generate_fleet(
            net, self.n_requests, self.source, self.destination,
            self.batch_size, self.mode, self.K, seed=self.candidate_seed,
            arrival=self.arrival, candidates=self.candidates,
            candidates_per_stage=self.candidates_per_stage,
            model_id=self.profile, schedule=self.schedule,
            n_microbatches=self.n_microbatches,
            hold_model=self.hold_model,
            hold_time_s=(self.duration_s if self.duration_s is not None
                         else float("inf")),
            ha=self.ha, train_share=self.train_share)

    def build_failures(self, net: PhysicalNetwork, fleet) -> list:
        """The scenario's substrate-failure schedule (docs/failures.md):
        the explicit ``failures`` list when pinned, else a seeded schedule
        from ``failure_rate`` over the fleet's active horizon.  Deterministic
        from the spec alone, so ``verify_result`` can rebuild the exact
        schedule a result was produced under."""
        from ..serve.failures import FailureEvent, generate_failures

        if self.failures is not None:
            events = []
            for t_s, kind, target in self.failures:
                if isinstance(target, (list, tuple)):
                    events.append(FailureEvent(t_s, kind,
                                               link=tuple(target)))
                else:
                    events.append(FailureEvent(t_s, kind, node=target))
            return sorted(events, key=lambda e: e.t_s)
        if self.failure_rate <= 0:
            return []
        horizon = (max(r.arrival_s for r in fleet)
                   + (self.duration_s if self.duration_s is not None
                      else 10.0))
        return generate_failures(
            net, rate_per_s=self.failure_rate, horizon_s=horizon,
            seed=self.candidate_seed,
            mean_downtime_s=self.failure_downtime_s,
            protect=(self.source, self.destination))
