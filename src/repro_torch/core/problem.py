"""First-class problem and outcome types of the solver engine.

A :class:`ProblemInstance` is the one canonical description of a solve: the
physical network, the model profile, the service chain request, the cut count
K, and the per-stage candidate sets V^k.  It is frozen and *content*-hashable
— two instances built independently from equal data hash equal — so it is the
single identity used for presolve dedup and instance grouping/caching (it
subsumes the solve_key / instance_key conventions those layers used to
re-implement).  :meth:`ProblemInstance.from_content_key` rebuilds an instance
from that canonical JSON, which is how an instance crosses from the JAX
package into this one.

:class:`SolveResult` is the raw record every solver implementation returns;
:class:`SolveOutcome` extends it with a solve status (``optimal`` |
``feasible`` | ``infeasible``) and a free-form solver-stats dict, and is what
the engine's :func:`repro_torch.core.engine.solve` entry point hands back.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field

from .costmodel import SEQ, ComputeModel, LayerProfile, ModelProfile
from .network import LinkSpec, NodeSpec, PhysicalNetwork
from .plan import LatencyBreakdown, Plan, ServiceChainRequest

# Solve status vocabulary (SolveOutcome.status).
OPTIMAL = "optimal"  # feasible and provably latency-minimal for the instance
FEASIBLE = "feasible"  # a valid plan with no optimality guarantee
INFEASIBLE = "infeasible"  # the solver found no capacity-feasible plan
STATUSES = (OPTIMAL, FEASIBLE, INFEASIBLE)


@dataclass(frozen=True, eq=False)
class ProblemInstance:
    """One complete splitting/placement/chaining problem (paper Sec. III).

    ``candidates`` is a tuple of K tuples of node names (V^1..V^K).  Identity
    is by *content*: :meth:`content_key` canonicalizes the network's nodes and
    links, the profile's layer table, the request, K, and the candidate sets;
    ``__eq__``/``__hash__`` and :meth:`content_hash` derive from it.  Requests
    whose effective pipeline depth is 1 normalize to the sequential schedule
    in the key (``pipe`` with M = 1 is bit-for-bit the sequential objective),
    so trivially-equal problems can never hash apart.
    """

    net: PhysicalNetwork
    profile: ModelProfile
    request: ServiceChainRequest
    K: int
    candidates: tuple[tuple[str, ...], ...]

    def __post_init__(self) -> None:
        object.__setattr__(self, "candidates",
                           tuple(tuple(c) for c in self.candidates))
        if len(self.candidates) != self.K:
            raise ValueError(
                f"need exactly K={self.K} candidate sets, got "
                f"{len(self.candidates)}")
        object.__setattr__(self, "_ckey", None)

    # ---------------------------------------------------------------- identity
    def content_key(self) -> str:
        """Canonical JSON of everything that defines the problem."""
        if self._ckey is None:  # type: ignore[attr-defined]
            r = self.request
            M = r.microbatches()
            schedule = r.schedule if M > 1 else SEQ
            key = json.dumps({
                "net": self.net.content_key(),
                "profile": self.profile.content_key(),
                "request": [r.model_id, r.source, r.destination, r.batch_size,
                            r.mode, schedule, M],
                "K": self.K,
                "candidates": [list(c) for c in self.candidates],
            }, sort_keys=True, separators=(",", ":"))
            object.__setattr__(self, "_ckey", key)
        return self._ckey  # type: ignore[attr-defined]

    @classmethod
    def from_content_key(cls, key: str) -> "ProblemInstance":
        """Rebuild an instance from :meth:`content_key` JSON.

        The key is the canonical form that the JAX package's
        ``ProblemInstance.content_key()`` emits too, so this carries an
        instance from there into this package: the rebuilt instance has an
        equal ``content_key()`` and ``content_hash()``.  Every field the
        solvers read is in the key, so no extra argument is needed.  Two
        normalisations of the key carry over: a request whose effective
        pipeline depth is 1 comes back as ``schedule="seq"``, and
        ``n_microbatches`` is the effective depth M (the solvers read only
        ``request.microbatches()``, which is the same either way).  Nodes
        and links are inserted in the key's sorted order; the network's
        routing breaks equal-cost ties by node name, so that order changes
        no path.
        """
        d = json.loads(key)
        nd = json.loads(d["net"])  # the parts are keys of their own
        net = PhysicalNetwork()
        for name, (cname, pieces, a_tau, b_tau, mem, disk) in \
                nd["nodes"].items():
            compute = ComputeModel(cname, tuple(tuple(pc) for pc in pieces),
                                   a_tau, b_tau)
            net.add_node(NodeSpec(name, compute, mem, disk))
        for u, v, bw_fw, bw_bw, d_fw, d_bw in nd["links"]:
            net.add_link(u, v, LinkSpec(bw_fw, bw_bw, d_fw, d_bw))
        model_id, layers = json.loads(d["profile"])
        profile = ModelProfile(model_id, [LayerProfile(*row) for row in layers])
        model, src, dst, b, mode, schedule, M = d["request"]
        request = ServiceChainRequest(model, src, dst, b, mode, schedule, M)
        return cls(net, profile, request, d["K"],
                   tuple(tuple(c) for c in d["candidates"]))

    def content_hash(self) -> str:
        return hashlib.sha256(self.content_key().encode()).hexdigest()[:16]

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, ProblemInstance):
            return NotImplemented
        return self.content_key() == other.content_key()

    def __hash__(self) -> int:
        return hash(self.content_key())

    def __repr__(self) -> str:  # the field repr would dump the whole network
        r = self.request
        return (f"ProblemInstance({r.model_id!r}, {r.source}->{r.destination},"
                f" b={r.batch_size}, mode={r.mode}, schedule={r.schedule},"
                f" K={self.K}, |V|={len(self.net.nodes)},"
                f" hash={self.content_hash()})")

    # ------------------------------------------------------------- convenience
    def candidate_lists(self) -> list[list[str]]:
        """The mutable ``list[list[str]]`` shape the solver protocol takes."""
        return [list(c) for c in self.candidates]

    def solver_args(self) -> tuple:
        """Positional args of the solver protocol:
        ``(net, profile, request, K, candidates)``."""
        return (self.net, self.profile, self.request, self.K,
                self.candidate_lists())


@dataclass
class SolveResult:
    """Raw record returned by every solver implementation."""

    plan: Plan | None
    latency: LatencyBreakdown | None
    wall_time_s: float
    iterations: int = 0
    history: list[float] = field(default_factory=list)
    solver: str = "bcd"

    @property
    def feasible(self) -> bool:
        return self.plan is not None

    @property
    def latency_s(self) -> float:
        return self.latency.total_s if self.latency else float("inf")


@dataclass
class SolveOutcome(SolveResult):
    """A :class:`SolveResult` plus solve status and solver stats.

    ``status`` is one of :data:`STATUSES`; ``stats`` is free-form JSON-able
    solver detail (the portfolio meta-solver reports per-member outcomes
    here).  ``objective`` is the minimized end-to-end latency in seconds
    (``inf`` when infeasible).
    """

    status: str = INFEASIBLE
    stats: dict = field(default_factory=dict)

    def __post_init__(self) -> None:
        assert self.status in STATUSES, f"unknown status {self.status!r}"

    @property
    def objective(self) -> float:
        return self.latency_s

    @classmethod
    def from_result(cls, res: SolveResult, *, optimal: bool,
                    stats: dict | None = None) -> "SolveOutcome":
        """Wrap a raw solver result; ``optimal`` is the solver's declared
        optimality guarantee (applied only when a plan was found)."""
        if res.plan is None:
            status = INFEASIBLE
        else:
            status = OPTIMAL if optimal else FEASIBLE
        return cls(res.plan, res.latency, res.wall_time_s, res.iterations,
                   list(res.history), res.solver, status=status,
                   stats=dict(stats or {}))
