"""Fault tolerance & elasticity: checkpoint/restart, node-failure re-planning,
straggler mitigation — the paper's planner as the recovery mechanism.

On a node failure the controller routes through the serve stack's failure
machinery (docs/failures.md): the node is marked down in a
:class:`~repro_torch.serve.ResidualState` (capacity exactly zero, incident links
gone), the hosted chain is detected through the residual reverse index,
released, and re-planned against the *degraded* fabric with BCD (tens of
ms — Fig. 10's headline); the caller then restores the last checkpoint and
rebuilds the step for the new plan.  No candidate stripping is needed — a
down node is unreachable in the degraded network, so the solver avoids it
by construction, and a later `recover` can bring it back.

Straggler mitigation follows the paper's kappa_i calibration: per-node step
times are re-fit by OLS (kappa(b, phi) = (alpha b + beta) phi, Sec. VI-A2)
and the planner re-runs when the refreshed model predicts a better chain.
A compute-model swap changes the planner's instance identity (content
hashes), so the straggler path rebuilds the admission core from scratch and
re-applies any standing failures.

At 1000+ nodes the same machinery applies per pod-group: the planner graph is
the pod-level topology (DESIGN.md Sec. 2.2), so re-planning cost is O(groups),
not O(chips), and checkpoint restore is the only O(params) step.

The controller plans through the port's solver registry: ``bcd_torch`` on
the card by default, bit-identical to the host ``bcd`` the JAX package's
controller uses, so every rebuild and replan runs its DFTS scans through the
min-plus scan kernel.  ``solver_kwargs={"device": "cpu"}`` runs it on the CPU.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

import numpy as np

from ..core import ComputeModel, Plan, PhysicalNetwork
from ..core.costmodel import ModelProfile
from ..core.plan import ServiceChainRequest
from ..serve import AdmissionCore, FailureEvent, ServePlanner, ServeRequest


@dataclass
class StepTimeCalibrator:
    """Online OLS re-fit of kappa_i from measured (b, phi, seconds) samples."""

    samples: dict[str, list[tuple[float, float, float]]] = field(
        default_factory=dict)

    def record(self, node: str, batch: int, flops: float, seconds: float):
        self.samples.setdefault(node, []).append((batch, flops, seconds))

    def fit(self, node: str) -> ComputeModel | None:
        """OLS over t = (alpha*b + beta) * phi  =>  t/phi = alpha*b + beta."""
        pts = self.samples.get(node, [])
        if len(pts) < 2:
            return None
        b = np.array([p[0] for p in pts])
        y = np.array([p[2] / max(p[1], 1.0) for p in pts])
        alpha, beta = np.polyfit(b, y, 1)
        # ComputeModel constants are in ms per FLOP (paper Table II convention)
        return ComputeModel(name=f"fitted-{node}",
                            pieces=((math.inf, alpha * 1e3, beta * 1e3),))


@dataclass
class FTEvent:
    step: int
    kind: str  # failure | straggler | replan | restore
    detail: str


@dataclass
class _PlanResult:
    """The controller's current plan + its predicted latency (the shape the
    demo and callers consumed from the legacy SolveResult)."""

    plan: Plan
    latency_s: float
    feasible: bool = True


class ElasticPlanController:
    """Holds the current plan; re-plans on failures/stragglers.

    Internally this is a one-chain :class:`~repro_torch.serve.AdmissionCore`: the
    training chain is admitted onto the fabric's residual state, node
    failures are :class:`~repro_torch.serve.FailureEvent` marks whose victim
    migration *is* the re-plan, and `recover_node` restores capacity.
    """

    def __init__(self, net: PhysicalNetwork, profile: ModelProfile,
                 request: ServiceChainRequest, K: int,
                 candidates: list[list[str]], solver: str = "bcd_torch",
                 solver_kwargs: dict | None = None):
        self.net = net
        self.solver = solver
        self.solver_kwargs = dict(solver_kwargs or {})
        self.profile = profile
        self.request = request
        self.K = K
        self.candidates = [list(c) for c in candidates]
        self.calibrator = StepTimeCalibrator()
        self.events: list[FTEvent] = []
        self.down_nodes: list[str] = []  # standing failures, survive rebuilds
        self._core: AdmissionCore | None = None
        rec = self._rebuild_core()
        if rec is None:
            raise ValueError("initial plan infeasible")
        self.result = _PlanResult(rec.plan, rec.latency_s)

    def _serve_request(self) -> ServeRequest:
        r = self.request
        return ServeRequest(
            request_id=0, source=r.source, destination=r.destination,
            batch_size=r.batch_size, mode=r.mode, K=self.K,
            candidates=tuple(tuple(c) for c in self.candidates),
            model_id=r.model_id, schedule=r.schedule,
            n_microbatches=r.n_microbatches)

    def _rebuild_core(self):
        """Fresh planner + admission core over the *current* ``self.net``
        (compute models included), with standing node failures re-applied
        before the chain is admitted.  Returns the accepted record or None."""
        planner = ServePlanner(self.net, self.profile, solver=self.solver,
                               solver_kwargs=self.solver_kwargs)
        serve_req = self._serve_request()
        presolved, keys, _ = planner.presolve([serve_req])
        core = AdmissionCore(planner, presolved, keys)
        for node in self.down_nodes:
            core.state.fail_node(node)
        self._core = core
        return core.try_admit(serve_req)

    @property
    def plan(self):
        return self.result.plan

    def fail_node(self, node: str, step: int = -1):
        """Mark `node` down and live-migrate the chain off it (elastic
        scaling down).  The degraded fabric — not a stripped candidate
        list — is what makes the solver avoid the dead node."""
        if node not in self.net.nodes:
            raise ValueError(f"unknown node {node!r}")
        self.events.append(FTEvent(step, "failure", node))
        self.down_nodes.append(node)
        t0 = time.perf_counter()
        victims = self._core.apply_failure(
            FailureEvent(t_s=float(max(step, 0)), kind="node_down",
                         node=node))
        if not victims:
            # the dead node hosted nothing: the current plan survives
            self.events.append(FTEvent(
                step, "replan", f"after losing {node}: plan unchanged"))
            return self.plan
        rec = victims[0]
        if rec.failed_s is not None:  # no feasible placement remains
            raise ValueError(f"re-plan infeasible (after losing {node})")
        return self._adopt(rec, step, f"after losing {node}", t0)

    def recover_node(self, node: str, step: int = -1):
        """Bring a previously failed node back (capacity restored); the
        current plan is kept — the next failure/straggler re-plan may use
        the node again."""
        if node not in self.down_nodes:
            raise ValueError(f"{node!r} is not down")
        self.down_nodes.remove(node)
        self._core.apply_failure(
            FailureEvent(t_s=float(max(step, 0)), kind="recover", node=node))
        self.events.append(FTEvent(step, "restore", node))
        return self.plan

    def observe_step(self, step: int, node: str, batch: int, flops: float,
                     seconds: float, slowdown_threshold: float = 1.5):
        """Record a measured per-node step time; re-fit + re-plan if the node
        is now `slowdown_threshold`x slower than its model predicts."""
        self.calibrator.record(node, batch, flops, seconds)
        predicted = self.net.nodes[node].compute.comp_time_s(batch, flops)
        if predicted > 0 and seconds > slowdown_threshold * predicted:
            fitted = self.calibrator.fit(node)
            if fitted is not None:
                spec = self.net.nodes[node]
                self.net.nodes[node] = type(spec)(
                    spec.name, fitted, spec.mem_capacity, spec.disk_capacity)
                # in-place node swap bypasses add_node: drop derived caches
                # (routing frontiers are compute-independent, but the content
                # key — the planner's instance identity — is not)
                self.net.clear_routing_cache()
                self.events.append(FTEvent(step, "straggler",
                                           f"{node} {seconds/predicted:.1f}x"))
                t0 = time.perf_counter()
                rec = self._rebuild_core()
                if rec is None:
                    raise ValueError(f"re-plan infeasible (straggler {node})")
                return self._adopt(rec, step, f"straggler {node}", t0)
        return None

    def _adopt(self, rec, step: int, why: str, t0: float):
        changed = rec.plan.placement != self.result.plan.placement or \
            rec.plan.segments != self.result.plan.segments
        self.result = _PlanResult(rec.plan, rec.latency_s)
        self.events.append(FTEvent(
            step, "replan",
            f"{why}: {rec.plan.placement} segs={rec.plan.segments} "
            f"in {(time.perf_counter()-t0)*1e3:.1f}ms changed={changed}"))
        return rec.plan
