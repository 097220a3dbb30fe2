"""MSL planner: the paper's splitting/placement/chaining optimizer applied to
a model's pattern groups.

Pipeline units are pattern *groups* (one repetition of ``cfg.pattern``), so
every stage runs a structurally identical program.  The planner consumes the
group-level cost profile (rho/delta/r per group) and a ``tpu_pod_topology``
graph whose nodes are candidate stage groups, and returns the
latency-minimising (K, segments, placement).  By default it solves with
``bcd_torch`` on the card, whose DFTS block launches the min-plus kernel.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..configs.base import ModelConfig
from ..core import (
    TR,
    LayerProfile,
    ModelProfile,
    Plan,
    ProblemInstance,
    ServiceChainRequest,
    solve,
)
from ..core.topology import tpu_pod_topology
from ..models.profiles import model_profile


def group_profile(cfg: ModelConfig, seq_len: int, mode: str = "train",
                  cache_len: int = 0) -> ModelProfile:
    """Merge per-block rows of model_profile into pattern-group rows
    (embed/head/encoder rows are excluded — they run outside the pipeline)."""
    prof = model_profile(cfg, seq_len, mode, cache_len)
    rows = prof.layers[1 + cfg.enc_layers : -1]  # block rows only
    plen = len(cfg.pattern)
    groups: list[LayerProfile] = []
    for i in range(0, len(rows), plen):
        chunk = rows[i : i + plen]
        groups.append(LayerProfile(
            name=f"group{i // plen}",
            flops_fw=sum(r.flops_fw for r in chunk),
            flops_bw=sum(r.flops_bw for r in chunk),
            act_bytes=chunk[-1].act_bytes,
            grad_bytes=chunk[-1].grad_bytes,
            mem_bytes=sum(r.mem_bytes for r in chunk),
            disk_bytes=sum(r.disk_bytes for r in chunk),
        ))
    return ModelProfile(cfg.name + "-groups", groups)


@dataclass
class PipelinePlan:
    K: int
    segments: list[tuple[int, int]]  # 1-indexed inclusive GROUP ranges
    placement: list[str]
    n_groups: int
    predicted_latency_s: float
    breakdown: dict
    plan: Plan  # the solver's plan (segments, placement and paths)
    problem: ProblemInstance  # what was solved: network, profile, request

    @property
    def groups_per_stage(self) -> list[int]:
        return [hi - lo + 1 for lo, hi in self.segments]


def plan_pipeline(cfg: ModelConfig, *, seq_len: int, microbatch: int,
                  candidate_K: tuple[int, ...] = (2, 4, 8),
                  n_groups_mesh: int = 8, chips_per_group: int = 64,
                  mode: str = TR, solver: str = "bcd_torch",
                  device: str | torch.device = "cuda") -> PipelinePlan:
    """Choose K and the per-stage group ranges minimizing the paper objective
    on the pod-level topology.  `microbatch` plays the paper's batch-size b
    role (smashed data = microbatch x activation bytes).  ``solver`` is one
    of the port's device solvers (``bcd_torch``, ``dfts_torch``), run on
    ``device``."""
    prof = group_profile(cfg, seq_len, "train" if mode == TR else "prefill")
    net = tpu_pod_topology(n_groups=n_groups_mesh,
                           chips_per_group=chips_per_group)
    nodes = sorted(net.nodes)
    best: PipelinePlan | None = None
    for K in candidate_K:
        if K > prof.L or K > len(nodes):
            continue
        cands = [[nodes[0]]] + [nodes[1:-1] or nodes for _ in range(K - 2)] \
            + [[nodes[-1]]]
        if K == 1:
            continue
        req = ServiceChainRequest(cfg.name, nodes[0], nodes[-1], microbatch,
                                  mode)
        problem = ProblemInstance(net, prof, req, K,
                                  tuple(tuple(c) for c in cands))
        res = solve(problem, solver=solver, device=device)
        if not res.feasible:
            continue
        plan = PipelinePlan(
            K=K, segments=res.plan.segments, placement=res.plan.placement,
            n_groups=prof.L, predicted_latency_s=res.latency_s,
            breakdown={
                "computation_s": res.latency.computation_s,
                "transmission_s": res.latency.transmission_s,
                "propagation_s": res.latency.propagation_s,
            }, plan=res.plan, problem=problem)
        if best is None or plan.predicted_latency_s < best.predicted_latency_s:
            best = plan
    if best is None:
        raise ValueError(f"no feasible pipeline plan for {cfg.name}")
    return best
