"""Host-level MSI executor over a planner Plan: runs the real sub-models of
each chain stage and charges the plan's network delays — the end-to-end
check that the planner's latency decomposition (Eq. 16) corresponds to an
executable chain.

Each stage's sub-model is the contiguous group range the plan assigns;
smashed data is the actual residual-stream tensor handed from stage to stage
(the paper's Fig. 1 forward walk).  The stages run eagerly on the device the
parameters live on; on a card, the measured compute of a stage is the host
time between two ``torch.cuda.synchronize`` calls around it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from ..configs.base import ModelConfig
from ..core import FW, ServiceChainRequest
from ..core.plan import Plan, PlanEvaluator
from ..models import transformer as T
from ..models.layers import Ctx


@dataclass
class StageTrace:
    stage: int
    node: str
    groups: tuple[int, int]
    compute_s_measured: float
    compute_s_predicted: float
    transfer_s_charged: float
    smashed_bytes: float
    direction: str = FW


@dataclass
class ChainResult:
    hidden: torch.Tensor
    traces: list[StageTrace] = field(default_factory=list)

    @property
    def total_charged_s(self) -> float:
        return sum(t.compute_s_predicted + t.transfer_s_charged
                   for t in self.traces)

    @property
    def total_measured_compute_s(self) -> float:
        return sum(t.compute_s_measured for t in self.traces)


def _sync(x: torch.Tensor) -> None:
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


class ChainSimulator:
    """Executes a splitting/placement plan stage by stage on the device of
    ``params``, charging per-hop network delays from the plan's evaluator."""

    def __init__(self, cfg: ModelConfig, params, net, profile,
                 request: ServiceChainRequest):
        plen = len(cfg.pattern)
        n_groups = -(-cfg.n_layers // plen)
        if profile.L != n_groups:
            raise ValueError(
                f"{cfg.name}: the profile has {profile.L} groups, the config "
                f"{n_groups}: {cfg.n_layers // plen} whole repetitions of the "
                f"{plen}-block pattern and a last group of the "
                f"{cfg.n_layers % plen} remainder layers, if any")
        self.cfg = cfg
        self.params = params
        self.ev = PlanEvaluator(net, profile, request)
        self.request = request

    def _stage_fn(self, lo: int, hi: int):
        """Executor for group range [lo, hi] (1-indexed inclusive).  Group g
        is repetition g of the pattern; where the layers are not whole
        repetitions, the last group holds the remainder layers, as
        ``group_profile`` groups them for the planner."""
        cfg = self.cfg
        plen = len(cfg.pattern)
        kinds = T.layer_kinds(cfg.n_layers, cfg.pattern)

        def run(stack_params, x):
            B, S = x.shape[0], x.shape[1]
            pos = torch.arange(S, device=x.device).expand(B, S)
            ctx = Ctx(mode="prefill", positions=pos)
            h = x
            for i in range((lo - 1) * plen, min(hi * plen, cfg.n_layers)):
                h, _, _ = T.apply_block(stack_params["layers"][i], cfg,
                                        kinds[i], h, ctx, None)
            return h

        return run

    def forward(self, tokens) -> ChainResult:
        """Walk the chain: embed at the source, per-stage blocks at each hop."""
        plan: Plan = self.plan
        x = T.embed_tokens(self.params, self.cfg, tokens)
        result = ChainResult(hidden=x)
        for k, ((lo, hi), node) in enumerate(zip(plan.segments, plan.placement)):
            fn = self._stage_fn(lo, hi)
            _sync(x)
            t0 = time.perf_counter()
            x = fn(self.params["stack"], x)
            _sync(x)
            measured = time.perf_counter() - t0
            predicted = self.ev.segment_comp_s(node, lo, hi)
            trans = prop = 0.0
            smashed = 0.0
            if k < plan.K - 1:
                trans, prop = self.ev.cut_transfer_s(plan.paths[k],
                                                     plan.segments[k][1])
                smashed = float(x.numel() * x.element_size())
            result.traces.append(StageTrace(
                stage=k, node=node, groups=(lo, hi),
                compute_s_measured=measured, compute_s_predicted=predicted,
                transfer_s_charged=trans + prop, smashed_bytes=smashed))
        result.hidden = x
        return result

    def run_plan(self, plan: Plan, tokens) -> ChainResult:
        self.plan = plan
        return self.forward(tokens)
