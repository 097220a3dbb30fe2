"""Host-level MSL/MSI executor over a planner Plan: runs the real sub-models
of each chain stage and charges the plan's network delays — the end-to-end
check that the planner's latency decomposition (Eq. 16) corresponds to an
executable chain.

Each stage's sub-model is the contiguous group range the plan assigns;
smashed data is the actual residual-stream tensor handed from stage to stage
(the paper's Fig. 1 forward walk).  The stages run eagerly on the device the
parameters live on; on a card, the measured compute of a stage is the host
time between two ``torch.cuda.synchronize`` calls around it.

Training chains get a full round trip (:meth:`ChainSimulator.round_trip`):
the forward walk keeps each stage's autograd graph from an input of its
own, then a real backward wave runs the graphs in reverse chain order,
handing the gradient cotangent back over each subpath's backward channel
(``delta^BW`` sizes, ``bw_bw`` / ``delay_bw``).
:func:`executed_round_trip_s` replays the same per-resource charged times
through a discrete-event GPipe F-then-B microbatch schedule, an independent
reconstruction that ``trainpipe.evaluate_round_trip``'s closed form is held
to.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from ..configs.base import ModelConfig
from ..core import BW, FW, ServiceChainRequest
from ..core.network import transmission_time_s
from ..core.plan import Plan, PlanEvaluator
from ..core.trainpipe import segment_comp_dir_s
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


@dataclass
class RoundTripResult:
    """Executed forward + backward chain walk: the forward traces in chain
    order followed by the backward traces in reverse chain order, plus the
    gradient handed back to the chain's source (the paper's reverse-path
    smashed flow)."""

    hidden: torch.Tensor
    grad_in: torch.Tensor
    traces: list[StageTrace] = field(default_factory=list)

    def charged_s(self, direction: str | None = None) -> float:
        """Sum of charged (predicted compute + transfer) time, optionally
        restricted to one direction — the executed chain's decomposition."""
        return sum(t.compute_s_predicted + t.transfer_s_charged
                   for t in self.traces
                   if direction is None or t.direction == direction)

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
        if T.has_cross(cfg):
            raise ValueError(f"{cfg.name} attends to a memory, which the "
                             f"chain does not carry (nor does the JAX "
                             f"package's ChainSimulator)")
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

    @torch.no_grad()
    def forward(self, tokens) -> ChainResult:
        """Walk the chain: embed at the source, per-stage blocks at each hop,
        with no autograd graph (``round_trip`` is the chain's training
        pass)."""
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

    # ------------------------------------------------------------ round trip
    def _dir_transfer_s(self, path, cut_after: int,
                        direction: str) -> tuple[float, float]:
        """(transmission, propagation) of the cut's smashed data in ONE
        direction.  Backward gradients are charged on the same directed
        links' backward channels (the R^BW convention of Eq. 7)."""
        nbytes = (self.ev.request.batch_size
                  * self.ev.profile.cut_bytes(cut_after, direction))
        trans = prop = 0.0
        for u, v in zip(path, path[1:]):
            link = self.ev.net.links[(u, v)]
            trans += transmission_time_s(nbytes, link.rate(direction))
            prop += link.delay(direction)
        return trans, prop

    def round_trip(self, plan: Plan, tokens) -> RoundTripResult:
        """Execute the full training round trip on the placed chain.

        The forward walk runs each stage on an input detached from the
        stage before, with ``requires_grad``, and keeps the stage's graph;
        the backward wave then takes ``torch.autograd.grad`` of each
        stage's output with respect to that input alone (the reference's
        ``jax.vjp`` in h: no parameter gradient is built), in reverse chain
        order, handing the real gradient cotangent stage k -> k-1 over
        subpath k-1's backward channel, seeded with ones at the chain's
        destination.  Each trace charges the single direction's predicted
        compute (``trainpipe.segment_comp_dir_s``) and transfer, so
        ``charged_s(FW) + charged_s(BW)`` is the executed chain's
        decomposition of the sequential round trip.
        """
        self.plan = plan
        with torch.no_grad():
            x = T.embed_tokens(self.params, self.cfg, tokens)
        result = RoundTripResult(hidden=x, grad_in=torch.zeros_like(x))
        graphs = []
        for k, ((lo, hi), node) in enumerate(zip(plan.segments,
                                                 plan.placement)):
            fn = self._stage_fn(lo, hi)
            h = x.detach().requires_grad_()
            _sync(h)
            t0 = time.perf_counter()
            with torch.enable_grad():
                x = fn(self.params["stack"], h)
            _sync(x)
            measured = time.perf_counter() - t0
            graphs.append((h, x))
            trans = prop = smashed = 0.0
            if k < plan.K - 1:
                trans, prop = self._dir_transfer_s(plan.paths[k],
                                                   plan.segments[k][1], FW)
                smashed = float(x.numel() * x.element_size())
            result.traces.append(StageTrace(
                stage=k, node=node, groups=(lo, hi),
                compute_s_measured=measured,
                compute_s_predicted=segment_comp_dir_s(self.ev, node, lo, hi,
                                                       FW),
                transfer_s_charged=trans + prop, smashed_bytes=smashed,
                direction=FW))
        result.hidden = x.detach()
        g = torch.ones_like(result.hidden)  # the cotangent seed
        for k in range(plan.K - 1, -1, -1):
            (lo, hi), node = plan.segments[k], plan.placement[k]
            h, out = graphs[k]
            t0 = time.perf_counter()
            (g,) = torch.autograd.grad(out, h, g)
            _sync(g)
            measured = time.perf_counter() - t0
            graphs[k] = None  # the stage's graph is no longer needed
            trans = prop = smashed = 0.0
            if k > 0:  # gradient ships back over subpath k-1
                trans, prop = self._dir_transfer_s(plan.paths[k - 1],
                                                   plan.segments[k - 1][1], BW)
                smashed = float(g.numel() * g.element_size())
            result.traces.append(StageTrace(
                stage=k, node=node, groups=(lo, hi),
                compute_s_measured=measured,
                compute_s_predicted=segment_comp_dir_s(self.ev, node, lo, hi,
                                                       BW),
                transfer_s_charged=trans + prop, smashed_bytes=smashed,
                direction=BW))
        result.grad_in = g
        return result

    def executed_round_trip_s(self, plan: Plan, n_microbatches: int) -> float:
        """Discrete-event GPipe F-then-B replay of the charged chain — see
        the module-level :func:`executed_round_trip_s` (needs only the plan
        evaluator, so tests can replay NSFNET plans without a model)."""
        return executed_round_trip_s(self.ev, plan, n_microbatches)


def executed_round_trip_s(ev, plan: Plan, n_microbatches: int) -> float:
    """Discrete-event GPipe F-then-B replay of the charged chain.

    Every pipeline resource (hosting node per direction, physical link
    channel per direction) serves microbatches FIFO at its full-batch
    time / M; propagation delays microbatches without occupying the
    resource; the backward phase releases only when the forward phase has
    fully drained (the F-then-B barrier).  The makespan is an
    independently computed executed latency that
    ``trainpipe.evaluate_round_trip``'s closed form must match (the classic
    flow-shop identity sum + (M-1)*bottleneck, per direction), to 1e-9
    relative.
    """
    M = n_microbatches
    b = ev.request.batch_size

    res_fw: list[tuple[float, float]] = []  # (full-batch service, prop)
    for k, ((lo, hi), node) in enumerate(zip(plan.segments,
                                             plan.placement)):
        res_fw.append((segment_comp_dir_s(ev, node, lo, hi, FW), 0.0))
        if k < plan.K - 1:
            fw_bytes = b * ev.profile.cut_bytes(plan.segments[k][1], FW)
            for u, v in zip(plan.paths[k], plan.paths[k][1:]):
                link = ev.net.links[(u, v)]
                res_fw.append((transmission_time_s(fw_bytes, link.bw_fw),
                               link.delay_fw))
    res_bw: list[tuple[float, float]] = []
    for k in range(plan.K - 1, -1, -1):
        (lo, hi), node = plan.segments[k], plan.placement[k]
        res_bw.append((segment_comp_dir_s(ev, node, lo, hi, BW), 0.0))
        if k > 0:
            path = plan.paths[k - 1]
            bw_bytes = b * ev.profile.cut_bytes(plan.segments[k - 1][1],
                                                BW)
            for u, v in reversed(list(zip(path, path[1:]))):
                link = ev.net.links[(u, v)]
                res_bw.append((transmission_time_s(bw_bytes, link.bw_bw),
                               link.delay_bw))
    tail_prop = 0.0
    if plan.tail_path:  # psi_K = 0: forward propagation only
        _, tail_prop = ev.net.path_cost_breakdown(plan.tail_path, 0.0,
                                                  None)

    def phase(resources: list[tuple[float, float]], release: float) -> float:
        avail = [release] * len(resources)
        done = release
        for _ in range(M):
            t = release
            for i, (service, prop) in enumerate(resources):
                start = max(t, avail[i])
                avail[i] = start + service / M
                t = avail[i] + prop
            done = t
        return done

    barrier = phase(res_fw, 0.0)  # all M forwards drained at the last node
    return phase(res_bw, barrier) + tail_prop
