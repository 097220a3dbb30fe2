"""Microbatch pipeline runtime executing a PipelinePlan.

The paper's service chain as a GPipe schedule, the JAX package's
``src/repro/msl/pipeline.py`` tick for tick: stage k holds its
planner-assigned contiguous group range; the smashed data (the residual
stream) is handed from stage k to stage k + 1 at the end of every tick, on
the next stage's device (the reference's ``ppermute``); with M microbatches
the schedule runs T = M + K - 1 ticks, stage s working only at ticks
s <= t < s + M (the fill and drain bubbles are skipped), stage 0 injecting
microbatch t and the last stage collecting microbatch t - (K - 1).

The backward is plain autograd through the schedule: it reverses every
hand-off, which is the paper's reverse-path gradient chaining.  The
embedding runs before the stages and the final norm after them.

One process drives every stage, in stage order within a tick.  On one card
all K stages live on it (:func:`make_pipeline_mesh`) and a hand-off moves
nothing; stages in processes of their own, with point-to-point sends over
NCCL and a data axis of replicas, are ROADMAP A21.  With one data replica
the aux loss is the reference's on a ``(K, 1)`` mesh.

Where the reference clamps the slot -> group map to the full pattern
repetitions and so never runs the remainder layers of a config whose depth
is not a whole number of repetitions (``stack_for_pipeline`` reads only
``params["stack"]["groups"]``), the port runs them as the last group, as
``ChainSimulator`` does and as ``group_profile`` counts them for the
planner (ROADMAP §C).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core.torch_solvers import resolve_device
from ..models import layers as L
from ..models import transformer as T
from ..models.layers import Ctx
from ..optim import Optimizer
from ..train.steps import AUX_LOSS_COEF, chunked_xent, value_and_grad
from .planner import PipelinePlan

A21 = ("ROADMAP A21: stages in processes of their own, with point-to-point "
       "sends over NCCL, and a data axis of replicas")


@dataclass(frozen=True)
class PipelineMesh:
    """The device of each stage, in chain order."""
    stages: tuple[torch.device, ...]

    @property
    def n_stages(self) -> int:
        return len(self.stages)


def make_pipeline_mesh(n_stages: int, n_data: int = 1,
                       device: str | torch.device = "cuda") -> PipelineMesh:
    """``n_stages`` stages, all on ``device`` (``"cuda"`` unless the caller
    asks for the CPU).  A data axis (``n_data > 1``) raises: one card has
    no second replica (A21)."""
    if n_data != 1:
        raise NotImplementedError(f"a data axis of {n_data} replicas is not "
                                  f"ported: {A21}")
    if n_stages < 1:
        raise ValueError(f"a pipeline needs a stage, got {n_stages}")
    return PipelineMesh((resolve_device(device),) * n_stages)


# ------------------------------------------------------------ stage layout --
class StageStack(NamedTuple):
    """What :func:`stack_for_pipeline` gives: the stage-major slot -> group
    map (K, Gmax) and its validity mask, as the reference's, and each
    stage's valid group slots, each slot the layers of its group (the
    parameter dicts of ``params``, not copies)."""
    index: np.ndarray   # (K, Gmax) int32, 0-indexed groups, clamped
    valid: np.ndarray   # (K, Gmax) bool
    stages: list        # stages[k][g] = [layer params of group slot g]


def _group_layers(cfg: ModelConfig, g: int) -> range:
    """Layer indices of group ``g`` (0-indexed): repetition ``g`` of the
    pattern, or the remainder layers for the last, partial group."""
    plen = len(cfg.pattern)
    return range(g * plen, min((g + 1) * plen, cfg.n_layers))


def stack_for_pipeline(params: dict, cfg: ModelConfig,
                       plan: PipelinePlan) -> StageStack:
    """The plan's groups laid out stage by stage over ``Gmax`` slots.  A
    slot past its stage's segment is invalid and runs nothing (the
    reference runs it and discards its result)."""
    plen = len(cfg.pattern)
    n_groups = -(-cfg.n_layers // plen)
    if plan.n_groups != n_groups:
        raise ValueError(f"{cfg.name}: the plan has {plan.n_groups} groups, "
                         f"the config {n_groups}")
    covered = [g for lo, hi in plan.segments for g in range(lo, hi + 1)]
    if covered != list(range(1, n_groups + 1)):
        raise ValueError(f"the segments {plan.segments} do not cover groups "
                         f"1..{n_groups} in order")
    K, R = plan.K, plan.n_groups
    Gmax = max(plan.groups_per_stage)
    index = np.asarray([[min(lo - 1 + g, R - 1) for g in range(Gmax)]
                        for lo, _ in plan.segments], np.int32)
    valid = np.asarray([[g < n for g in range(Gmax)]
                        for n in plan.groups_per_stage], bool)
    layers = params["stack"]["layers"]
    stages = [[[layers[i] for i in _group_layers(cfg, int(index[k, g]))]
               for g in range(Gmax) if valid[k, g]] for k in range(K)]
    return StageStack(index, valid, stages)


# ------------------------------------------------------- pipelined forward --
def _group_apply(group, cfg: ModelConfig, kinds, h, ctx: Ctx):
    """One group slot: its layers in order; returns (h, the group's aux
    summed from 0 in layer order)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for p, kind in zip(group, kinds):
        h, _, a = T.apply_block(p, cfg, kind, h, ctx, None)
        aux = aux + a
    return h, aux


def _stage_apply(stage, first_group: int, cfg: ModelConfig, x, aux,
                 ctx: Ctx):
    """This stage's valid group slots over the residual stream ``x``, each
    group's aux added to the microbatch's running ``aux``; under
    ``cfg.remat`` each slot's activations are recomputed in the backward
    (the reference's ``jax.checkpoint`` of its scan body)."""
    all_kinds = T.layer_kinds(cfg.n_layers, cfg.pattern)
    for g, group in enumerate(stage):
        layers = _group_layers(cfg, first_group + g)
        kinds = all_kinds[layers.start:layers.stop]
        if cfg.remat and ctx.mode == "train":
            x, a = checkpoint(_group_apply, group, cfg, kinds, x, ctx,
                              use_reentrant=False)
        else:
            x, a = _group_apply(group, cfg, kinds, x, ctx)
        aux = aux + a
    return x, aux


def pipelined_apply(stack: StageStack, h_mb: list, *, cfg: ModelConfig,
                    mesh: PipelineMesh, plan: PipelinePlan,
                    n_micro: int) -> tuple[list, list]:
    """The GPipe schedule over microbatched embeddings ``h_mb`` (M tensors
    of (mb, S, D) on stage 0's device).  Returns the last stage's M
    outputs and each microbatch's aux (summed over its groups in chain
    order), in microbatch order."""
    K, M = plan.K, n_micro
    if mesh.n_stages != K:
        raise ValueError(f"a mesh of {mesh.n_stages} stages for a plan of "
                         f"{K}")
    mb, S = h_mb[0].shape[0], h_mb[0].shape[1]
    ctxs = [Ctx(mode="train", positions=torch.arange(
        S, device=dev).expand(mb, S)) for dev in mesh.stages]
    first = [lo - 1 for lo, _ in plan.segments]
    zero = torch.zeros((), dtype=torch.float32, device=mesh.stages[0])
    # what each stage received at the end of the last tick: (h, aux); a
    # stage works only at ticks where its predecessor sent at the last one
    received: list = [None] * K
    outs: list = [None] * M
    auxes: list = [None] * M
    for t in range(M + K - 1):
        sent = list(received)
        for s in range(K):
            if not s <= t < s + M:  # a bubble: nothing to do
                continue
            x, aux = (h_mb[t], zero) if s == 0 else received[s]
            y, aux = _stage_apply(stack.stages[s], first[s], cfg, x, aux,
                                  ctxs[s])
            if s == K - 1:  # the last stage collects microbatch t - (K - 1)
                outs[t - (K - 1)], auxes[t - (K - 1)] = y, aux
            else:  # the reference's ppermute; autograd hands gradients back
                dev = mesh.stages[s + 1]
                sent[s + 1] = (y.to(dev), aux.to(dev))
        received = sent
    return outs, auxes


def pipeline_forward(params, batch, cfg: ModelConfig, mesh: PipelineMesh,
                     plan: PipelinePlan, n_micro: int):
    """Embed -> pipelined blocks -> final hidden states (B, S, D) on the
    last stage's device, and the aux loss: summed over stages and active
    ticks, then divided by the M + K - 1 ticks, as the reference's."""
    if T.has_cross(cfg):
        raise ValueError(f"{cfg.name} attends to a memory, which the "
                         f"pipeline does not carry (nor does the JAX "
                         f"package's)")
    tokens = batch["tokens"]
    B, S = tokens.shape
    if B % n_micro:
        raise ValueError(f"a batch of {B} rows in {n_micro} microbatches")
    mb = B // n_micro
    x = T.embed_tokens(params, cfg, tokens.to(mesh.stages[0]))
    h_mb = list(x.reshape(n_micro, mb, S, -1).unbind(0))
    stack = stack_for_pipeline(params, cfg, plan)
    outs, auxes = pipelined_apply(stack, h_mb, cfg=cfg, mesh=mesh, plan=plan,
                                  n_micro=n_micro)
    # the final norm a microbatch at a time: the same rows as a forward of
    # that microbatch alone
    hidden = torch.cat([L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
                        for h in outs])
    aux = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for a in auxes:
        aux = aux + a
    return hidden, aux / (n_micro + plan.K - 1)


def pipeline_loss(params, batch, cfg: ModelConfig, mesh: PipelineMesh,
                  plan: PipelinePlan, n_micro: int):
    """(``nll + 0.01 * aux``, nll) of a batch of ``tokens`` and ``targets``
    through the pipeline: the train step's loss."""
    hidden, aux = pipeline_forward(params, batch, cfg, mesh, plan, n_micro)
    head_w = T.head_matrix(params, cfg).to(hidden.dtype)
    targets = batch["targets"].to(hidden.device).long()
    nll = chunked_xent(hidden, head_w, targets, cfg)
    return nll + AUX_LOSS_COEF * aux, nll


def make_pipeline_train_step(cfg: ModelConfig, mesh: PipelineMesh,
                             plan: PipelinePlan, n_micro: int,
                             opt: Optimizer):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "nll"})``: :func:`pipeline_loss`, its gradients with respect
    to every parameter, then ``opt``'s update, in place.  Unlike
    ``train.make_train_step`` the gradients are not clipped, as in the
    reference.  Each parameter leaves the step with the ``requires_grad``
    it came with."""

    def train_step(params, opt_state, batch):
        (loss, nll), grads = value_and_grad(lambda p: pipeline_loss(
            p, batch, cfg, mesh, plan, n_micro), params)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss.detach(),
                                   "nll": nll.detach()}

    return train_step
