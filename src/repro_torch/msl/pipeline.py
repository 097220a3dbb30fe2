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

Two meshes run it.  Without a process group, one process drives every
stage, in stage order within a tick (:class:`PipelineMesh`): on one card
all K stages live on it and a hand-off moves nothing.  In a started group
of K x n_data ranks, each rank is one (stage, replica) of a ``("stage",
"data")`` mesh (:class:`StageMesh`) and runs its own part of the schedule:
the hand-offs are point-to-point sends, each replica takes the reference's
shard of every microbatch, and the gradients are averaged over the stage's
replicas before the update (:func:`make_pipeline_train_step`).  Still open
(ROADMAP A21): NCCL with one card per rank, which needs a machine of
several cards.

Where the reference clamps the slot -> group map to the full pattern
repetitions and so never runs the remainder layers of a config whose depth
is not a whole number of repetitions (``stack_for_pipeline`` reads only
``params["stack"]["groups"]``), the port runs them as the last group, as
``ChainSimulator`` does and as ``group_profile`` counts them for the
planner (ROADMAP §C).
"""
from __future__ import annotations

import sys
from dataclasses import dataclass
from functools import partial
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

A21 = ("ROADMAP A21: NCCL with one card per rank, which needs a machine of "
       "several cards")


@dataclass(frozen=True)
class PipelineMesh:
    """The device of each stage, in chain order: every stage in this
    process."""
    stages: tuple[torch.device, ...]

    @property
    def n_stages(self) -> int:
        return len(self.stages)


@dataclass(frozen=True)
class StageMesh:
    """This rank's place in a ``("stage", "data")`` mesh of K x n_data
    processes: rank ``stage * n_data + replica``, row-major as the
    reference's (K, n_data) device array.

    ``route`` says how its tensors move: ``"nccl"`` (one card a rank, the
    production route), ``"gloo-cpu"`` (CPU tensors), ``"gloo-card"``
    (every rank on one card, each hand-off and reduction through pinned
    host buffers, as gloo's point-to-point calls take CPU tensors only) or
    ``"fake"`` (a fake process group: nothing moves; the dry run)."""
    n_stages: int
    n_data: int
    stage: int
    replica: int
    device: torch.device
    route: str
    mesh: object           # the DeviceMesh of ("stage", "data")
    data_group: object     # this stage's replicas
    tied_group: object     # stage 0 and stage K - 1 of this replica, or None

    def rank_of(self, stage: int, replica: int) -> int:
        return stage * self.n_data + replica


def _is_dtensor(t) -> bool:
    """``t`` is a DTensor; without importing ``torch.distributed.tensor``
    (seconds, cold) where nothing has: then no tensor can be one."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def _route(backend: str, device: torch.device) -> str:
    if backend == "nccl":
        return "nccl"
    if backend == "gloo":
        return "gloo-card" if device.type == "cuda" else "gloo-cpu"
    if backend == "fake":
        return "fake"
    raise ValueError(f"the pipeline runs on nccl, gloo or a fake group, not "
                     f"{backend}")


def make_pipeline_mesh(n_stages: int, n_data: int = 1,
                       device: str | torch.device = "cuda"):
    """Without a started process group: ``n_stages`` stages in this
    process, all on ``device`` (``"cuda"`` unless the caller asks for the
    CPU), a :class:`PipelineMesh`; a data axis (``n_data > 1``) then
    raises, naming how to start a group.  In a started group of
    ``n_stages * n_data`` ranks: this rank's :class:`StageMesh`.  On NCCL
    each rank takes the card ``rank % device_count`` (two ranks on one card
    fail in NCCL itself); on gloo every rank takes ``device``."""
    import torch.distributed as dist

    if n_stages < 1 or n_data < 1:
        raise ValueError(f"a pipeline needs a stage and a replica, got "
                         f"{n_stages} x {n_data}")
    if not dist.is_initialized():
        if n_data != 1:
            raise RuntimeError(
                f"a data axis of {n_data} replicas runs one process a "
                f"(stage, replica): start a process group of "
                f"{n_stages * n_data} ranks first (torchrun, or "
                f"torch.multiprocessing with "
                f"torch.distributed.init_process_group in each process); "
                f"still open: {A21}")
        return PipelineMesh((resolve_device(device),) * n_stages)
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n_stages * n_data:
        raise ValueError(f"a mesh of {n_stages} x {n_data} needs "
                         f"{n_stages * n_data} ranks, the group has {world}")
    backend = str(dist.get_backend())
    if backend == "nccl":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = resolve_device(device)
    route = _route(backend, dev)
    from ..launch.mesh import make_mesh

    mesh = make_mesh((n_stages, n_data), ("stage", "data"),
                     "cuda" if route == "nccl" else "cpu")
    stage, replica = divmod(rank, n_data)
    # every rank makes every pair group, in the same order
    tied = None
    for d in range(n_data):
        ranks = sorted({d, (n_stages - 1) * n_data + d})
        group = dist.new_group(ranks) if len(ranks) > 1 else None
        if d == replica:
            tied = group
    return StageMesh(n_stages, n_data, stage, replica, dev, route, mesh,
                     mesh.get_group("data"), tied)


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


def _check_plan(cfg: ModelConfig, plan: PipelinePlan) -> None:
    """The plan's segments cover the config's groups, in order."""
    n_groups = -(-cfg.n_layers // len(cfg.pattern))
    if plan.n_groups != n_groups:
        raise ValueError(f"{cfg.name}: the plan has {plan.n_groups} groups, "
                         f"the config {n_groups}")
    covered = [g for lo, hi in plan.segments for g in range(lo, hi + 1)]
    if covered != list(range(1, n_groups + 1)):
        raise ValueError(f"the segments {plan.segments} do not cover groups "
                         f"1..{n_groups} in order")


def stack_for_pipeline(params: dict, cfg: ModelConfig,
                       plan: PipelinePlan) -> StageStack:
    """The plan's groups laid out stage by stage over ``Gmax`` slots.  A
    slot past its stage's segment is invalid and runs nothing (the
    reference runs it and discards its result)."""
    _check_plan(cfg, plan)
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


def pipeline_forward(params, batch, cfg: ModelConfig, mesh,
                     plan: PipelinePlan, n_micro: int):
    """Embed -> pipelined blocks -> final hidden states (B, S, D) on the
    last stage's device, and the aux loss: summed over stages and active
    ticks, then divided by the M + K - 1 ticks, as the reference's.  On a
    :class:`StageMesh` the ranks of the last stage return their replica's
    rows (:func:`replica_rows`) and the aux's mean over the replicas;
    every other rank returns (None, None)."""
    if T.has_cross(cfg):
        raise ValueError(f"{cfg.name} attends to a memory, which the "
                         f"pipeline does not carry (nor does the JAX "
                         f"package's)")
    if isinstance(mesh, StageMesh):
        return _ranks_forward(params, batch, cfg, mesh, plan, n_micro)
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
    return _final(params, cfg, outs, auxes, plan.K)


def _final(params, cfg: ModelConfig, outs: list, auxes: list, K: int):
    """The final norm a microbatch at a time (the same rows as a forward of
    that microbatch alone) and the aux over the M + K - 1 ticks."""
    hidden = torch.cat([L.rmsnorm(h, params["final_norm"], cfg.norm_eps)
                        for h in outs])
    aux = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for a in auxes:
        aux = aux + a
    return hidden, aux / (len(outs) + K - 1)


def _loss(params, cfg: ModelConfig, hidden, aux, targets):
    head_w = T.head_matrix(params, cfg).to(hidden.dtype)
    nll = chunked_xent(hidden, head_w, targets.to(hidden.device).long(), cfg)
    return nll + AUX_LOSS_COEF * aux, nll


def pipeline_loss(params, batch, cfg: ModelConfig, mesh: PipelineMesh,
                  plan: PipelinePlan, n_micro: int):
    """(``nll + 0.01 * aux``, nll) of a batch of ``tokens`` and ``targets``
    through the pipeline in this process: the train step's loss.  (On a
    :class:`StageMesh` the train step computes its ranks' loss itself.)"""
    if isinstance(mesh, StageMesh):
        raise TypeError("on a StageMesh the train step computes the loss "
                        "on the last stage's ranks")
    hidden, aux = pipeline_forward(params, batch, cfg, mesh, plan, n_micro)
    return _loss(params, cfg, hidden, aux, batch["targets"])


def make_pipeline_train_step(cfg: ModelConfig, mesh, plan: PipelinePlan,
                             n_micro: int, opt: Optimizer):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "nll"})``: :func:`pipeline_loss`, its gradients with respect
    to every parameter, then ``opt``'s update, in place.  Unlike
    ``train.make_train_step`` the gradients are not clipped, as in the
    reference.  Each parameter leaves the step with the ``requires_grad``
    it came with.

    On a :class:`StageMesh` each rank runs its stage of the schedule on its
    replica's rows and updates only its stage's leaves
    (:func:`stage_params`), averaged over the stage's replicas: the
    optimizer state is ``opt.init(local_shards(stage_params(...)), cfg)``,
    AdamW only (Adafactor's update reduces over every repetition of a
    leaf, and those span the stages).  ``params`` is the whole tree or the
    rank's stage; a stage's leaves are whole tensors, or DTensors split
    over its data submesh (:func:`shard_stage`, the reference's ZeRO
    layout), each leaf in either.  The metrics are the means over the
    replicas, on every rank."""
    if isinstance(mesh, StageMesh):
        if opt.name != "adamw":
            raise NotImplementedError(
                f"{opt.name} on a mesh of processes: its update reduces "
                f"over every repetition of a leaf, which span the stages; "
                f"AdamW updates each leaf alone")
        return partial(_ranks_train_step, cfg=cfg, mesh=mesh, plan=plan,
                       n_micro=n_micro, opt=opt)

    def train_step(params, opt_state, batch):
        (loss, nll), grads = value_and_grad(lambda p: pipeline_loss(
            p, batch, cfg, mesh, plan, n_micro), params)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss.detach(),
                                   "nll": nll.detach()}

    return train_step


# ------------------------------------------------------ stages in processes --
def replica_rows(B: int, n_micro: int, n_data: int,
                 replica: int) -> torch.Tensor:
    """The rows of a batch of ``B`` that ``replica`` takes, microbatch by
    microbatch.  The reference reshapes the embeddings to (M, mb, S, D) and
    splits mb over ``"data"`` (``src/repro/msl/pipeline.py:160``,
    ``:165-167``), so replica d of microbatch m holds rows m mb + d mb /
    n_data up to the next replica's, not a contiguous share of the batch
    (an MoE layer groups its tokens by these rows)."""
    if B % n_micro or (B // n_micro) % n_data:
        raise ValueError(f"a batch of {B} rows in {n_micro} microbatches "
                         f"over {n_data} replicas")
    mb = B // n_micro
    ml = mb // n_data
    return torch.cat([torch.arange(m * mb + replica * ml,
                                   m * mb + (replica + 1) * ml)
                      for m in range(n_micro)])


def stage_params(params, cfg: ModelConfig, plan: PipelinePlan,
                 stage: int) -> dict:
    """The leaves of ``params`` that stage ``stage`` of ``plan`` holds (the
    same tensors, not copies): its layers as ``{layer index: layer}`` under
    ``["stack"]["layers"]``, so that every path keeps its index (and
    ``optim.stacked_groups`` groups them as the whole tree's); stage 0 also
    the embedding; the last stage the final norm and the head, or the
    embedding itself where the config ties them, stage 0 and stage K - 1
    then each holding a copy.  ``params`` is the whole tree or a stage's."""
    if T.has_cross(cfg):
        raise ValueError(f"{cfg.name} attends to a memory, which the "
                         f"pipeline does not carry (nor does the JAX "
                         f"package's)")
    _check_plan(cfg, plan)
    lo, hi = plan.segments[stage]
    layers = params["stack"]["layers"]
    out = {}
    if stage == 0:
        out["embed"] = params["embed"]
    out["stack"] = {"layers": {i: layers[i] for g in range(lo - 1, hi)
                               for i in _group_layers(cfg, g)}}
    if stage == plan.K - 1:
        out["final_norm"] = params["final_norm"]
        if cfg.tie_embeddings:
            out["embed"] = params["embed"]
        else:
            out["head"] = params["head"]
    return out


def shard_dim(shape, n_data: int) -> int | None:
    """The dim a leaf splits along over the data axis: the first that
    ``n_data`` divides, the reference's ``shard_of``
    (``src/repro/launch/dryrun_pp.py:65-82``) less its stacked layer dim,
    which the stage assignment takes here.  None keeps the leaf whole."""
    for i, n in enumerate(shape):
        if n >= n_data and n % n_data == 0:
            return i
    return None


def shard_stage(tree, mesh: StageMesh):
    """The ZeRO layout of a stage's leaves: each a DTensor ``Shard(dim)``
    (:func:`shard_dim`) on the stage's data submesh, this replica's slice
    a copy of its own; a leaf no dim of which splits stays whole."""
    from torch.distributed.tensor import DTensor, Shard

    sub = mesh.mesh["data"]

    def shard(t):
        dim = shard_dim(t.shape, mesh.n_data)
        if mesh.n_data == 1 or dim is None:
            return t
        n = t.shape[dim] // mesh.n_data
        local = t.detach().narrow(dim, mesh.replica * n, n).clone()
        return DTensor.from_local(local, sub, [Shard(dim)], run_check=False)

    if mesh.route == "gloo-card":
        raise NotImplementedError(
            "the sharded layout on the gloo-card route: DTensor's gathers "
            "would hand gloo card tensors; run it on nccl or gloo-cpu")
    return T.tree_map(shard, tree)


def local_shards(tree):
    """Each DTensor of ``tree`` as this rank's shard (its storage): what a
    rank's optimizer state is made from and what its update writes."""
    with torch.no_grad():
        return T.tree_map(lambda t: t.to_local() if _is_dtensor(t) else t,
                          tree)


def _gathered(tree):
    """The stage's leaves as its compute takes them, and the (gathered,
    detached) pair of each DTensor leaf: gathered whole once a step (held
    until the stage's last backward), its gradient declared a partial sum
    over the replicas (each replica differentiates its own rows, so the
    backward reduce-scatters their sum to the shards; declared replicated,
    each replica would keep its own share alone), and detached, so that
    every microbatch's backward adds into one gradient."""
    pairs = []

    def gather(t):
        if not _is_dtensor(t):
            return t
        from torch.distributed.tensor import Partial

        full = t.full_tensor(grad_placements=[Partial()])
        if not full.requires_grad:
            return full
        det = full.detach().requires_grad_()
        pairs.append((full, det))
        return det

    return T.tree_map(gather, tree), pairs


def _host(t):
    """A pinned host copy of ``t`` (the gloo-card route)."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def _send(mesh: StageMesh, tensors, dst: int, tag: int, keep: list) -> None:
    """Posts ``tensors`` to rank ``dst`` (``isend``, one a tensor, tags
    ``tag``, ``tag + 1``, ...); the works and their buffers go to ``keep``
    until the step's end.  Each send's bytes are counted as the reference's
    collective-permute (``roofline.op_cost.record_permute``)."""
    import torch.distributed as dist

    from ..roofline.op_cost import record_permute

    for i, t in enumerate(tensors):
        record_permute(t.numel() * t.element_size())
        buf = _host(t) if mesh.route == "gloo-card" else t.contiguous()
        keep.append((dist.isend(buf, dst=dst, tag=tag + i), buf))


def _recv(mesh: StageMesh, specs, src: int, tag: int, keep: list) -> list:
    """Tensors of ``specs`` ((shape, dtype) each) from rank ``src``, on
    this rank's device (the gloo-card route receives into pinned host
    buffers, kept until the step's end, and copies them in without
    waiting)."""
    import torch.distributed as dist

    out = []
    for i, (shape, dtype) in enumerate(specs):
        host = mesh.route == "gloo-card"
        buf = torch.empty(shape, dtype=dtype, pin_memory=True) if host \
            else torch.empty(shape, dtype=dtype, device=mesh.device)
        dist.irecv(buf, src=src, tag=tag + i).wait()
        if host:
            keep.append((None, buf))
            buf = buf.to(mesh.device, non_blocking=True)
        out.append(buf)
    return out


# a flattened reduction's chunks on the gloo-card route, all posted before
# the first is waited on, so that gloo's worker threads carry several at once
HOST_CHUNK = 1 << 27


def _all_reduce(mesh: StageMesh, tensors: list, group, scale: float = 1.0,
                keep: list | None = None) -> None:
    """Sums ``tensors`` over ``group`` in place (then times ``scale``), one
    functional all-reduce a dtype over the tensors flattened (the dry run
    counts it); on the gloo-card route through a pinned host buffer, in
    chunks of HOST_CHUNK bytes posted together."""
    if not tensors:
        return
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    c10d = torch.ops._c10d_functional
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        if mesh.route == "gloo-card":
            host = _host(flat)
            step = max(1, HOST_CHUNK // host.element_size())
            outs = [c10d.all_reduce(c, "sum", group.group_name)
                    for c in host.split(step)]
            out = torch.cat([c10d.wait_tensor(o) for o in outs])
            if keep is not None:
                keep.append((None, out))
            out = out.to(mesh.device, non_blocking=True)
        else:
            out = c10d.wait_tensor(c10d.all_reduce(flat, "sum",
                                                   group.group_name))
        if scale != 1.0:
            out = out * scale
        i = 0
        for t in ts:
            t.copy_(out[i:i + t.numel()].view_as(t))
            i += t.numel()


def _replica_mean(mesh: StageMesh, value, group):
    """The mean of a 0-d ``value`` over ``group`` (a stage's replicas)."""
    if mesh.n_data == 1:
        return value
    out = value.detach().reshape(1).clone()
    _all_reduce(mesh, [out], group, 1.0 / mesh.n_data)
    return out[0]


class _StageRun(NamedTuple):
    """One rank's forward: the (x, aux) it received a microbatch (leaves
    under grad; stage 0: its embedded rows, detached), the (y, aux) it
    computed, stage 0's embedding output, and the works and buffers that
    live until the step's end."""
    ins: list
    outs: list
    embedded: object
    keep: list


def _ranks_run(w, tokens, cfg: ModelConfig, mesh: StageMesh,
               plan: PipelinePlan, n_micro: int, train: bool) -> _StageRun:
    """This rank's ticks of the GPipe schedule (stage s works at ticks
    s <= t < s + M, one microbatch a tick, in order): stage 0 embeds its
    replica's rows once, every other stage receives (h, aux) from stage
    s - 1 of its replica, and each but the last sends its (y, aux) on to
    stage s + 1.  A stage waits only on the one before it, so the order
    cannot deadlock at any M and K."""
    K, s, M = plan.K, mesh.stage, n_micro
    if mesh.n_stages != K:
        raise ValueError(f"a mesh of {mesh.n_stages} stages for a plan of "
                         f"{K}")
    B, S = tokens.shape
    rows = replica_rows(B, M, mesh.n_data, mesh.replica)
    ml = rows.numel() // M
    dev = mesh.device
    ctx = Ctx(mode="train", positions=torch.arange(S, device=dev).expand(
        ml, S))
    lo, hi = plan.segments[s]
    layers = w["stack"]["layers"]
    groups = [[layers[i] for i in _group_layers(cfg, g)]
              for g in range(lo - 1, hi)]
    specs = (((ml, S, cfg.d_model), L.cdt(cfg)), ((), torch.float32))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    ins, outs, keep, embedded = [], [], [], None
    if s == 0:
        x_all = T.embed_tokens(w, cfg, tokens[rows].to(dev))
        ins = [(x.detach().requires_grad_(train and x_all.requires_grad),
                zero) for x in x_all.reshape(M, ml, S, -1).unbind(0)]
        embedded = x_all
    for m in range(M):
        if s == 0:
            x, a = ins[m]
        else:
            x, a = _recv(mesh, specs, mesh.rank_of(s - 1, mesh.replica), 0,
                         keep)
            x.requires_grad_(train)
            a.requires_grad_(train)
            ins.append((x, a))
        y, a = _stage_apply(groups, lo - 1, cfg, x, a, ctx)
        outs.append((y, a))
        if s < K - 1:
            _send(mesh, (y.detach(), a.detach()),
                  mesh.rank_of(s + 1, mesh.replica), 0, keep)
    return _StageRun(ins, outs, embedded, keep)


def _finish(keep: list, mesh: StageMesh) -> None:
    """Waits for every send of the step; on the gloo-card route, for the
    card's copies out of the host buffers too."""
    for work, _ in keep:
        if work is not None:
            work.wait()
    if mesh.route == "gloo-card":
        torch.cuda.current_stream(mesh.device).synchronize()
    keep.clear()


def _ranks_forward(params, batch, cfg: ModelConfig, mesh: StageMesh,
                   plan: PipelinePlan, n_micro: int):
    w, _ = _gathered(stage_params(params, cfg, plan, mesh.stage))
    run = _ranks_run(w, batch["tokens"], cfg, mesh, plan, n_micro,
                     train=False)
    out = (None, None)
    if mesh.stage == plan.K - 1:
        hidden, aux = _final(w, cfg, [y for y, _ in run.outs],
                             [a for _, a in run.outs], plan.K)
        out = hidden, _replica_mean(mesh, aux, mesh.data_group)
    _finish(run.keep, mesh)
    return out


def _backward_pairs(pairs) -> None:
    """``torch.autograd.backward`` over the (tensor, cotangent) pairs whose
    tensor needs a gradient."""
    pairs = [(t, g) for t, g in pairs if t.requires_grad]
    if pairs:
        torch.autograd.backward([t for t, _ in pairs], [g for _, g in pairs])


def _grad(t):
    return t.grad if t.grad is not None else torch.zeros_like(t)


def _ranks_value_and_grad(w, batch, cfg: ModelConfig, mesh: StageMesh,
                          plan: PipelinePlan, n_micro: int, keep: list):
    """This rank's forward, then its backward a microbatch at a time in
    the reverse of the ticks: the last stage's loss (the final norm, the
    head and ``chunked_xent`` over its replica's rows) drives it; every
    other stage receives the cotangent of what it sent from stage s + 1,
    runs ``torch.autograd.backward`` from its outputs, and each stage but
    the first sends the cotangent of what it received back to stage s - 1
    (the transpose of the reference's ``ppermute``: the paper's
    reverse-path gradient chaining).  The gradients land in the leaves'
    ``.grad``; returns the replica's (loss, nll) on the last stage, else
    (None, None)."""
    K, s, M = plan.K, mesh.stage, n_micro
    run = _ranks_run(w, batch["tokens"], cfg, mesh, plan, M, train=True)
    keep += run.keep
    d = mesh.replica
    loss = nll = None
    if s == K - 1:
        det = [(y.detach().requires_grad_(), a.detach().requires_grad_())
               for y, a in run.outs]
        hidden, aux = _final(w, cfg, [y for y, _ in det],
                             [a for _, a in det], K)
        rows = replica_rows(batch["tokens"].shape[0], M, mesh.n_data, d)
        loss, nll = _loss(w, cfg, hidden, aux, batch["targets"][rows])
        loss.backward()
        cots = [(_grad(y), _grad(a)) for y, a in det]
    x0 = run.ins[0][0]
    specs = ((tuple(x0.shape), x0.dtype), ((), torch.float32))
    for m in reversed(range(M)):
        if s == K - 1:
            gy, ga = cots[m]
        else:
            gy, ga = _recv(mesh, specs, mesh.rank_of(s + 1, d), 2, keep)
        y, a = run.outs[m]
        _backward_pairs([(y, gy), (a, ga)])
        if s > 0:
            x, a_in = run.ins[m]
            _send(mesh, (_grad(x), _grad(a_in)), mesh.rank_of(s - 1, d), 2,
                  keep)
    if run.embedded is not None and run.embedded.requires_grad:
        torch.autograd.backward(run.embedded, torch.cat(
            [_grad(x) for x, _ in run.ins]))
    return loss, nll


def _reduce_grads(sp: dict, grads: list, cfg: ModelConfig, mesh: StageMesh,
                  plan: PipelinePlan, keep: list) -> None:
    """The stage's gradients made the step's, in place: every gradient
    averaged over the stage's replicas (a whole leaf's all-reduced, a
    sharded leaf's reduce-scattered by its gather's backward already; both
    then divided by n_data, gloo having no average), then the tied table's
    two copies' summed between stage 0 and stage K - 1 of the replica.  The
    two layouts so add the same four parts of a tied table in one order."""
    local = [g.to_local() if _is_dtensor(g) else g for g in grads]
    if mesh.n_data > 1:
        whole = [g for g, full in zip(local, grads) if not _is_dtensor(full)]
        _all_reduce(mesh, whole, mesh.data_group, 1.0 / mesh.n_data, keep)
        with torch.no_grad():
            for g, full in zip(local, grads):
                if _is_dtensor(full):
                    g.div_(mesh.n_data)
    if (cfg.tie_embeddings and mesh.tied_group is not None
            and mesh.stage in (0, plan.K - 1)):
        i = [p for p, _ in T.tree_paths(sp)].index(("embed",))
        _all_reduce(mesh, [local[i]], mesh.tied_group, keep=keep)


def _ranks_train_step(params, opt_state, batch, *, cfg: ModelConfig,
                      mesh: StageMesh, plan: PipelinePlan, n_micro: int,
                      opt: Optimizer):
    sp = stage_params(params, cfg, plan, mesh.stage)
    leaves = T.tree_leaves(sp)
    flags = [p.requires_grad for p in leaves]
    keep: list = []
    try:
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            w, pairs = _gathered(sp)
            loss, nll = _ranks_value_and_grad(w, batch, cfg, mesh, plan,
                                              n_micro, keep)
            for full, det in pairs:  # the shards' reduce-scatter
                torch.autograd.backward(full, _grad(det))
        grads = [_grad(p) for p in leaves]
    finally:
        for p, flag in zip(leaves, flags):
            p.grad = None
            p.requires_grad_(flag)
    _reduce_grads(sp, grads, cfg, mesh, plan, keep)
    it = iter(grads)
    opt_state = opt.update(local_shards(T.tree_map(lambda _: next(it), sp)),
                           opt_state, local_shards(sp))[1]
    # the replicas' means, on every rank: the last stage's, summed over
    # the world with zeros from the rest
    dev = mesh.device
    metrics = torch.zeros(2, dtype=torch.float32, device=dev)
    if loss is not None:
        metrics = torch.stack([loss.detach(), nll.detach()]).float()
    import torch.distributed as dist

    _all_reduce(mesh, [metrics], dist.group.WORLD, 1.0 / mesh.n_data, keep)
    _finish(keep, mesh)
    return params, opt_state, {"loss": metrics[0], "nll": metrics[1]}


def whole_state(params, opt_state, cfg: ModelConfig, mesh: StageMesh,
                plan: PipelinePlan, opt: Optimizer):
    """The whole parameter tree and a whole AdamW state, on every rank,
    for a checkpoint in the JAX package's format: each leaf, and its
    moments, broadcast from replica 0 of the first stage that holds it
    (stage 0 for a tied table) into ``params`` (the whole tree the rank's
    stage lives in, updated in place) and a fresh ``opt.init(params,
    cfg)``.  Whole leaves only."""
    import torch.distributed as dist

    owner = {}
    for s in range(plan.K):
        for path, _ in T.tree_paths(stage_params(params, cfg, plan, s)):
            owner.setdefault(path, s)
    mine = dict(T.tree_paths(stage_params(params, cfg, plan, mesh.stage)))
    local = {k: dict(T.tree_paths(opt_state[k])) for k in ("m", "v")}
    state = opt.init(params, cfg)
    moments = {k: dict(T.tree_paths(state[k])) for k in ("m", "v")}
    host = mesh.route == "gloo-card"
    with torch.no_grad():
        for path, leaf in T.tree_paths(params):
            src = mesh.rank_of(owner[path], 0)
            for t, value in ((leaf, mine.get(path)),
                             (moments["m"][path], local["m"].get(path)),
                             (moments["v"][path], local["v"].get(path))):
                if _is_dtensor(value):
                    raise NotImplementedError("whole_state of a sharded "
                                              "leaf")
                buf = t.cpu() if host else t
                if dist.get_rank() == src:
                    buf.copy_(value)
                dist.broadcast(buf, src=src)
                if host:
                    t.copy_(buf)
    state["step"] = opt_state["step"]
    return params, state
