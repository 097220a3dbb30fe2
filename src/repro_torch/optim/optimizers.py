"""Optimizers over the port's parameter trees: AdamW and Adafactor, with the
JAX package's arithmetic (``src/repro/optim/optimizers.py``).

AdamW keeps fp32 m and v; Adafactor keeps factored second moments (row and
column means) for leaves of two dimensions or more.  The updates are made
in place under ``torch.no_grad()``: the parameters, and the moments, are
overwritten rather than copied (a second copy of qwen2-1.5b's float32
weights would be 6 GB).

One quirk of the reference is kept on purpose.  The JAX package stacks each
pattern slot's parameters over the pattern's full repetitions, and its
optimizers decide by the rank of a *stacked* leaf: a per-layer vector (a
norm scale, a QKV bias, ``dt_bias``, ``A_log``, ``D_skip``) is a matrix
there.  So AdamW's "decay matrices only" decays such vectors in full
repetitions and not in the remainder layers, and Adafactor factors them
over (repetitions, width) and clips each update's RMS over every repetition
of a leaf together.  The port keeps one leaf per layer, so ``init`` takes
the config that laid the parameters out and groups each pattern slot's
leaves over the full repetitions, as ``models/convert.py`` stacks them; the
updates then decide and reduce over each group as the reference does over
its stacked leaf (ROADMAP §C).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable

import torch

from ..models.transformer import tree_leaves, tree_map, tree_paths


@dataclass(frozen=True)
class Optimizer:
    """``init(params, cfg=None)`` -> state; ``update(grads, state, params)``
    -> (params, state), the parameters updated in place."""
    init: Callable[..., Any]
    update: Callable[..., tuple[Any, Any]]
    name: str


def cosine_schedule(base_lr: float, warmup: int, total: int):
    """Linear warm-up then a cosine decay to 0, in float32 as the
    reference's; ``lr(step)`` is a 0-d float32 tensor."""
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(1.0, warmup)
        frac = torch.clip((step - warmup) / max(1.0, total - warmup), 0, 1)
        cos = 0.5 * base_lr * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup, warm, cos)

    return lr


def clip_by_global_norm(grads, max_norm: float):
    """Scales every gradient by ``min(1, max_norm / (norm + 1e-9))``, in
    place; returns ``(grads, norm)``, the norm a float32 0-d tensor."""
    leaves = tree_leaves(grads)
    with torch.no_grad():
        norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in leaves))
        scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
        for g in leaves:
            g.copy_((g.float() * scale).to(g.dtype))
    return grads, norm


# ----------------------------------------------------------------- groups --
def stacked_groups(params, cfg=None) -> list[tuple[tuple[int, ...], bool]]:
    """The leaves (indices into ``tree_leaves(params)``) that the JAX package
    holds as one leaf: each pattern slot's leaf over the full repetitions,
    in repetition order, stacked (True), in the decoder's stack and in the
    encoder's (one ``attn`` slot over ``cfg.enc_layers``); every other leaf
    alone (False).  Without ``cfg`` every leaf is alone; a tree with a
    model stack needs the config that laid it out."""
    paths = [p for p, _ in tree_paths(params)]
    in_stack = [p[0] in ("stack", "encoder") and p[1:2] == ("layers",)
                for p in paths]
    if cfg is None:
        if any(in_stack):
            raise ValueError("the parameters hold a model stack: pass the "
                             "config that laid it out, so that the updates "
                             "group its layers as the JAX package stacks "
                             "them")
        return [((i,), False) for i in range(len(paths))]
    # each stack's pattern length and its layers in full repetitions
    plens = {"stack": len(cfg.pattern), "encoder": 1}
    full = {"stack": cfg.n_layers // len(cfg.pattern) * len(cfg.pattern),
            "encoder": cfg.enc_layers}
    groups: dict = {}
    order = []
    for i, p in enumerate(paths):
        if in_stack[i] and p[2] < full[p[0]]:
            key = (p[0], p[2] % plens[p[0]]) + p[3:]
        else:
            key = ("alone", i)
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append(i)
    return [(tuple(groups[k]), k[0] != "alone") for k in order]


def _stack(tensors, stacked: bool):
    return torch.stack(tensors) if stacked else tensors[0]


def _unstack_into(dst, value, stacked: bool) -> None:
    for i, d in enumerate(dst):
        d.copy_((value[i] if stacked else value).to(d.dtype))


def _check_tree(tree, n: int, what: str) -> list:
    leaves = tree_leaves(tree)
    if len(leaves) != n:
        raise ValueError(f"{len(leaves)} {what} leaves for {n} parameters")
    return leaves


# ------------------------------------------------------------------ AdamW --
def adamw(lr_fn, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1) -> Optimizer:
    def init(params, cfg=None):
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa
                                      device=p.device)
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": 0, "groups": stacked_groups(params, cfg)}

    def update(grads, state, params):
        step = state["step"] + 1
        lr = float(lr_fn(step))
        step32 = torch.tensor(step, dtype=torch.float32)
        bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** step32)
        bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** step32)
        ps = tree_leaves(params)
        gs = _check_tree(grads, len(ps), "gradient")
        ms, vs = tree_leaves(state["m"]), tree_leaves(state["v"])
        with torch.no_grad():
            for idx, stacked in state["groups"]:
                # the reference decays its stacked leaves of rank 2 or more
                decay = ps[idx[0]].ndim + stacked >= 2
                for i in idx:
                    p, m, v = ps[i], ms[i], vs[i]
                    g = gs[i].float()
                    m.copy_(b1 * m + (1 - b1) * g)
                    v.copy_(b2 * v + (1 - b2) * torch.square(g))
                    delta = (m / bc1) / (torch.sqrt(v / bc2) + eps)
                    if decay:  # decoupled weight decay on matrices only
                        delta = delta + weight_decay * p.float()
                    p.copy_((p.float() - lr * delta).to(p.dtype))
        return params, dict(state, step=step)

    return Optimizer(init, update, "adamw")


# -------------------------------------------------------------- Adafactor --
def adafactor(lr_fn, decay=0.99, eps=1e-30, clip_threshold=1.0) -> Optimizer:
    """Factored second moments: for an (..., R, C) stacked leaf keep row and
    column means.  The state holds one entry per group of
    :func:`stacked_groups`, in the stacked layout."""

    def init(params, cfg=None):
        ps = tree_leaves(params)
        groups = stacked_groups(params, cfg)
        f = []
        for idx, stacked in groups:
            shape = ((len(idx),) if stacked else ()) + tuple(ps[idx[0]].shape)
            dev = ps[idx[0]].device
            if len(shape) >= 2:
                f.append({"vr": torch.zeros(shape[:-1], device=dev),
                          "vc": torch.zeros(shape[:-2] + shape[-1:],
                                            device=dev)})
            else:
                f.append({"v": torch.zeros(shape, device=dev)})
        return {"f": f, "step": 0, "groups": groups}

    def update(grads, state, params):
        step = state["step"] + 1
        lr = float(lr_fn(step))
        ps = tree_leaves(params)
        gs = _check_tree(grads, len(ps), "gradient")
        with torch.no_grad():
            for (idx, stacked), s in zip(state["groups"], state["f"]):
                p = _stack([ps[i] for i in idx], stacked).float()
                g = _stack([gs[i] for i in idx], stacked).float()
                g2 = torch.square(g) + eps
                if p.ndim >= 2:
                    s["vr"].copy_(decay * s["vr"]
                                  + (1 - decay) * g2.mean(dim=-1))
                    s["vc"].copy_(decay * s["vc"]
                                  + (1 - decay) * g2.mean(dim=-2))
                    vr, vc = s["vr"], s["vc"]
                    denom = (vr[..., None] * vc[..., None, :]
                             / torch.clamp(vr.mean(dim=-1)[..., None, None],
                                           min=eps))
                    upd = g * torch.rsqrt(denom + eps)
                else:
                    s["v"].copy_(decay * s["v"] + (1 - decay) * g2)
                    upd = g * torch.rsqrt(s["v"] + eps)
                # update clipping (Shazeer & Stern): RMS(update) <= threshold
                rms = torch.sqrt(torch.mean(torch.square(upd)) + 1e-12)
                upd = upd / torch.clamp(rms / clip_threshold, min=1.0)
                _unstack_into([ps[i] for i in idx], p - lr * upd, stacked)
        return params, dict(state, step=step)

    return Optimizer(init, update, "adafactor")


def make_optimizer(name: str, lr: float = 3e-4, warmup: int = 100,
                   total: int = 10_000) -> Optimizer:
    sched = cosine_schedule(lr, warmup, total)
    if name == "adamw":
        return adamw(sched)
    if name == "adafactor":
        return adafactor(sched)
    raise ValueError(name)
