"""Training step: chunked cross-entropy loss, gradients, clipping and the
optimizer update, as the JAX package's ``src/repro/train/steps.py``.

The loss is taken in token chunks (``cfg.loss_chunk``), each chunk's
(tokens, vocab) float32 logits recomputed in the backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``), so they
are never all kept: one qwen2-1.5b chunk of 4,096 tokens is 4,096 x
151,936 x 4 B = 2.5 GB.  The reference's sharding constraints have no
counterpart on one device.  The step runs wherever the parameters live:
through the port's kernels on the card, through their plain versions on
the CPU.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..models import transformer as T
from ..models.layers import Ctx, softcap
from ..optim import Optimizer, clip_by_global_norm

AUX_LOSS_COEF = 0.01


def _chunk_nll(xc, tc, head_w, final_softcap):
    """Summed negative log-likelihood of one chunk: (B, Sc, D), (B, Sc)."""
    logits = (xc @ head_w).float()
    if final_softcap:
        logits = softcap(logits, final_softcap)
    lse = torch.logsumexp(logits, dim=-1)
    # the gold logit by a gather: the reference's one-hot contraction adds
    # exact zeros to it, so the two are equal
    gold = torch.gather(logits, -1, tc[..., None])[..., 0]
    return torch.sum(lse - gold)


def chunked_xent(hidden, head_w, targets, cfg: ModelConfig):
    """hidden (B, S, D), head_w (D, V), targets (B, S) -> mean nll (fp32).

    At most 8 chunks along the sequence, as the reference takes them; each
    chunk's logits are recomputed in the backward."""
    B, S, D = hidden.shape
    T_ = B * S
    n = max(1, min(8, T_ // max(1, cfg.loss_chunk)))
    while S % n:
        n -= 1
    xs = hidden.reshape(B, n, S // n, D)
    ts = targets.reshape(B, n, S // n)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(n):
        total = total + checkpoint(_chunk_nll, xs[:, c], ts[:, c], head_w,
                                   cfg.final_softcap, use_reentrant=False)
    return total / T_


def loss_fn(params, cfg: ModelConfig, batch, mode: str = "train"):
    """(loss, {"nll", "aux"}) of a batch of ``tokens`` and ``targets``
    (B, S) on the parameters' device."""
    tokens, targets = batch["tokens"], batch["targets"]
    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device).expand(B, S)
    ctx = Ctx(mode=mode, positions=pos)
    hidden, _, aux = T.forward(params, cfg, tokens, ctx,
                               memory=batch.get("memory"))
    head_w = T.head_matrix(params, cfg).to(hidden.dtype)
    nll = chunked_xent(hidden, head_w, targets.long(), cfg)
    return nll + AUX_LOSS_COEF * aux, {"nll": nll, "aux": aux}


def make_train_step(cfg: ModelConfig, opt: Optimizer,
                    max_grad_norm: float = 1.0):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradients with respect to every parameter,
    clipped to ``max_grad_norm`` by their global norm, then ``opt``'s
    update.  The parameters and the optimizer's moments are updated in
    place; ``opt_state`` must come from ``opt.init(params, cfg)``."""

    def train_step(params, opt_state, batch):
        leaves = T.tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            loss, metrics = loss_fn(params, cfg, batch)
            grads = torch.autograd.grad(loss, leaves)
        it = iter(grads)
        grads = T.tree_map(lambda _: next(it), params)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        params, opt_state = opt.update(grads, opt_state, params)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(loss=loss.detach(), grad_norm=gnorm)
        return params, opt_state, metrics

    return train_step


def make_eval_step(cfg: ModelConfig):
    def eval_step(params, batch):
        with torch.no_grad():
            loss, metrics = loss_fn(params, cfg, batch, mode="prefill")
        return dict(metrics, loss=loss)

    return eval_step
