"""Training step: chunked cross-entropy loss, gradients, clipping and the
optimizer update, as the JAX package's ``src/repro/train/steps.py``.

The loss is taken in token chunks (``cfg.loss_chunk``), each chunk's
(tokens, vocab) float32 logits recomputed in the backward
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``), so they
are never all kept: one qwen2-1.5b chunk of 4,096 tokens is 4,096 x
151,936 x 4 B = 2.5 GB.  The head and each chunk's logits carry the
reference's sharding constraints (vocab over TP), no-ops without mesh
rules.  The step runs wherever the parameters live:
through the port's kernels on the card, through their plain versions on
the CPU.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..models import transformer as T
from ..models.layers import Ctx, softcap
from ..models import sharding as SH
from ..models.sharding import constrain
from ..optim import Optimizer, clip_by_global_norm

AUX_LOSS_COEF = 0.01


def _chunk_nll(xc, tc, head_w, final_softcap):
    """Summed negative log-likelihood of one chunk: (B, Sc, D), (B, Sc)."""
    # tokens on the DP axes, vocab on TP: dlogits in the layout the head's
    # gradient needs
    logits = constrain((xc @ head_w).float(), ("batch", None, "tp"))
    if final_softcap:
        logits = softcap(logits, final_softcap)
    if SH.sharded(logits):
        return _sharded_nll(logits, tc)
    lse = torch.logsumexp(logits, dim=-1)
    # the gold logit by a gather: the reference's one-hot contraction adds
    # exact zeros to it, so the two are equal
    gold = torch.gather(logits, -1, tc[..., None])[..., 0]
    return torch.sum(lse - gold)


def _sharded_nll(logits, tc):
    """:func:`_chunk_nll`'s sum of a DTensor chunk whose vocab is split
    over ranks (vocab-parallel cross-entropy): the log-sum-exp from the
    shards' maxima and sums of exponentials, the gold logit picked on the
    rank that holds it (a partial sum over the vocab's ranks)."""
    from torch.distributed.tensor import Partial

    mesh = SH.active_rules().mesh
    lp = SH.kept(logits, (0, 2))
    _, v_idx = SH.split_of(lp, 2, mesh)
    m = logits.amax(dim=-1, keepdim=True).detach()
    lse = m[..., 0] + torch.log(torch.exp(logits - m).sum(dim=-1))

    def gold(lg, t):
        lo = v_idx * lg.shape[-1]
        t = t - lo
        mine = (t >= 0) & (t < lg.shape[-1])
        g = torch.gather(lg, -1, torch.where(mine, t, 0)[..., None])[..., 0]
        return g * mine

    rows = SH.like(lp, {0: 0})
    g = SH.local_call(gold, (logits, tc), (lp, rows),
                      [Partial() if p.is_shard(2) else r
                       for p, r in zip(lp, rows)])
    return torch.sum(lse - g)


def chunked_xent(hidden, head_w, targets, cfg: ModelConfig):
    """hidden (B, S, D), head_w (D, V), targets (B, S) -> mean nll (fp32).

    At most 8 chunks along the sequence, as the reference takes them; each
    chunk's logits are recomputed in the backward."""
    B, S, D = hidden.shape
    T_ = B * S
    # vocab-sharded, D-replicated head: contracting against the ZeRO layout
    # instead gathers the whole (D, V) matrix inside the chunk loop; the
    # hidden states' sequence whole (each chunk's product flattens (B, Sc))
    head_w = constrain(head_w, (None, "tp"))
    hidden = constrain(hidden, ("batch", None, None))
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
    pos = SH.positions(tokens, tokens.shape[1])
    ctx = Ctx(mode=mode, positions=pos)
    hidden, _, aux = T.forward(params, cfg, tokens, ctx,
                               memory=batch.get("memory"))
    head_w = T.head_matrix(params, cfg).to(hidden.dtype)
    nll = chunked_xent(hidden, head_w, targets.long(), cfg)
    return nll + AUX_LOSS_COEF * aux, {"nll": nll, "aux": aux}


def value_and_grad(fn, params):
    """``fn(params)``, a tuple whose first element is the loss, and the
    loss's gradient with respect to every leaf of ``params`` (the same
    tree).  Each leaf leaves with the ``requires_grad`` it came with, so a
    forward outside builds no autograd graph unless the caller asked for
    one."""
    leaves = T.tree_leaves(params)
    flags = [p.requires_grad for p in leaves]
    try:
        for p in leaves:
            p.requires_grad_(True)
        with torch.enable_grad():
            out = fn(params)
            grads = torch.autograd.grad(out[0], leaves)
    finally:
        for p, flag in zip(leaves, flags):
            p.requires_grad_(flag)
    it = iter(grads)
    return out, T.tree_map(lambda _: next(it), params)


def make_train_step(cfg: ModelConfig, opt: Optimizer,
                    max_grad_norm: float = 1.0):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradients with respect to every parameter,
    clipped to ``max_grad_norm`` by their global norm, then ``opt``'s
    update.  The parameters and the optimizer's moments are updated in
    place; ``opt_state`` must come from ``opt.init(params, cfg)``.  Each
    parameter leaves the step with the ``requires_grad`` it came with, so
    a forward outside the step builds no autograd graph unless the caller
    asked for one."""

    def train_step(params, opt_state, batch):
        (loss, metrics), grads = value_and_grad(
            lambda p: loss_fn(p, cfg, batch), params)
        # each gradient laid out as its parameter (reduced once), under
        # mesh rules; the gradients themselves without
        grads = T.tree_map2(SH.laid_out_as, grads, params)
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
