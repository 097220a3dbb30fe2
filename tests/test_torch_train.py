"""The port's training step on the CPU against the JAX package's.

For every config the port's models run (all but the cross-attention ones,
ROADMAP A9), reduced: the JAX parameters carried over with
``convert.params_from_jax``, the same numpy batch, then the loss and the
gradient of every parameter in both packages (``jax.value_and_grad`` of
``repro.train.steps.loss_fn`` against ``torch.autograd.grad`` of the
port's).  In float32 compute the loss agrees to 1e-5, the global gradient
norm to 1e-5, and each gradient leaf to 1e-4 of that leaf's largest |JAX
gradient| (float32 sums in other orders, amplified by the backward; a
leaf stored in bf16 to one bf16 ulp of its largest magnitude); every
MoE token routes alike (route-aware, as ``tests/test_torch_models.py``).
In bf16 compute (the card's type) the frameworks round at other places,
so the loss and each leaf are held to 5e-2, the bound of a stack of
blocks in ``tests/test_torch_models.py``.  Rematerialisation changes no
gradient bit, and a few AdamW steps lower the loss on the structured
synthetic stream, as ``tests/test_arch_smoke.py`` has it.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.configs import ARCHS as JAX_ARCHS
from repro.models import transformer as JT
from repro.models.layers import Ctx as JCtx
from repro.train import steps as jsteps
from repro_torch import optim, train
from repro_torch.configs import ARCHS
from repro_torch.data import BatchSpec, SyntheticLM, shard_batch
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from test_torch_models import recorded_routes

ARCH_NAMES = sorted(a for a, c in ARCHS.items()
                    if not c.enc_layers and "xattn" not in c.pattern)
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
LEAF_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# a leaf stored in bf16 (arctic-480b's weights) gets its gradient rounded
# to bf16 by both packages, from fp32 sums in other orders: one bf16 ulp
# apart, at most 2**-7 of the leaf's largest magnitude
BF16_LEAF_TOL = 2.0 ** -7
B, S = 2, 16


def _setup(arch, compute_dtype):
    jcfg = JAX_ARCHS[arch].reduced(compute_dtype=compute_dtype)
    cfg = ARCHS[arch].reduced(compute_dtype=compute_dtype)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S + 1))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "targets": toks[:, 1:].astype(np.int32)}
    return jcfg, cfg, jp, tp, batch


def _port_grads(cfg, params, batch):
    leaves = T.tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = train.loss_fn(params, cfg, shard_batch(batch, "cpu"))
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), grads


# float32 for every config; bf16 for the card's two training configs
@pytest.mark.parametrize("arch,compute_dtype", [
    (a, "float32") for a in ARCH_NAMES] + [("qwen2-1.5b", "bfloat16"),
                                          ("mamba2-370m", "bfloat16")])
def test_loss_and_gradients_match_jax(arch, compute_dtype, monkeypatch):
    jcfg, cfg, jp, tp, batch = _setup(arch, compute_dtype)
    if cfg.n_experts:  # every token routes alike in float32
        pos = torch.arange(S).expand(B, S)
        with recorded_routes(monkeypatch) as (port, ref):
            jax.jit(lambda p, t, q: JT.forward(
                p, jcfg, t, JCtx(mode="train", positions=q)))(
                jp, jnp.asarray(batch["tokens"]), jnp.asarray(pos.numpy()))
            T.forward(tp, cfg, torch.from_numpy(batch["tokens"]).long(),
                      L.Ctx(mode="train", positions=pos))
        ra = L.routing_agreement(port, ref)
        assert ra.picks > 0 and ra.flips == 0 and bool(ra.agree.all())
    (jloss, _), jgrads = jax.jit(
        jax.value_and_grad(jsteps.loss_fn, has_aux=True),
        static_argnums=1)(jp, jcfg, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
    loss, grads = _port_grads(cfg, tp, batch)
    assert abs(float(loss) - float(jloss)) <= TOL[compute_dtype] * abs(
        float(jloss))
    want = T.tree_leaves(convert.params_from_jax(
        jax.tree.map(np.asarray, jgrads), cfg, "cpu"))
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        tol = BF16_LEAF_TOL if w.dtype == torch.bfloat16 else \
            LEAF_TOL[compute_dtype]
        err = float((g.double() - w.double()).abs().max())
        assert err <= tol * max(float(w.double().abs().max()), 1e-30)
    _, jnorm = jopt.clip_by_global_norm(jgrads, 1.0)
    _, norm = optim.clip_by_global_norm(list(grads), 1.0)
    assert float(norm) == pytest.approx(float(jnorm),
                                        rel=TOL[compute_dtype])


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-370m",
                                  "recurrentgemma-9b"])
def test_remat_changes_no_gradient(arch):
    """Each full repetition rematerialised (``cfg.remat``, the default) or
    not: the same loss and gradients, bit for bit."""
    _, cfg, _, tp, batch = _setup(arch, "float32")
    assert cfg.remat
    on = _port_grads(cfg, tp, batch)
    off = _port_grads(dataclasses.replace(cfg, remat=False), tp, batch)
    assert torch.equal(on[0], off[0])
    for a, b in zip(on[1], off[1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_train_loss_decreases(arch):
    """A few steps on the structured synthetic stream reduce the loss
    (``tests/test_arch_smoke.py::test_train_loss_decreases``, on the
    port)."""
    cfg = ARCHS[arch].reduced()
    stream = SyntheticLM(BatchSpec(2, 32, cfg.vocab_size), seed=1)
    params = T.init_params(torch.Generator().manual_seed(1), cfg, "cpu")
    opt = optim.make_optimizer(cfg.optimizer, lr=3e-3, warmup=1, total=50)
    opt_state = opt.init(params, cfg)
    step = train.make_train_step(cfg, opt)
    losses = []
    for i in range(8):
        params, opt_state, m = step(params, opt_state,
                                    shard_batch(stream.batch_at(i % 2),
                                                "cpu"))
        assert torch.isfinite(m["loss"]) and torch.isfinite(m["grad_norm"])
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses
    ev = train.make_eval_step(cfg)(params, shard_batch(stream.batch_at(0),
                                                       "cpu"))
    assert torch.isfinite(ev["loss"]) and not ev["loss"].requires_grad
