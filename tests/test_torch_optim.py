"""The port's optimizers and gradient compression on the CPU against the
JAX package's, on the same numpy parameters and gradients.

The JAX parameters come from ``repro.models.transformer.init_params`` and
are carried over with ``convert.params_from_jax``, gradients likewise, so
the JAX package's stacked leaves (each pattern slot over the full
repetitions) meet the port's per-layer leaves.  Three steps of AdamW and
of Adafactor agree leaf by leaf to 1e-6 of the leaf's largest magnitude:
float32 arithmetic in the same order, with the reference's decisions by
the rank of a stacked leaf (mamba2's ``A_log`` and ``D_skip`` decayed in
full repetitions, not in a remainder layer; Adafactor's moments factored
and its RMS clip taken over the repetitions).  The schedule and the
global-norm clip agree to the same; int8 quantisation gives the JAX
package's integers, top-k its entries.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.configs import ARCHS as JAX_ARCHS
from repro.models import transformer as JT
from repro_torch import optim
from repro_torch.configs import ARCHS
from repro_torch.models import convert
from repro_torch.models import transformer as T

TOL = 1e-6
# (arch, overrides): mamba2 with one full repetition of a 2-block pattern
# and a remainder layer; qwen2 (QKV biases, 2 repetitions); the MoE
# experts' 3-D leaves
CONFIGS = [("mamba2-370m", dict(n_layers=3, pattern=("ssd", "ssd"))),
           ("qwen2-1.5b", {}), ("qwen3-moe-30b-a3b", {})]


def _setup(arch, over):
    jcfg = JAX_ARCHS[arch].reduced(**over)
    cfg = ARCHS[arch].reduced(**over)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(4)
    # perturb the parameters so that no leaf is all zeros
    jp = jax.tree.map(lambda a: a + 0.05 * rng.standard_normal(a.shape)
                      .astype(a.dtype), jp)
    grads = [jax.tree.map(lambda a: rng.standard_normal(a.shape)
                          .astype(np.float32), jp) for _ in range(3)]
    return jcfg, cfg, jp, grads


def _port(tree, cfg):
    return convert.params_from_jax(jax.tree.map(np.asarray, tree), cfg,
                                   "cpu")


def _assert_leaves_close(got, want, tol=TOL):
    gl, wl = T.tree_leaves(got), T.tree_leaves(want)
    assert len(gl) == len(wl)
    for g, w in zip(gl, wl):
        assert g.shape == w.shape and g.dtype == w.dtype
        err = float((g.double() - w.double()).abs().max())
        assert err <= tol * max(float(w.abs().max()), 1e-30), err


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch,over", CONFIGS,
                         ids=[a for a, _ in CONFIGS])
def test_optimizer_matches_jax(arch, over, name):
    jcfg, cfg, jp, grads = _setup(arch, over)
    jo = jopt.make_optimizer(name, lr=3e-3, warmup=2, total=10)
    po = optim.make_optimizer(name, lr=3e-3, warmup=2, total=10)
    tp = _port(jp, cfg)
    js, ps = jo.init(jp), po.init(tp, cfg)
    update = jax.jit(jo.update)
    for g in grads:
        jp, js = update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ps = po.update(_port(g, cfg), ps, tp)
    assert ps["step"] == 3
    _assert_leaves_close(tp, _port(jp, cfg))


def test_adamw_decays_stacked_vectors_only_in_full_repetitions():
    """The reference's quirk, kept: one AdamW step with zero gradients
    moves mamba2's ``A_log`` and ``D_skip`` (matrices once stacked) in the
    full repetition's layers and leaves the remainder layer's alone."""
    _, cfg, jp, _ = _setup(*CONFIGS[0])
    tp = _port(jp, cfg)
    before = T.tree_map(torch.clone, tp)
    po = optim.make_optimizer("adamw", lr=1e-2, warmup=0, total=10)
    tp, _ = po.update(T.tree_map(torch.zeros_like, tp), po.init(tp, cfg), tp)
    layers, old = tp["stack"]["layers"], before["stack"]["layers"]
    for name in ("A_log", "D_skip", "dt_bias"):
        for full in (0, 1):
            assert not torch.equal(layers[full]["ssd"][name],
                                   old[full]["ssd"][name])
        assert torch.equal(layers[2]["ssd"][name], old[2]["ssd"][name])
    assert not torch.equal(layers[2]["ssd"]["w_in"], old[2]["ssd"]["w_in"])


def test_stacked_groups_need_the_config():
    cfg = ARCHS["qwen2-1.5b"].reduced()
    params = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    with pytest.raises(ValueError, match="config"):
        optim.make_optimizer("adamw").init(params)
    groups = optim.stacked_groups(params, cfg)
    leaves = T.tree_leaves(params)
    assert sorted(i for idx, _ in groups for i in idx) == \
        list(range(len(leaves)))
    stacked = [idx for idx, s in groups if s]
    assert stacked and all(len(idx) == cfg.n_layers for idx in stacked)
    assert optim.stacked_groups({"w": torch.zeros(2)}) == [((0,), False)]


def test_schedule_and_clip_match_jax():
    jl, pl = (m.cosine_schedule(3e-4, 7, 50) for m in (jopt, optim))
    for step in range(0, 60, 3):
        assert float(pl(step)) == pytest.approx(float(jl(step)), rel=TOL,
                                                abs=1e-12)
    _, cfg, jp, grads = _setup(*CONFIGS[1])
    for max_norm in (1.0, 1e3):
        jg, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray,
                                                       grads[0]), max_norm)
        pg, pn = optim.clip_by_global_norm(_port(grads[0], cfg), max_norm)
        assert float(pn) == pytest.approx(float(jn), rel=TOL)
        _assert_leaves_close(pg, _port(jg, cfg))


def test_compression_matches_jax():
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((3, 1500)) * np.exp(rng.uniform(-3, 3, (3, 1))
                                                  )).astype(np.float32)
    jq, js = jopt.quantize_int8(jnp.asarray(x))
    pq, ps = optim.quantize_int8(torch.from_numpy(x))
    assert pq.dtype == torch.int8 and np.array_equal(pq.numpy(),
                                                     np.asarray(jq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    deq = optim.dequantize_int8(pq, ps, x.shape, torch.float32)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(
        jopt.dequantize_int8(jq, js, x.shape, jnp.float32)))
    err = rng.standard_normal(x.shape).astype(np.float32) * 1e-3
    jc = jopt.compress_with_feedback(jnp.asarray(x), jnp.asarray(err))
    pc = optim.compress_with_feedback(torch.from_numpy(x),
                                      torch.from_numpy(err))
    for a, b in zip(pc, jc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jv, ji = jopt.topk_sparsify(jnp.asarray(x), frac=0.02)
    pv, pi = optim.topk_sparsify(torch.from_numpy(x), frac=0.02)
    assert np.array_equal(np.sort(pi.numpy()), np.sort(np.asarray(ji)))
    np.testing.assert_array_equal(pv.numpy()[np.argsort(pi.numpy())],
                                  np.asarray(jv)[np.argsort(np.asarray(ji))])
    dense = optim.topk_densify(pv, pi, x.shape, torch.float32)
    np.testing.assert_array_equal(dense.numpy(), np.asarray(
        jopt.topk_densify(jv, ji, x.shape, jnp.float32)))
    zeros = optim.init_error_feedback({"a": torch.ones(2, 3)})
    assert torch.equal(zeros["a"], torch.zeros(2, 3))
