"""The port's expert matmul and MoE FFN on the CPU, against the JAX package.

``repro_torch.kernels.moe_gmm`` holds the plain version
``reference_expert_matmul`` and the wrapper ``expert_matmul`` (the plain
version for CPU tensors).  They are held against the JAX oracle
``ref.reference_expert_matmul`` and the Pallas kernel in interpret mode, at
the shapes and tolerances of ``tests/test_kernels.py`` (8 x 2e-4 in float32,
8 x 6e-2 in bf16, absolute and relative).

``repro_torch.models.layers.moe_ffn`` is held against the JAX package's
``moe_ffn`` on the same inputs and weights: the routing (recomputed from
layers.py:400-419 on the JAX side by ``test_torch_models.jax_route``) picks
the same experts in the same slots and keeps the same slots, the output
agrees to 1e-5 of its largest magnitude
in float32 compute and to 2e-2 in bf16 (the one-block bound of
``tests/test_torch_models.py``), and so does the load-balance loss.  Two
cases stress the dispatch: 2 x MOE_GROUP tokens, so that the groups fold
into the kernel's buffer axis, and capacity factor 0.5, so that slots are
dropped.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.kernels import ops as jops
from repro.kernels import ref
from repro.models import layers as JL
from repro_torch.configs import ARCHS
from repro_torch.kernels import moe_gmm, ops
from repro_torch.models import layers as L
from test_torch_flash_attention import _spy
from test_torch_models import jax_route

TOL = {"float32": 2e-4, "bfloat16": 6e-2}  # tests/test_kernels.py
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SHAPES = [(4, 64, 96, 80, "none"), (2, 128, 256, 128, "silu"),
          (8, 40, 72, 200, "gelu")]


def _operands(seed, E, C, D, F, dtype):
    rng = np.random.default_rng(seed)
    jdt, tdt = DTYPES[dtype]
    x = jnp.asarray(rng.standard_normal((E, C, D)), jdt)
    w = jnp.asarray(rng.standard_normal((E, D, F)), jdt) * 0.1
    return (x, w), tuple(torch.from_numpy(np.array(a, np.float32)).to(tdt)
                         for a in (x, w))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,C,D,F,act", SHAPES)
def test_expert_matmul_matches_jax_oracle_and_pallas(E, C, D, F, act, dtype,
                                                    monkeypatch):
    (jx, jw), (x, w) = _operands(E + C + D, E, C, D, F, dtype)
    plain = _spy(monkeypatch, moe_gmm, "reference_expert_matmul")
    before = moe_gmm.launch_count
    got = ops.expert_matmul(x, w, act)
    assert moe_gmm.launch_count == before  # the CPU takes the plain version
    assert len(plain) == 1 and got is plain[0]
    assert got.dtype == x.dtype and got.shape == (E, C, F)
    tol = 8 * TOL[dtype]
    for want in (ref.reference_expert_matmul(jx, jw, activation=act),
                 jops.expert_matmul(jx, jw, activation=act, block_c=32,
                                    block_f=64, block_d=64)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=tol,
                                   rtol=tol)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((2, 4, 8))
    with pytest.raises(ValueError, match="activation"):
        moe_gmm.expert_matmul(x, torch.zeros((2, 8, 3)), "relu")
    with pytest.raises(ValueError, match=r"\(E, D, F\)"):
        moe_gmm.expert_matmul(x, torch.zeros((2, 7, 3)))
    with pytest.raises(ValueError, match=r"\(E, D, F\)"):
        moe_gmm.expert_matmul(x, torch.zeros((3, 8, 3)))
    with pytest.raises(ValueError, match="devices"):
        moe_gmm.expert_matmul(x, torch.zeros((2, 8, 3), device="meta"))


@pytest.mark.parametrize("activation", ["none", "silu", "gelu"])
@pytest.mark.parametrize("E,C,D,F", [(3, 70, 50, 33), (2, 5, 72, 200),
                                     (1, 4, 1, 1), (2, 9, 13, 8),
                                     (2, 6, 16, 100)])
def test_padded_operands_give_the_unpadded_product(E, C, D, F, activation):
    """The kernel takes D and F in multiples of TMA_ELEMS; pad_operands pads
    a ragged D or F with zeros.  The padded product, sliced back to F
    columns, is the unpadded product.  The operands are small integers, so
    every fp32 sum is exact and the order of the sums cannot matter: the two
    are compared with ==."""
    rng = np.random.default_rng(E + C + D + F)
    x = torch.from_numpy(rng.integers(-4, 5, (E, C, D)).astype(np.float32)
                         ).to(torch.bfloat16)
    w = torch.from_numpy(rng.integers(-4, 5, (E, D, F)).astype(np.float32)
                         ).to(torch.bfloat16)
    xp, wp = moe_gmm.pad_operands(x, w)
    Dp, Fp = -(-D // moe_gmm.TMA_ELEMS) * moe_gmm.TMA_ELEMS, \
        -(-F // moe_gmm.TMA_ELEMS) * moe_gmm.TMA_ELEMS
    assert xp.shape == (E, C, Dp) and wp.shape == (E, Dp, Fp)
    assert torch.equal(xp[..., :D], x) and not xp[..., D:].any()
    assert torch.equal(wp[:, :D, :F], w) and not wp[:, D:].any() \
        and not wp[..., F:].any()
    if (Dp, Fp) == (D, F):
        assert xp is x and wp is w  # nothing to pad, nothing copied
    got = moe_gmm.reference_expert_matmul(xp, wp, activation=activation)
    assert torch.equal(got[..., :F], moe_gmm.reference_expert_matmul(
        x, w, activation=activation))


def _moe_case(compute_dtype, T, capacity_factor, seed=0):
    over = dict(compute_dtype=compute_dtype, capacity_factor=capacity_factor)
    jcfg = JAX_ARCHS["qwen3-moe-30b-a3b"].reduced(**over)
    cfg = ARCHS["qwen3-moe-30b-a3b"].reduced(**over)
    rng = np.random.default_rng(seed)
    D, E, Fm = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    p = {"router": rng.standard_normal((D, E)) / D ** 0.5,
         "w_gate": rng.standard_normal((E, D, Fm)) / D ** 0.5,
         "w_up": rng.standard_normal((E, D, Fm)) / D ** 0.5,
         "w_down": rng.standard_normal((E, Fm, D)) / Fm ** 0.5}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, T // 2, D)).astype(np.float32)
    jdt, tdt = DTYPES[compute_dtype]
    jx = jnp.asarray(x).astype(jdt)
    tx = torch.from_numpy(np.array(jx, np.float32)).to(tdt)
    return (jcfg, {k: jnp.asarray(v) for k, v in p.items()}, jx), \
        (cfg, {k: torch.from_numpy(v) for k, v in p.items()}, tx)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,capacity_factor", [(32, 1.25),
                                               (2 * L.MOE_GROUP, 1.25),
                                               (64, 0.5)],
                         ids=["one-group", "two-groups", "drops"])
def test_moe_ffn_matches_jax(T, capacity_factor, compute_dtype, monkeypatch):
    (jcfg, jp, jx), (cfg, tp, tx) = _moe_case(compute_dtype, T,
                                              capacity_factor)
    routes = []
    route = L.moe_route

    def record(router, cfg_, toks):
        routes.append(route(router, cfg_, toks))
        return routes[-1]

    monkeypatch.setattr(L, "moe_route", record)
    want, aux_j = JL.moe_ffn(jp, jcfg, jx)
    got, aux = L.moe_ffn(tp, cfg, tx)
    assert got.dtype == tx.dtype and got.shape == tx.shape

    (r,) = routes
    logits, idx, keep = map(np.asarray, jax_route(jp["router"], jcfg, jx))
    G = max(1, T // L.MOE_GROUP)
    assert r.idx.shape == (G, T // G, cfg.moe_top_k)
    np.testing.assert_array_equal(r.idx.numpy(), idx)  # the same picks
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_allclose(r.logits.numpy(), logits, rtol=1e-5,
                               atol=1e-5)
    if capacity_factor < 1:
        assert not keep.all() and (~keep).all(axis=-1).any()
        dropped = (~keep).all(axis=-1).reshape(-1)
        assert not got.reshape(T, -1)[torch.from_numpy(dropped)].any()
    tol = 1e-5 if compute_dtype == "float32" else 2e-2
    w = np.asarray(jnp.asarray(want, jnp.float32))
    err = np.abs(got.float().numpy() - w).max() / np.abs(w).max()
    assert err < tol
    assert abs(float(aux) - float(aux_j)) <= 1e-5 * float(aux_j)


def test_route_breaks_ties_as_lax_top_k():
    """Equal probabilities: the lower expert index first, as lax.top_k."""
    cfg = ARCHS["qwen3-moe-30b-a3b"].reduced(n_experts=8, moe_top_k=4)
    toks = torch.zeros((1, 3, cfg.d_model))
    router = torch.zeros((cfg.d_model, 8))
    router[0, [1, 4, 6]] = 1.0
    toks[0, 1, 0] = 1.0  # token 1: experts 1, 4, 6 tie above the rest
    r = L.moe_route(router, cfg, toks)
    _, want = jax.lax.top_k(jax.nn.softmax(jnp.asarray(
        (toks @ router).numpy()), axis=-1), 4)
    np.testing.assert_array_equal(r.idx.numpy(), np.asarray(want))
    assert r.idx[0, 1].tolist() == [1, 4, 6, 0]
    assert r.idx[0, 0].tolist() == [0, 1, 2, 3]


def test_routing_agreement_counts_flips_and_near_ties():
    """Three tokens, top-2 of 4 experts, the reference's logits beside
    another run's.  Token 0 swaps its two slots: two flips, the same
    experts, so it agrees.  Token 1 is the same.  Token 2 picks expert 2
    where the reference picks 1, whose logits are 0.01 apart around the
    reference's cut (halfway between 1.0 and 0.99): a near tie, 0.005 from
    the cut over the largest |logit| 3.  Token 2 diverges."""
    want_logits = torch.tensor([[3.0, 2.0, 0.0, -1.0], [0.0, 1.0, 2.0, 3.0],
                                [2.0, 1.0, 0.99, 0.0]])
    keep = torch.ones((3, 2), dtype=torch.bool)
    want = (want_logits, torch.tensor([[0, 1], [3, 2], [0, 1]]), keep)
    got = (want_logits + torch.tensor([0.0, 0.0, 0.02, 0.0]),
           torch.tensor([[1, 0], [3, 2], [0, 2]]), keep)
    ra = L.routing_agreement([got], [want])
    assert (ra.picks, ra.flips, ra.diverged) == (6, 3, 1)
    assert ra.agree.tolist() == [True, True, False]
    assert ra.worst_gap == pytest.approx(0.005 / 3.0)
    assert ra.flips_are_near_ties(2e-2)
    far = (got[0], torch.tensor([[0, 1], [3, 2], [0, 3]]), keep)
    assert not L.routing_agreement([far], [want]).flips_are_near_ties(2e-2)
    # a capacity drop on one side only: the token diverges, no gap
    dropped = (want_logits, want[1], torch.tensor([[True, False], [True,
                                                   True], [True, True]]))
    ra = L.routing_agreement([dropped], [want])
    assert ra.agree.tolist() == [False, True, True] and ra.worst_gap == 0.0
    # a token that diverged at layer 1 is not measured again at layer 2
    # (there expert 3 would lie 10.995 from the cut, of a largest |logit| 10)
    far_ref = want_logits.clone()
    far_ref[2, 3] = -10.0
    ra = L.routing_agreement([far, far], [want, (far_ref, *want[1:])])
    assert ra.worst_gap == pytest.approx(0.995 / 3.0)
