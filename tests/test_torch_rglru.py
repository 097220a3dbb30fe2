"""The port's RG-LRU scan and block on the CPU, against the JAX package.

``repro_torch.kernels.rglru`` holds the plain version
``reference_rglru_scan`` (a doubling scan) and the wrapper ``rglru_scan``
(the plain version for CPU tensors).  They are held against the JAX oracle
``ref.reference_rglru_scan`` (an associative scan) and the Pallas kernel in
interpret mode (a sequential loop), at the shapes and the 1e-5 absolute and
relative tolerance of ``tests/test_kernels.py``: the three round the same
recurrence in other orders.  ``dtype=torch.float64`` gives the float64
witness ``chip_smoke.py`` holds the kernel to, checked here against a plain
sequential loop in float64.

``repro_torch.models.layers.rglru_block`` is held against the JAX package's
``rglru_block`` on the same inputs and weights: 1e-5 of the largest
magnitude in float32 compute, 2e-2 in bf16 (the one-block bound of
``tests/test_torch_models.py``).
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
from repro_torch.kernels import ops, rglru
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

SHAPES = [(2, 64, 128, 16, 64), (1, 100, 48, 32, 32), (3, 256, 512, 64, 256)]


def _operands(seed, B, S, W, low=0.7):
    rng = np.random.default_rng(seed)
    a = rng.uniform(low, 0.999, (B, S, W)).astype(np.float32)
    b = (rng.standard_normal((B, S, W)) * 0.1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("B,S,W,bs,bw", SHAPES)
def test_rglru_scan_matches_jax_oracle_and_pallas(B, S, W, bs, bw):
    a, b = _operands(S + W, B, S, W)
    before = rglru.launch_count
    got = ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(b))
    assert rglru.launch_count == before  # the CPU takes the plain version
    assert got.dtype == torch.float32 and got.shape == (B, S, W)
    for want in (ref.reference_rglru_scan(jnp.asarray(a), jnp.asarray(b)),
                 jops.rglru_scan(jnp.asarray(a), jnp.asarray(b), block_s=bs,
                                 block_w=bw)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("B,S,W", [(2, 64, 16), (1, 1000, 8), (1, 1, 4)])
def test_float64_witness_is_the_sequential_recurrence(B, S, W):
    """Decays up to 0.9999 (the long memory of a near-1 RG-LRU gate), a
    ragged S and a single step: the float64 doubling scan equals the
    float64 sequential loop to 1e-12, and the float32 one is within 1e-5."""
    a, b = _operands(S, B, S, W, low=0.99)
    a = np.minimum(a * 1.0001, 0.9999)
    h = np.zeros((B, W))
    seq = np.empty((B, S, W))
    for t in range(S):
        h = a[:, t].astype(np.float64) * h + b[:, t]
        seq[:, t] = h
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    wit = rglru.reference_rglru_scan(ta, tb, dtype=torch.float64)
    assert wit.dtype == torch.float64
    np.testing.assert_allclose(wit.numpy(), seq, atol=1e-12, rtol=1e-12)
    np.testing.assert_allclose(rglru.reference_rglru_scan(ta, tb).numpy(),
                               seq, atol=1e-5, rtol=1e-5)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    a = torch.zeros((1, 8, 4))
    with pytest.raises(ValueError, match="one shape"):
        rglru.rglru_scan(a, a[:, :7])
    with pytest.raises(ValueError, match=r"\(B, S, W\)"):
        rglru.rglru_scan(a[0], a[0])
    with pytest.raises(ValueError, match="devices"):
        rglru.rglru_scan(a, torch.zeros((1, 8, 4), device="meta"))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_rglru_block_matches_jax(compute_dtype):
    jcfg = JAX_ARCHS["recurrentgemma-9b"].reduced(compute_dtype=compute_dtype)
    cfg = ARCHS["recurrentgemma-9b"].reduced(compute_dtype=compute_dtype)
    jp = JL.init_rglru(jax.random.PRNGKey(3), jcfg)
    tp = T.tree_map(lambda a: torch.from_numpy(np.array(a)),
                     jax.tree.map(np.asarray, jp))
    assert tp["lam"].dtype == torch.float32
    x = np.random.default_rng(4).standard_normal((2, 48, cfg.d_model))
    jx = jnp.asarray(x, jnp.float32).astype(JL.cdt(jcfg))
    pos = np.broadcast_to(np.arange(48), (2, 48))
    want, _ = JL.rglru_block(jp, jcfg, jx, JL.Ctx(
        mode="prefill", positions=jnp.asarray(pos, jnp.int32)), None)
    got, cache = L.rglru_block(
        tp, cfg, torch.from_numpy(np.array(jx, np.float32)).to(L.cdt(cfg)),
        L.Ctx(mode="prefill", positions=torch.from_numpy(pos.copy())), None)
    assert cache is None and got.dtype == L.cdt(cfg)
    w = np.asarray(jnp.asarray(want, jnp.float32))
    err = np.abs(got.float().numpy() - w).max() / np.abs(w).max()
    assert err < (1e-5 if compute_dtype == "float32" else 2e-2)
