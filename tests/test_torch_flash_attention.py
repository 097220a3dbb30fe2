"""The port's flash attention on the CPU against the JAX package.

``repro_torch.kernels.flash_attention`` holds the plain version
``reference_attention`` and the wrapper ``flash_attention``, which takes the
plain version for CPU tensors.  Both are held against the JAX oracle
``ref.reference_attention`` and against the Pallas kernel in interpret mode
(``ops.flash_attention``), on the same numpy inputs, at the shapes and
tolerances of ``tests/test_kernels.py``: 2e-4 in float32, 6e-2 in bf16
(absolute and relative; bf16 keeps 8 bits of mantissa, and the two sides
round the output once each after sums taken in other orders).
"""
from __future__ import annotations

import importlib

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref

# the module (the package's ``flash_attention`` is the wrapper)
fa = importlib.import_module("repro_torch.kernels.flash_attention")

TOL = {"float32": 2e-4, "bfloat16": 6e-2}
CASES = [
    (2, 128, 128, 4, 2, 64, True, None, None),
    (1, 200, 200, 8, 1, 64, True, None, 50.0),  # MQA + softcap + ragged
    (2, 256, 256, 4, 4, 128, True, 64, None),  # sliding window
    (1, 64, 256, 2, 2, 64, False, None, None),  # cross attention
    (1, 96, 96, 6, 3, 32, True, 32, 30.0),  # everything + tiny head
]


def _inputs(seed, B, Sq, Sk, Hq, Hkv, hd, dtype):
    """The same values for both packages: drawn in float64, rounded once to
    ``dtype`` with numpy (bf16 through ml_dtypes)."""
    rng = np.random.default_rng(seed)
    np_dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    return [rng.standard_normal(s).astype(np_dt)
            for s in ((B, Sq, Hq, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd))]


def _torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _f32(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,hd,causal,window,softcap", CASES)
def test_matches_jax_oracle_and_pallas(B, Sq, Sk, Hq, Hkv, hd, causal, window,
                                       softcap, dtype):
    q, k, v = _inputs(Sq + hd, B, Sq, Sk, Hq, Hkv, hd, dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want_ref = ref.reference_attention(*map(jnp.asarray, (q, k, v)), **kw)
    want_pallas = ops.flash_attention(*map(jnp.asarray, (q, k, v)), **kw,
                                      block_q=64, block_k=64)
    plain = fa.reference_attention(*map(_torch, (q, k, v)), **kw)
    before = fa.launch_count
    wrapped = fa.flash_attention(*map(_torch, (q, k, v)), **kw)
    assert fa.launch_count == before  # the CPU takes the plain version
    assert plain.dtype == wrapped.dtype == getattr(torch, dtype)
    assert torch.equal(plain, wrapped)
    for want in (want_ref, want_pallas):
        np.testing.assert_allclose(_f32(plain), _f32(want), atol=TOL[dtype],
                                   rtol=TOL[dtype])


@pytest.mark.parametrize("seed", range(5))
def test_randomised_shapes_match_jax_oracle(seed):
    """The randomised shapes of ``test_flash_attention_property`` (GQA
    divisibility respected), float32 at 2e-4."""
    rng = np.random.default_rng(seed)
    hd = int(rng.choice([32, 64, 128]))
    Hkv = int(rng.choice([1, 2, 4]))
    G = int(rng.choice([1, 2, 4]))
    Sq = int(rng.integers(16, 200))
    q, k, v = _inputs(seed, 1, Sq, Sq, Hkv * G, Hkv, hd, "float32")
    got = fa.flash_attention(*map(_torch, (q, k, v)))
    want = ref.reference_attention(*map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-4, rtol=2e-4)


def test_fully_masked_rows_average_v_like_the_oracle():
    """A window that leaves some query rows no key at all: those rows take
    the softmax of equal scores (-1e30 everywhere), the mean of v."""
    q, k, v = _inputs(7, 1, 48, 16, 2, 1, 32, "float32")
    kw = dict(causal=False, window=8)
    got = fa.flash_attention(*map(_torch, (q, k, v)), **kw)
    want = ref.reference_attention(*map(jnp.asarray, (q, k, v)), **kw)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(_f32(got)[0, -1, 0], v[0, :, 0].mean(axis=0),
                               atol=2e-4, rtol=2e-4)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros((1, 8, 3, 32))
    kv = torch.zeros((1, 8, 2, 32))
    with pytest.raises(ValueError, match="evenly"):
        fa.flash_attention(q, kv, kv)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q[:, :, :2], kv, kv, window=0)
    with pytest.raises(ValueError, match="head width"):
        fa.flash_attention(q[..., :16], kv, kv)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention(*(torch.empty((1, 8, 2, 32), device="meta"),) * 3)
