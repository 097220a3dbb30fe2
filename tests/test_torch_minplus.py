"""Properties of the port's tropical (min-plus) product, held against the
JAX package.

``repro_torch.kernels.minplus.minplus_matmul`` takes its plain version
``minplus_reference`` on CPU tensors and launches the CUDA kernel on CUDA
tensors.  Here, on the CPU, the plain version is held with ``==`` against
the JAX oracle ``repro.kernels.ref.reference_minplus`` and the Pallas kernel
in interpret mode, in float64, on the same numpy inputs from a seed.  The
kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.minplus import minplus_matmul as pallas_minplus
from repro.kernels.ref import reference_minplus
from repro_torch.kernels import minplus as mp
from repro_torch.kernels.minplus import minplus_matmul, minplus_reference

INF = np.inf


@pytest.fixture
def jax_x64(monkeypatch):
    """The JAX package reaches ``jax.experimental.enable_x64``, which this
    JAX no longer has: alias it to ``jax.enable_x64`` for one test, then
    remove the alias and drop the reference's cached jitted scans, so that
    nothing of it reaches the reference's own tests in the same worker."""
    from repro.core import jax_solvers

    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)
    yield
    monkeypatch.undo()
    jax_solvers._jx.cache_clear()


def _rand(rng, shape, p_inf=0.2):
    """Cost-like matrix: non-negative floats with +inf holes."""
    x = rng.uniform(0.0, 10.0, size=shape)
    x[rng.uniform(size=shape) < p_inf] = INF
    return x


def _ties(rng, shape, p_inf=0.2):
    """Small integers, so that many sums tie."""
    x = rng.integers(0, 3, size=shape).astype(np.float64)
    x[rng.uniform(size=shape) < p_inf] = INF
    return x


def _np_minplus(a, b):
    """Independent numpy oracle: broadcast sum, min and first argmin."""
    cand = a[..., :, :, None] + b[..., None, :, :]
    return cand.min(axis=-2), cand.argmin(axis=-2).astype(np.int32)


def _mm(a, b):
    val, idx = minplus_matmul(torch.from_numpy(a), torch.from_numpy(b))
    assert val.dtype == torch.float64 and idx.dtype == torch.int32
    return val.numpy(), idx.numpy()


def _check_np(a, b):
    val, idx = _mm(a, b)
    rval, ridx = _np_minplus(a, b)
    np.testing.assert_array_equal(val, rval)
    np.testing.assert_array_equal(idx, ridx)


# Off-tile shapes: the Pallas kernel pads to (8, 128) tiles, the CUDA kernel
# to blocks of 256 threads; neither may leak into the result.
_SHAPES = [(1, 1, 1), (2, 3, 4), (8, 8, 8), (5, 128, 7), (9, 130, 3),
           (16, 16, 16), (1, 16, 16), (3, 17, 33)]


@pytest.mark.parametrize("m,k,n", _SHAPES)
def test_matches_numpy_oracle(m, k, n):
    rng = np.random.default_rng((m * 73856093 + k * 19349663 + n) % 2**32)
    _check_np(_rand(rng, (m, k)), _rand(rng, (k, n)))


@pytest.mark.parametrize("batch", [(1,), (3,), (2, 2)])
def test_batched_matches_numpy_oracle(batch):
    rng = np.random.default_rng(7)
    _check_np(_rand(rng, batch + (4, 6)), _rand(rng, batch + (6, 5)))


@pytest.mark.parametrize("make", [_rand, _ties], ids=["random", "ties"])
@pytest.mark.parametrize("shape", [((), 1, 1, 1), ((3,), 3, 17, 5),
                                   ((2, 2), 4, 6, 5), ((1,), 1, 4, 4),
                                   ((32,), 1, 8, 8), ((64,), 1, 16, 16)])
def test_matches_jax_reference_and_pallas(jax_x64, make, shape):
    """float64 ``==`` against the JAX oracle and the interpret-mode Pallas
    kernel, on the same numpy inputs."""
    batch, m, k, n = shape
    rng = np.random.default_rng(sum(shape[1:]) + len(batch))
    a, b = make(rng, batch + (m, k)), make(rng, batch + (k, n))
    val, idx = minplus_reference(torch.from_numpy(a), torch.from_numpy(b))
    with jax.enable_x64():
        rval, ridx = reference_minplus(jnp.asarray(a), jnp.asarray(b))
        pval, pidx = pallas_minplus(jnp.asarray(a), jnp.asarray(b),
                                    interpret=True)
        assert rval.dtype == jnp.float64 and pval.dtype == jnp.float64
    for want_val, want_idx in ((rval, ridx), (pval, pidx)):
        np.testing.assert_array_equal(val.numpy(), np.asarray(want_val))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))


def test_first_argmin_on_ties():
    a = np.array([[1.0, 1.0, 5.0]])
    b = np.array([[2.0], [2.0], [0.0]])
    val, idx = _mm(a, b)
    assert val[0, 0] == 3.0 and idx[0, 0] == 0


def test_inf_padding_absorbs():
    """Growing either operand with +inf rows/cols leaves the valid region
    as it was: the property the solvers' shape padding relies on."""
    rng = np.random.default_rng(11)
    a, b = _rand(rng, (5, 6)), _rand(rng, (6, 4))
    val, idx = _mm(a, b)
    vp, ip = _mm(np.pad(a, ((0, 3), (0, 10)), constant_values=INF),
                 np.pad(b, ((0, 10), (0, 5)), constant_values=INF))
    np.testing.assert_array_equal(vp[:5, :4], val)
    np.testing.assert_array_equal(ip[:5, :4], idx)


def test_all_inf_column_yields_index_zero():
    a = np.full((2, 3), INF)
    b = _rand(np.random.default_rng(3), (3, 2), p_inf=0.0)
    val, idx = _mm(a, b)
    assert np.all(np.isinf(val)) and np.all(idx == 0)


def test_associativity_of_values():
    """(A ∘ B) ∘ C == A ∘ (B ∘ C) on values, the tropical semiring law the
    multi-hop frontier composition depends on."""
    rng = np.random.default_rng(23)
    a, b, c = _rand(rng, (4, 5)), _rand(rng, (5, 6)), _rand(rng, (6, 3))
    left, _ = _mm(_mm(a, b)[0], c)
    right, _ = _mm(a, _mm(b, c)[0])
    np.testing.assert_allclose(left, right, rtol=1e-12, atol=0)


def test_shape_and_device_errors():
    z = torch.zeros
    with pytest.raises(ValueError, match="contraction"):
        minplus_matmul(z(2, 3, dtype=torch.float64), z(4, 2, dtype=torch.float64))
    with pytest.raises(ValueError, match="batch"):
        minplus_matmul(z(2, 2, 3, dtype=torch.float64),
                       z(3, 3, 2, dtype=torch.float64))
    with pytest.raises(ValueError, match="cuda or cpu"):
        minplus_matmul(torch.empty(1, 2, 2, device="meta"),
                       torch.empty(1, 2, 2, device="meta"))


def test_cpu_path_launches_nothing():
    before = mp.launch_count
    _mm(np.ones((1, 3, 4)), np.ones((1, 4, 2)))
    assert mp.launch_count == before


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A build that cannot run raises; it never falls back."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(mp, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc"):
        mp.build()


@pytest.mark.parametrize("fn", ["argmin", "min"])
def test_torch_argmin_is_first_occurrence_on_cpu(fn):
    """Pin (not assume) the tie rule the solvers rely on: the first minimum
    wins, and an all-+inf row gives index 0."""
    x = torch.tensor([[2.0, 1.0, 1.0, 3.0], [INF, INF, INF, INF],
                      [0.0, 0.0, 0.0, 0.0], [5.0, INF, 5.0, 4.0]],
                     dtype=torch.float64)
    idx = x.argmin(dim=1) if fn == "argmin" else x.min(dim=1).indices
    assert idx.tolist() == [1, 0, 0, 3]
    big = torch.zeros((4097,), dtype=torch.float64)  # a multi-chunk reduction
    assert int(big.argmin()) == 0
