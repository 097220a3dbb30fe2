"""The port's SSD intra-chunk terms and composed SSD forward on the CPU,
against the JAX package.

``repro_torch.kernels.ssd`` holds the plain version
``reference_ssd_intra_chunk`` and the wrapper ``ssd_intra_chunk`` (the plain
version for CPU tensors); ``repro_torch.kernels.ops.ssd_forward`` composes it
with the inter-chunk recurrence.  They are held against the JAX oracle
``ref.reference_ssd_intra_chunk``, the Pallas kernel in interpret mode, the
JAX ``ops.ssd_forward`` and the model's own ``layers._ssd_chunked`` (which
takes ``-A``), on the same numpy inputs, at the tolerances of
``tests/test_kernels.py``: 1e-4 absolute and relative (1e-5 for the decay
``exp(cum)``); float32 sums taken in other orders.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref
from repro.models.layers import _ssd_chunked
from repro_torch.kernels import ops, ssd

SHAPES = [(2, 128, 4, 32, 16, 32), (1, 256, 2, 64, 128, 64)]


def _chunked(seed, B, S, H, P, N, Q):
    rng = np.random.default_rng(seed)
    nc = S // Q
    f32 = np.float32
    return (rng.standard_normal((B, nc, H, Q, P)).astype(f32),
            (rng.standard_normal((B, nc, Q, N)) * 0.3).astype(f32),
            (rng.standard_normal((B, nc, Q, N)) * 0.3).astype(f32),
            rng.uniform(0.01, 0.2, (B, nc, H, Q)).astype(f32),
            rng.uniform(0.5, 4.0, (H,)).astype(f32))


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("B,S,H,P,N,Q", SHAPES)
def test_intra_chunk_matches_jax_oracle_and_pallas(B, S, H, P, N, Q):
    args = _chunked(S + N, B, S, H, P, N, Q)
    before = ssd.launch_count
    got = ssd.ssd_intra_chunk(*map(torch.from_numpy, args))
    assert ssd.launch_count == before  # the CPU takes the plain version
    plain = ssd.reference_ssd_intra_chunk(*map(torch.from_numpy, args))
    for g, p in zip(got, plain):
        assert g.dtype == torch.float32 and torch.equal(g, p)
    for want in (ref.reference_ssd_intra_chunk(*map(jnp.asarray, args)),
                 jops.ssd_intra_chunk(*map(jnp.asarray, args))):
        (y, hc, dec), (ye, hce, dece) = got, want
        assert hc.shape == (B, S // Q, H, N, P)
        _close(y, ye, 1e-4)
        _close(hc, hce, 1e-4)
        _close(dec, dece, 1e-5)


@pytest.mark.parametrize("B,S,H,P,N,Q", SHAPES)
def test_plain_version_in_float64_is_a_witness_of_the_jax_oracle(B, S, H, P,
                                                                 N, Q):
    """``dtype=torch.float64`` computes the same terms in float64 (the
    witness chip_smoke.py holds the kernel to): within the float32 oracle's
    tolerance of it, and in float64 throughout."""
    args = _chunked(S + N + 1, B, S, H, P, N, Q)
    got = ssd.reference_ssd_intra_chunk(*map(torch.from_numpy, args),
                                        dtype=torch.float64)
    want = ref.reference_ssd_intra_chunk(*map(jnp.asarray, args))
    for g, w, tol in zip(got, want, (1e-4, 1e-4, 1e-5)):
        assert g.dtype == torch.float64
        _close(g, w, tol)


def _sequence(seed, B, S, H, P, N):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.standard_normal((B, S, H, P)).astype(f32),
            rng.uniform(0.01, 0.2, (B, S, H)).astype(f32),
            rng.uniform(0.5, 4.0, (H,)).astype(f32),
            (rng.standard_normal((B, S, N)) * 0.3).astype(f32),
            (rng.standard_normal((B, S, N)) * 0.3).astype(f32))


@pytest.mark.parametrize("B,S,H,P,N,Q", SHAPES + [(2, 64, 3, 16, 16, 16)])
def test_ssd_forward_matches_jax_forward_and_model_layer(B, S, H, P, N, Q):
    x, dt, A, Bm, Cm = _sequence(S + P, B, S, H, P, N)
    y, h = ops.ssd_forward(*map(torch.from_numpy, (x, dt, A, Bm, Cm)),
                           chunk=Q)
    assert y.shape == (B, S, H, P) and h.shape == (B, H, P, N)
    j = list(map(jnp.asarray, (x, dt, A, Bm, Cm)))
    y_k, h_k = jops.ssd_forward(*j, chunk=Q)
    y_m, h_m = _ssd_chunked(j[0], j[1], -j[2], j[3], j[4], None, chunk=Q)
    for yw, hw in ((y_k, h_k), (y_m, h_m)):
        _close(y, yw, 1e-4)
        _close(h, hw, 1e-4)


def test_ssd_forward_carries_an_initial_state():
    x, dt, A, Bm, Cm = _sequence(3, 1, 64, 2, 16, 8)
    h0 = np.random.default_rng(4).standard_normal((1, 2, 16, 8)).astype(
        np.float32)
    y, h = ops.ssd_forward(*map(torch.from_numpy, (x, dt, A, Bm, Cm, h0)),
                           chunk=16)
    j = list(map(jnp.asarray, (x, dt, A, Bm, Cm)))
    y_m, h_m = _ssd_chunked(j[0], j[1], -j[2], j[3], j[4], jnp.asarray(h0),
                            chunk=16)
    _close(y, y_m, 1e-4)
    _close(h, h_m, 1e-4)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x, Bm, Cm, dt, A = map(torch.from_numpy, _chunked(0, 1, 64, 2, 16, 8, 32))
    with pytest.raises(ValueError, match="B and C"):
        ssd.ssd_intra_chunk(x, Bm[..., :-1, :], Cm, dt, A)
    with pytest.raises(ValueError, match="dt"):
        ssd.ssd_intra_chunk(x, Bm, Cm, dt, A[:1])
    with pytest.raises(ValueError, match="cuda or cpu"):
        ssd.ssd_intra_chunk(*(t.to("meta") for t in (x, Bm, Cm, dt, A)))
    with pytest.raises(ValueError, match="divide"):
        ops.ssd_forward(torch.zeros((1, 48, 2, 16)), torch.zeros((1, 48, 2)),
                        A, torch.zeros((1, 48, 8)), torch.zeros((1, 48, 8)),
                        chunk=32)


@pytest.mark.parametrize("B,S,H,P,N,Q", SHAPES + [(1, 100, 2, 16, 8, 100)])
def test_intra_chunk_gradients_match_jax_vjp(B, S, H, P, N, Q):
    """The backward's plain version (autograd through
    ``reference_ssd_intra_chunk``) and the wrapper ``ssd_intra_chunk_bwd``
    on the CPU, for cotangents of all three outputs, against ``jax.vjp`` of
    the JAX oracle: float32 at 1e-5 of each gradient's largest magnitude."""
    args = _chunked(S + N, B, S, H, P, N, Q)
    rng = np.random.default_rng(N)
    nc = S // Q
    cot = tuple(rng.standard_normal(s).astype(np.float32) for s in
                ((B, nc, H, Q, P), (B, nc, H, N, P), (B, nc, H, Q)))
    _, pull = jax.vjp(ref.reference_ssd_intra_chunk,
                      *map(jnp.asarray, args))
    want = pull(tuple(map(jnp.asarray, cot)))
    targs, tcot = map(torch.from_numpy, args), map(torch.from_numpy, cot)
    targs, tcot = list(targs), list(tcot)
    plain = ssd.reference_ssd_intra_chunk_bwd(*targs, *tcot)
    before = ssd.bwd_launch_count
    wrapped = ssd.ssd_intra_chunk_bwd(*targs, *tcot)
    assert ssd.bwd_launch_count == before
    for p, w, a, t in zip(plain, wrapped, want, targs):
        assert p.shape == t.shape and torch.equal(p, w)
        a = np.asarray(a)
        assert np.abs(p.numpy() - a).max() <= 1e-5 * np.abs(a).max()


def test_ssd_forward_gradients_reach_every_input():
    """Autograd through the composed ``ssd_forward`` (the intra-chunk plain
    version and the inter-chunk loop) gives every input a gradient, and
    the same as the JAX package's under ``jax.vjp``
    to 1e-5 of each gradient's largest magnitude: the JAX model's own
    ``_ssd_chunked`` (which takes ``-A``), since the Pallas kernel behind
    ``ops.ssd_forward`` has no VJP."""
    rng = np.random.default_rng(11)
    f32 = np.float32
    xh = rng.standard_normal((2, 64, 3, 16)).astype(f32)
    dtv = rng.uniform(0.01, 0.2, (2, 64, 3)).astype(f32)
    A = rng.uniform(0.5, 4.0, (3,)).astype(f32)
    Bm, Cm = (rng.standard_normal((2, 64, 8)).astype(f32) * 0.3
              for _ in range(2))
    gy = rng.standard_normal((2, 64, 3, 16)).astype(f32)
    _, pull = jax.vjp(lambda x, d, a, b, c: _ssd_chunked(
        x, d, -a, b, c, None, chunk=16)[0],
        *map(jnp.asarray, (xh, dtv, A, Bm, Cm)))
    want = pull(jnp.asarray(gy))
    leaves = [torch.from_numpy(a).requires_grad_() for a in
              (xh, dtv, A, Bm, Cm)]
    y, _ = ops.ssd_forward(*leaves, chunk=16)
    y.backward(torch.from_numpy(gy))
    for leaf, a in zip(leaves, want):
        a = np.asarray(a)
        assert np.abs(leaf.grad.numpy() - a).max() <= 1e-5 * np.abs(a).max()


def _tf32(v):
    """v rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero: the kernel's ``cvt.rna.tf32.f32``)."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(v):
    """v cut to TF32 as the tensor cores read an operand (its low 13 bits
    ignored)."""
    return (v.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _tc_mm(a, b, passes):
    """a @ b as the kernel's products compute it on the tensor cores, in
    float32: one TF32 pass (hi . hi), or three (lo . hi + hi . lo + hi . hi,
    hi = tf32(v), lo = v - hi)."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _emulated_bwd(x, Bm, Cm, dt, A, gy, ghc, gdec, *, passes, G=4):
    """The backward as ``csrc/ssd_bwd.cu`` arranges it, in torch float32:
    every product through ``_tc_mm``; dS summed over each group of G heads
    before the one product per group that gives its part of dB and of dC;
    the chunk-state term ``ghc (x o ed)^T`` summed into the group's dB part;
    the parts summed in group order; dcum from the key side's part and
    rowsum(M), its reverse cumsum, ddt and dA."""
    Bsz, nc, H, Q, P = x.shape
    a = -A
    cum = torch.cumsum(dt * a[None, None, :, None], dim=-1)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool))
    L = torch.exp((cum[..., :, None] - cum[..., None, :]).masked_fill(
        ~causal, float("-inf")))
    S = _tc_mm(Cm, Bm.transpose(-1, -2), passes)[:, :, None]  # once a group
    Gm = _tc_mm(gy, x.transpose(-1, -2), passes)
    dtk = dt[..., None, :]
    W = S * L * dtk
    dS = Gm * L * dtk
    M = Gm * W
    ed = torch.exp(cum[..., -1:] - cum) * dt
    dx = _tc_mm(W.transpose(-1, -2), gy, passes)
    u = _tc_mm(Bm[:, :, None], ghc, passes)  # (ghc^T B_k) per head
    dx = dx + ed[..., None] * u
    E = (u * x).sum(-1)
    state = _tc_mm(x * ed[..., None], ghc.transpose(-1, -2), passes)
    dB = dC = 0
    for g0 in range(0, H, G):
        dSg = dS[:, :, g0:g0 + G].sum(2)
        dB = dB + (_tc_mm(dSg.transpose(-1, -2), Cm, passes)
                   + state[:, :, g0:g0 + G].sum(2))
        dC = dC + _tc_mm(dSg, Bm, passes)
    eed = E * ed
    dcum = M.sum(-1) - M.sum(-2) + gdec * torch.exp(cum) - eed
    dcum[..., -1] += eed.sum(-1)
    da = torch.flip(torch.cumsum(torch.flip(dcum, [-1]), -1), [-1])
    ddt = ((Gm * S * L).sum(-2) + E * torch.exp(cum[..., -1:] - cum)
           - A[None, None, :, None] * da)
    dA = -(dt * da).sum((0, 1, 3))
    return dx, dB, dC, ddt, dA


@pytest.mark.parametrize("B,S,H,P,N,Q", SHAPES)
def test_tensor_core_arrangement_of_the_backward_matches(B, S, H, P, N, Q):
    """The backward kernel's arithmetic, emulated in torch (dS summed over a
    group's heads before dB and dC; operands split into TF32 hi and lo,
    three products), within SSD_BWD_TOL 1e-4 of each gradient's largest
    magnitude of the plain version and of ``jax.vjp`` of the JAX oracle.
    One TF32 pass alone is printed beside it: too coarse for that limit.
    It holds the design's error budget, not the kernel: the card-only
    cases of tests/test_torch_cuda.py hold ssd_bwd.cu itself."""
    args = _chunked(S + N + 2, B, S, H, P, N, Q)
    rng = np.random.default_rng(N + 1)
    nc = S // Q
    cot = tuple(rng.standard_normal(s).astype(np.float32) for s in
                ((B, nc, H, Q, P), (B, nc, H, N, P), (B, nc, H, Q)))
    targs = [torch.from_numpy(t) for t in args + cot]
    got = _emulated_bwd(*targs, passes=3)
    once = _emulated_bwd(*targs, passes=1)
    plain = ssd.reference_ssd_intra_chunk_bwd(*targs)
    _, pull = jax.vjp(ref.reference_ssd_intra_chunk,
                      *map(jnp.asarray, args))
    jaxs = pull(tuple(map(jnp.asarray, cot)))
    errors = []
    for name, g, o, p, j in zip(("dx", "dB", "dC", "ddt", "dA"), got, once,
                                plain, jaxs):
        j = torch.from_numpy(np.array(j))
        assert g.shape == p.shape and g.dtype == torch.float32
        scale = float(p.abs().max())
        err, err_1 = (float((t - p).abs().max()) / scale for t in (g, o))
        err_j = float((g - j).abs().max()) / float(j.abs().max())
        assert err <= 1e-4 and err_j <= 1e-4, (name, err, err_j)
        errors.append(f"{name} {err:.2e} (one pass {err_1:.2e})")
    print(f"3xTF32 emulation at {(B, S, H, P, N, Q)}: " + ", ".join(errors))
