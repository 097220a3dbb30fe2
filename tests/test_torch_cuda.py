"""The port on the card: the CUDA min-plus (product and fused DFTS scan),
flash-attention, SSD, expert-matmul and RG-LRU kernels against their plain
versions, ``dfts_torch`` / ``bcd_torch`` on ``cuda`` against the NumPy
oracles, a planned chain of a reduced model through the kernels against
the same chain on the CPU, the serving engine's prefill and decode
steps on the card against the same on the CPU, the serving control plane
and the sweep engine on the card against the host's oracles.

Every test here is marked ``cuda`` and skips without a card.  The file
imports nothing of JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
from __future__ import annotations

import importlib
import json

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.core import torch_solvers as TS
from repro_torch.configs import ARCHS
from repro_torch.kernels import minplus as mp
from repro_torch.kernels import moe_gmm, ops, rglru
from repro_torch.kernels import ssd
from repro_torch.kernels.minplus import minplus_matmul, minplus_reference
from repro_torch.models import layers as ML
from repro_torch.models import transformer as MT
from repro_torch.msl import ChainSimulator, plan_pipeline
from repro_torch import serving as SV

# the module (the package's ``flash_attention`` is the wrapper)
fa = importlib.import_module("repro_torch.kernels.flash_attention")

INF = np.inf
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _costs(rng, shape, ties=False, p_inf=0.2):
    x = (rng.integers(0, 3, size=shape).astype(np.float64) if ties
         else rng.uniform(0.0, 10.0, size=shape))
    x[rng.uniform(size=shape) < p_inf] = INF
    return x


def test_torch_argmin_is_first_occurrence_on_cuda(cuda):
    """Pin the tie rule the solvers rely on, on the card: the first minimum
    wins, and an all-+inf row gives index 0."""
    x = torch.tensor([[2.0, 1.0, 1.0, 3.0], [INF, INF, INF, INF],
                      [0.0, 0.0, 0.0, 0.0], [5.0, INF, 5.0, 4.0]],
                     dtype=torch.float64, device=cuda)
    assert x.argmin(dim=1).tolist() == [1, 0, 0, 3]
    assert x.min(dim=1).indices.tolist() == [1, 0, 0, 3]
    assert x.T.argmin(dim=0).tolist() == [1, 0, 0, 3]
    big = torch.zeros((1 << 20,), dtype=torch.float64, device=cuda)
    assert int(big.argmin()) == 0


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("shape", [((), 1, 1, 1), ((2, 3), 3, 17, 33),
                                   ((5,), 33, 16, 17), ((1,), 1, 4, 4),
                                   ((1,), 1, 8, 8), ((512,), 1, 4, 4),
                                   ((512,), 1, 8, 8), ((1024,), 1, 16, 16)])
def test_kernel_matches_plain(cuda, ties, shape):
    batch, m, k, n = shape
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(_costs(rng, batch + (m, k), ties)).to(cuda)
    b = torch.from_numpy(_costs(rng, batch + (k, n), ties)).to(cuda)
    if m > 1:
        a[..., 0, :] = INF  # an all-+inf row: each of its outputs takes idx 0
    before = mp.launch_count
    val, idx = minplus_matmul(a, b)
    torch.cuda.synchronize()
    assert mp.launch_count == before + 1
    rval, ridx = minplus_reference(a, b)
    assert torch.equal(val, rval) and torch.equal(idx, ridx)


def test_kernel_rejects_what_it_does_not_take(cuda):
    a = torch.zeros((4, 3, 2), dtype=torch.float64, device=cuda)
    b = torch.zeros((4, 2, 3), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        minplus_matmul(a[:, :, :1], b[:, :1, :])
    with pytest.raises(TypeError, match="float64"):
        minplus_matmul(a.float(), b.float())
    with pytest.raises(ValueError, match="devices"):
        minplus_matmul(a, b.cpu())


# the fused scan: (N, K, S) with no step and one, S off a warp's tours, a
# full warp, the paths' shapes, a warp's operands past its stage in shared
# memory (K 8 at S 32: the block variant at S <= 32), past a warp (the block
# variant, 1,024 threads a tour at S 1500) and past 48 KB of shared memory a
# block (S 3500)
SCAN_SHAPES = [(1, 1, 4), (3, 1, 33), (1, 2, 4), (7, 2, 1), (5, 2, 7),
               (33, 3, 5), (1, 3, 8), (1, 5, 4), (1, 8, 8), (512, 3, 8),
               (512, 5, 4), (100, 3, 16), (9, 4, 32), (3, 8, 32), (65, 9, 32),
               (2, 3, 100), (1024, 5, 64), (2, 2, 1500), (1, 2, 3500)]


def _scan_operands(shape, ties, cuda, seed=0):
    """(comp, D, tail) on the card, with an all-+inf first tour where
    N > 1."""
    N, K, S = shape
    rng = np.random.default_rng(seed + N + K + S)
    comp, D, tail = (torch.from_numpy(_costs(rng, s, ties)).to(cuda)
                     for s in ((N, K, S), (N, K - 1, S, S), (N, S)))
    if N > 1:
        comp[0] = INF
    return comp, D, tail


def _same(got, want) -> bool:
    return all(g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)
               for g, w in zip(got, want))


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("shape", SCAN_SHAPES, ids=str)
def test_scan_kernel_matches_plain(cuda, ties, shape):
    ops = _scan_operands(shape, ties, cuda)
    before = mp.scan_launch_count
    got = mp.minplus_scan(*ops)
    torch.cuda.synchronize()
    assert mp.scan_launch_count == before + 1
    want = mp.minplus_scan_reference(*ops)
    assert _same(got, want)
    if shape[0] > 1:
        assert got[0][0] == INF and got[1][0] == 0


@pytest.mark.parametrize("shape", [(512, 5, 4), (64, 3, 100)], ids=str)
def test_scan_kernel_repeats_bit_for_bit(cuda, shape):
    ops = _scan_operands(shape, True, cuda, seed=1)
    first = mp.minplus_scan(*ops)
    second = mp.minplus_scan(*ops)
    torch.cuda.synchronize()
    assert _same(first, second)
    assert _same(first, mp.minplus_scan_reference(*ops))


def test_scan_kernel_rejects_what_it_does_not_take(cuda):
    comp, D, tail = _scan_operands((4, 3, 8), False, cuda)
    with pytest.raises(TypeError, match="float64"):
        mp.minplus_scan(comp.float(), D.float(), tail.float())
    with pytest.raises(ValueError, match="contiguous"):
        mp.minplus_scan(comp.transpose(0, 1).contiguous().transpose(0, 1),
                        D, tail)
    with pytest.raises(ValueError, match="devices"):
        mp.minplus_scan(comp, D.cpu(), tail)
    with pytest.raises(ValueError, match="out must be"):
        mp.minplus_scan(comp, D, tail, out=tuple(
            o.cpu() for o in mp.minplus_scan(comp, D, tail)))


def test_dfts_torch_on_cuda_lockstep_matches_numpy_oracle(cuda):
    """A mixed batch, sequential and pipelined (IF and TR, with 1, 2 or 6
    tours each, and the min-memory fallback at b 1024), in lockstep waves on
    the card: == dfts_np, each scan one launch."""
    problems = [_problem(mode, K, b, seed, schedule, M, per_stage)
                for mode, K, b, seed, schedule, M, per_stage in [
                    ("IF", 3, 8, 1, "seq", 1, 6), ("TR", 5, 128, 2, "seq", 1, 4),
                    ("TR", 3, 8, 1, "pipe", 4, 6), ("TR", 5, 8, 3, "pipe", 4, 4),
                    ("TR", 5, 128, 5, "pipe", 4, 4), ("IF", 3, 32, 0, "pipe", 4, 6),
                    ("IF", 5, 1024, 0, "seq", 1, 4),
                    ("TR", 5, 1024, 0, "pipe", 4, 4)]]
    scans = {"n": 0}
    scan = TS.minplus_scan

    def counting(*args, **kw):
        scans["n"] += 1
        return scan(*args, **kw)

    before = mp.scan_launch_count
    TS.minplus_scan = counting
    try:
        got = T.solve_batch(problems, "dfts_torch", dedup=False, min_batch=1)
    finally:
        TS.minplus_scan = scan
    assert mp.scan_launch_count - before == scans["n"] > 0
    for p, g in zip(problems, got):
        assert _plain(g) == _plain(T.solve(p, "dfts_np"))


def _problem(mode, K, b, seed, schedule="seq", M=1, per_stage=2):
    cands = T.candidate_sets(K, seed, T.NSFNET_NODES, T.SOURCE, T.DEST,
                             per_stage=per_stage)
    req = T.ServiceChainRequest("resnet101", T.SOURCE, T.DEST, batch_size=b,
                                mode=mode, schedule=schedule,
                                n_microbatches=M)
    return T.ProblemInstance(T.nsfnet(source=T.SOURCE),
                             T.resnet101_profile(), req, K, cands)


def _plain(out) -> tuple:
    if out.plan is None:
        return (False,)
    p, lb = out.plan, out.latency
    return (True, tuple(map(tuple, p.segments)), tuple(p.placement),
            tuple(map(tuple, p.paths)), tuple(p.tail_path),
            (lb.computation_s, lb.transmission_s, lb.propagation_s,
             lb.bubble_s))


def test_solvers_on_cuda_match_numpy_oracles(cuda):
    problems = [_problem("IF", 3, 2, 0), _problem("TR", 5, 128, 1, per_stage=4),
                _problem("IF", 3, 32, 0, "pipe", 4),
                _problem("TR", 3, 128, 0, "pipe", 4, per_stage=6)]
    before = mp.scan_launch_count
    dfts = T.solve_batch(problems, "dfts_torch", dedup=False, min_batch=1)
    bcd = T.solve_batch(problems, "bcd_torch", dedup=False, min_batch=1)
    assert mp.scan_launch_count > before
    for p, got_d, got_b in zip(problems, dfts, bcd):
        assert _plain(got_d) == _plain(T.solve(p, "dfts_np"))
        assert _plain(got_b) == _plain(T.solve(p, "bcd"))


# flash attention: the shapes of tests/test_kernels.py, the model path's
# (qwen2-1.5b and qwen3-moe-30b-a3b at B 2, S 2048; recurrentgemma-9b at
# B 1, S 4096 with its window), and at every head width the kernel's
# options and edges: causal, a window, a softcap, no causal mask with
# Sq != Skv, rows that see no key, and Sq and Skv off the kernel's 128-row
# query tile and 64-key tile; G = 8 and 16 at small S.  In bf16, the type
# the path gives the kernel.  The kernel rounds p to bf16 before P.V (as
# the JAX model's blocked_attention does) where the plain version keeps it
# fp32, and both round fp32 sums taken in other orders once to bf16: each
# (batch, query, head) row is held to 1e-2 of its own norm, and the largest
# error to 2**-6 of the largest magnitude (chip_smoke.py's FLASH_TOL, which
# rejects an output with l off by 5 % or with each row's diagonal key tile
# dropped).
FLASH_CASES = [
    (2, 128, 128, 4, 2, 64, True, None, None),
    (1, 200, 200, 8, 1, 64, True, None, 50.0),
    (2, 256, 256, 4, 4, 128, True, 64, None),
    (1, 64, 256, 2, 2, 64, False, None, None),
    (1, 96, 96, 6, 3, 32, True, 32, 30.0),
    (1, 48, 16, 2, 1, 32, False, 8, None),  # rows that see no key at all
    (2, 2048, 2048, 12, 2, 128, True, None, None),
    (1, 200, 200, 4, 1, 256, True, None, None),  # hd 256, ragged
    (1, 300, 300, 4, 2, 256, True, 128, None),   # hd 256 with a window
    (1, 4096, 4096, 16, 1, 256, True, 2048, None),  # recurrentgemma-9b's
    (2, 2048, 2048, 32, 4, 128, True, None, None),  # qwen3-moe-30b-a3b's
] + [case for hd in (32, 64, 128, 256) for case in (
    (1, 129, 129, 4, 2, hd, True, None, None),    # causal, ragged
    (1, 191, 191, 4, 1, hd, True, 64, None),      # a window, ragged
    (2, 130, 130, 2, 2, hd, True, None, 30.0),    # a softcap
    (1, 191, 300, 4, 2, hd, False, None, None),   # no causal mask, Sq != Skv
    (1, 300, 129, 2, 1, hd, True, 16, None),      # rows 144.. see no key
)] + [
    (1, 200, 200, 8, 1, 128, True, None, None),   # G = 8
    (1, 160, 160, 16, 1, 64, True, None, None),   # G = 16
    (1, 256, 256, 16, 1, 256, True, 128, None),   # G = 16 at hd 256
]


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,hd,causal,window,softcap",
                         FLASH_CASES)
def test_flash_attention_matches_plain(cuda, B, Sq, Sk, Hq, Hkv, hd, causal,
                                       window, softcap):
    gen = torch.Generator(device=cuda).manual_seed(Sq + hd)
    q, k, v = (torch.randn(s, generator=gen, device=cuda).to(torch.bfloat16)
               for s in ((B, Sq, Hq, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd)))
    kw = dict(causal=causal, window=window, softcap=softcap)
    before = fa.launch_count
    out = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.launch_count == before + 1
    want = fa.reference_attention(q, k, v, **kw)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    d, w = out.float() - want.float(), want.float()
    assert float((d.norm(dim=-1) / w.norm(dim=-1)).max()) < 1e-2
    assert float(d.abs().max()) <= 2.0 ** -6 * float(w.abs().max())


def test_flash_attention_rejects_what_it_does_not_take(cuda):
    q = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError, match="bf16"):
        fa.flash_attention(q.float(), q.float(), q.float())
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2), q.transpose(1, 2),
                           q.transpose(1, 2))
    for hd in (48, 512):
        x = torch.zeros((1, 8, 2, hd), dtype=torch.bfloat16, device=cuda)
        with pytest.raises(ValueError, match="head widths"):
            fa.flash_attention(x, x, x)
    with pytest.raises(ValueError, match="devices"):
        fa.flash_attention(q, q.cpu(), q)
    odd = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention(odd[1:].view(q.shape), q, q)


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,hd,causal,window", [
    (2, 2048, 2048, 12, 2, 128, True, None),
    (1, 4096, 4096, 16, 1, 256, True, 2048),
    (1, 191, 300, 4, 2, 32, False, None),
])
def test_flash_attention_repeats_bit_for_bit(cuda, B, Sq, Sk, Hq, Hkv, hd,
                                             causal, window):
    """The kernel uses no atomics, so two launches on the same operands
    give the same bits; a difference would be a race in its ring of
    shared-memory stages."""
    gen = torch.Generator(device=cuda).manual_seed(Sk + hd)
    q, k, v = (torch.randn(s, generator=gen, device=cuda).to(torch.bfloat16)
               for s in ((B, Sq, Hq, hd), (B, Sk, Hkv, hd), (B, Sk, Hkv, hd)))
    first = fa.flash_attention(q, k, v, causal=causal, window=window)
    second = fa.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# SSD intra-chunk: the shapes of tests/test_kernels.py, the reduced mamba2's
# head width 16, and the model path's (mamba2-370m at B 2, S 2048), float32;
# then head counts across the kernel's group of 4 heads (1, 5, 33), a ragged
# chunk at H 5, narrow states at P 16 and 32, a state off a multiple of 4
# (the wrapper pads it for TMA), a long chunk whose scans still fit in
# shared memory (one head at P 16), and chunks whose scans do not (the
# kernel keeps them in global memory), ragged too; 1e-4 (1e-5 for the
# decay), the tolerances of tests/test_kernels.py
SSD_CASES = [(2, 128, 4, 32, 16, 32), (1, 256, 2, 64, 128, 64),
             (2, 64, 3, 16, 16, 16), (1, 100, 2, 16, 8, 100),
             (2, 2048, 32, 64, 128, 256),
             (1, 256, 1, 64, 128, 256), (1, 512, 5, 64, 128, 256),
             (1, 256, 33, 64, 128, 256), (2, 200, 5, 64, 128, 100),
             (1, 256, 3, 16, 8, 256), (2, 256, 6, 32, 64, 128),
             (1, 128, 2, 32, 10, 64), (1, 1984, 1, 16, 16, 1984),
             (1, 1000, 5, 64, 128, 500), (1, 3000, 4, 16, 16, 3000),
             (2, 5000, 3, 32, 64, 2500), (1, 8192, 2, 64, 128, 8192)]


@pytest.mark.parametrize("B,S,H,P,N,Q", SSD_CASES)
def test_ssd_matches_plain(cuda, B, S, H, P, N, Q):
    gen = torch.Generator(device=cuda).manual_seed(S + N)
    nc = S // Q

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=cuda) * scale

    x = randn(B, nc, H, Q, P)
    Bm, Cm = randn(B, nc, Q, N, scale=0.3), randn(B, nc, Q, N, scale=0.3)
    dt = torch.rand((B, nc, H, Q), generator=gen, device=cuda) * 0.19 + 0.01
    A = torch.rand((H,), generator=gen, device=cuda) * 3.5 + 0.5
    before = ssd.launch_count
    got = ssd.ssd_intra_chunk(x, Bm, Cm, dt, A)
    torch.cuda.synchronize()
    assert ssd.launch_count == before + 1
    want = ssd.reference_ssd_intra_chunk(x, Bm, Cm, dt, A)
    for g, w, tol in zip(got, want, (1e-4, 1e-4, 1e-5)):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert torch.allclose(g, w, atol=tol, rtol=tol)


def test_ssd_repeats_bit_for_bit(cuda):
    """The kernel uses no atomics and no reduction across blocks, so two
    launches at the path shape give the same bits; a difference would be a
    race between its producer and consumer warpgroups."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    B, nc, H, Q, P, N = 2, 8, 32, 256, 64, 128
    x = torch.randn((B, nc, H, Q, P), generator=gen, device=cuda)
    Bm = torch.randn((B, nc, Q, N), generator=gen, device=cuda) * 0.3
    Cm = torch.randn((B, nc, Q, N), generator=gen, device=cuda) * 0.3
    dt = torch.rand((B, nc, H, Q), generator=gen, device=cuda) * 0.19 + 0.01
    A = torch.rand((H,), generator=gen, device=cuda) * 3.5 + 0.5
    first = ssd.ssd_intra_chunk(x, Bm, Cm, dt, A)
    second = ssd.ssd_intra_chunk(x, Bm, Cm, dt, A)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_ssd_rejects_what_it_does_not_take(cuda):
    x = torch.zeros((1, 2, 2, 32, 32), device=cuda)
    Bm = torch.zeros((1, 2, 32, 16), device=cuda)
    dt = torch.zeros((1, 2, 2, 32), device=cuda)
    A = torch.ones((2,), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        ssd.ssd_intra_chunk(x.double(), Bm, Bm, dt, A)
    with pytest.raises(ValueError, match="contiguous"):
        ssd.ssd_intra_chunk(x, Bm.transpose(-1, -2).contiguous().transpose(
            -1, -2), Bm, dt, A)
    with pytest.raises(ValueError, match="HEAD_WIDTHS|head|P in"):
        ssd.ssd_intra_chunk(torch.zeros((1, 2, 2, 32, 24), device=cuda), Bm,
                            Bm, dt, A)
    with pytest.raises(ValueError, match="devices"):
        ssd.ssd_intra_chunk(x, Bm, Bm, dt, A.cpu())


# expert matmul: the shapes of tests/test_kernels.py, the MoE path's
# (qwen3-moe-30b-a3b, 4 groups of capacity 80 folded to C 320, both orders
# of 2048 and 768), C off the kernel's 128-row tile (1, 70, 200, 320),
# E = 1, D below and off its 64-deep stage (40, 72, 96, 136), and ragged
# D and F that the wrapper pads to multiples of 8 (50 x 33, F 100), in
# bf16, each activation.  Both sides sum exact products in fp32 (in other
# orders: the kernel's wgmma by 64-deep stages) and apply the activation in
# fp32 (the kernel with a fast exponential and division, a few fp32 ulps),
# then round once to bf16, so they differ by an ulp of bf16 in a few
# elements: held to 2**-7 of the largest magnitude and 2**-7 relative,
# elementwise.
GMM_CASES = [(4, 64, 96, 80), (2, 128, 256, 128), (8, 40, 72, 200),
             (128, 320, 2048, 768), (128, 320, 768, 2048), (3, 1, 64, 64),
             (3, 70, 50, 33), (1, 200, 136, 264), (2, 320, 40, 512),
             (1, 320, 2048, 768), (2, 48, 64, 100)]


@pytest.mark.parametrize("act", ["none", "silu", "gelu"])
@pytest.mark.parametrize("E,C,D,F", GMM_CASES)
def test_expert_matmul_matches_plain(cuda, E, C, D, F, act):
    gen = torch.Generator(device=cuda).manual_seed(C + D)
    x = torch.randn((E, C, D), generator=gen, device=cuda).to(torch.bfloat16)
    w = (torch.randn((E, D, F), generator=gen, device=cuda)
         * D ** -0.5).to(torch.bfloat16)
    before = moe_gmm.launch_count
    out = ops.expert_matmul(x, w, act)
    torch.cuda.synchronize()
    assert moe_gmm.launch_count == before + 1
    want = moe_gmm.reference_expert_matmul(x, w, activation=act)
    assert out.dtype == torch.bfloat16 and out.shape == (E, C, F)
    assert out.is_contiguous()
    tol = 2.0 ** -7
    assert torch.allclose(out.float(), want.float(),
                          atol=tol * float(want.float().abs().max()),
                          rtol=tol)


@pytest.mark.parametrize("E,C,D,F,act", [(8, 320, 2048, 768, "silu"),
                                         (4, 200, 768, 2048, "none")])
def test_expert_matmul_repeats_bit_for_bit(cuda, E, C, D, F, act):
    """The kernel uses no atomics, so two launches on the same operands
    give the same bits; a difference would be a race in its ring of
    shared-memory stages (a stage read before its load landed, or
    overwritten before its products were done)."""
    gen = torch.Generator(device=cuda).manual_seed(D + F)
    x = torch.randn((E, C, D), generator=gen, device=cuda).to(torch.bfloat16)
    w = (torch.randn((E, D, F), generator=gen, device=cuda)
         * D ** -0.5).to(torch.bfloat16)
    first = moe_gmm.expert_matmul(x, w, act)
    second = moe_gmm.expert_matmul(x, w, act)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_expert_matmul_rejects_what_it_does_not_take(cuda):
    x = torch.zeros((2, 16, 32), dtype=torch.bfloat16, device=cuda)
    w = torch.zeros((2, 32, 8), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError, match="bf16"):
        ops.expert_matmul(x.float(), w.float())
    with pytest.raises(ValueError, match="contiguous"):
        ops.expert_matmul(x, w.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(ValueError, match="devices"):
        ops.expert_matmul(x, w.cpu())
    with pytest.raises(ValueError, match="activation"):
        ops.expert_matmul(x, w, "relu")
    odd = torch.zeros(x.numel() + 1, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        ops.expert_matmul(odd[1:].view(x.shape), w)
    odd = torch.zeros(w.numel() + 1, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="aligned"):
        ops.expert_matmul(x, odd[1:].view(w.shape))


def test_router_runs_in_full_float32_under_tf32(cuda, monkeypatch):
    """The MoE router keeps full float32 where the caller has switched TF32
    on for float32 products, and leaves the switch as it found it: its
    logits are within 1e-5 of float64 (TF32's 10-bit mantissa would be off
    by ~1e-3 at D 2048)."""
    cfg = ARCHS["qwen3-moe-30b-a3b"]
    gen = torch.Generator(device=cuda).manual_seed(7)
    toks = torch.randn((1, 64, cfg.d_model), generator=gen,
                       device=cuda).to(torch.bfloat16)
    router = torch.randn((cfg.d_model, cfg.n_experts), generator=gen,
                         device=cuda) * cfg.d_model ** -0.5
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    r = ML.moe_route(router, cfg, toks)
    assert torch.backends.cuda.matmul.allow_tf32
    exact = toks.double() @ router.double()
    assert float((r.logits.double() - exact).abs().max()) < 1e-5


# RG-LRU: the shapes of tests/test_kernels.py and the RG-LRU path's
# (recurrentgemma-9b, B 1, S 4096, W 4096), float32, at the 1e-5 of
# tests/test_kernels.py; decays in [0.7, 0.999).
RGLRU_CASES = [(2, 64, 128), (1, 100, 48), (3, 256, 512), (1, 4096, 4096)]


@pytest.mark.parametrize("B,S,W", RGLRU_CASES)
def test_rglru_matches_plain(cuda, B, S, W):
    gen = torch.Generator(device=cuda).manual_seed(S + W)
    a = torch.rand((B, S, W), generator=gen, device=cuda) * 0.299 + 0.7
    b = torch.randn((B, S, W), generator=gen, device=cuda) * 0.1
    before = rglru.launch_count
    h = ops.rglru_scan(a, b)
    torch.cuda.synchronize()
    assert rglru.launch_count == before + 1
    want = rglru.reference_rglru_scan(a, b)
    assert h.dtype == torch.float32 and h.shape == (B, S, W)
    assert torch.allclose(h, want, atol=1e-5, rtol=1e-5)


def test_rglru_rejects_what_it_does_not_take(cuda):
    a = torch.zeros((1, 8, 4), device=cuda)
    with pytest.raises(TypeError, match="float32"):
        ops.rglru_scan(a.double(), a.double())
    with pytest.raises(ValueError, match="contiguous"):
        ops.rglru_scan(a.transpose(1, 2), a.transpose(1, 2))
    with pytest.raises(ValueError, match="devices"):
        ops.rglru_scan(a, a.cpu())


# the kernels each reduced model's blocks run, besides min-plus in the plan
CHAIN_KERNELS = {"qwen2-1.5b": (fa,), "mamba2-370m": (ssd,),
                 "qwen3-moe-30b-a3b": (fa, moe_gmm),
                 "recurrentgemma-9b": (fa, rglru)}


def _launches_per_layer(cfg, mod) -> int:
    kinds = MT.layer_kinds(cfg.n_layers, cfg.pattern)
    per_kind = {fa: {"attn": 1, "local_attn": 1, "moe": 1},
                ssd: {"ssd": 1}, moe_gmm: {"moe": 3}, rglru: {"rglru": 1}}
    return sum(per_kind[mod].get(k, 0) for k in kinds)


@pytest.mark.parametrize("arch", list(CHAIN_KERNELS))
def test_planned_chain_on_cuda_matches_the_cpu(cuda, arch, monkeypatch):
    """A reduced model, planned with ``bcd_torch`` and run by the chain
    simulator on the card (through the kernels), against the same chain on
    the CPU (plain versions), in bf16: 5e-2 of the largest magnitude, the
    bound of a bf16 stack in tests/test_torch_models.py, on every token.

    For MoE the CPU chain runs twice.  First with its own routing: every
    pick of the card that the CPU's router would not make must be a near
    tie there, half the tokens at least must route alike at every layer,
    and the tokens of each row before its first token that routes
    otherwise are compared (causal attention carries a pick that differs
    to every later token of its row, whatever experts those keep).  Then
    it replays the card's expert picks, its gates, buffer places and
    capacity drops made from them by its own ``routing_of_picks`` (the
    places and drops ``==`` the card's), and every token is compared."""
    cfg = ARCHS[arch].reduced(n_layers=4 * len(ARCHS[arch].pattern),
                              ssm_head_dim=32, head_dim=32)
    params = MT.init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    cpu_params = MT.tree_map(lambda t: t.cpu(), params)
    pp = plan_pipeline(cfg, seq_len=64, microbatch=2, mode="IF",
                       candidate_K=(2,), n_groups_mesh=4, chips_per_group=8)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64),
                           generator=torch.Generator().manual_seed(1))
    card, cpu, replay = [], [], []
    route = ML.moe_route

    def record_or_replay(router, cfg_, toks):
        r = route(router, cfg_, toks)
        if toks.device.type == "cuda":
            card.append(r)
            return r
        cpu.append((r.logits, r.idx, r.keep))
        if not replay:
            return r
        c = card[len(cpu) - 1]
        picked = ML.routing_of_picks(r.logits, r.probs, c.idx.cpu(),
                                     r.capacity)
        assert torch.equal(picked.pos, c.pos.cpu())
        assert torch.equal(picked.keep, c.keep.cpu())
        return picked

    monkeypatch.setattr(ML, "moe_route", record_or_replay)
    mods = CHAIN_KERNELS[arch]
    before = [m.launch_count for m in mods]
    got = ChainSimulator(cfg, params, pp.problem.net, pp.problem.profile,
                         pp.problem.request).run_plan(pp.plan, tokens.to(cuda))
    for m, n in zip(mods, before):
        assert m.launch_count == n + _launches_per_layer(cfg, m)

    def on_cpu():
        want = ChainSimulator(cfg, cpu_params, pp.problem.net,
                              pp.problem.profile, pp.problem.request
                              ).run_plan(pp.plan, tokens)
        return want.hidden.float().reshape(-1, cfg.d_model)

    def rel(out, ref):  # 0 over no token
        if not len(ref):
            return 0.0
        return float((out - ref).abs().max() / ref.abs().max())

    ref = on_cpu()
    out = got.hidden.float().cpu().reshape(-1, cfg.d_model)
    if moe_gmm in mods:
        card_routes = [(r.logits, r.idx, r.keep) for r in card]
        ra = ML.routing_agreement(card_routes, cpu)
        assert ra.flips_are_near_ties(5e-2)
        assert 2 * int(ra.agree.sum()) >= len(ref)
        first = (~ra.agree).reshape(tokens.shape).cumsum(1) == 0
        first = first.flatten()
        split = (rel(out[first], ref[first]),
                 rel(out[ra.agree], ref[ra.agree]),
                 rel(out[~first], ref[~first]))
        print(f"{arch} with the CPU's own routing: {ra.diverged} of "
              f"{len(ref)} tokens route otherwise; largest error over the "
              f"{int(first.sum())} tokens before their row's first such "
              f"token {split[0]!r}, over the {int(ra.agree.sum())} that "
              f"route alike {split[1]!r}, over the {int((~first).sum())} "
              f"from each row's first such token on {split[2]!r}")
        assert split[0] < 5e-2
        cpu.clear()
        replay.append(True)
        ref = on_cpu()
        ra = ML.routing_agreement(card_routes, cpu)
        assert ra.flips_are_near_ties(5e-2)
        assert 2 * int(ra.agree.sum()) >= len(ref)
    assert rel(out, ref) < 5e-2


# the kernels each reduced model's prefill runs (its decode steps none)
SERVE_KERNELS = {"qwen2-1.5b": (fa,), "mamba2-370m": (ssd,),
                 "recurrentgemma-9b": (fa, rglru)}
SERVE_TOL = 2e-2  # chip_smoke.py's CHECK_TOL, card vs CPU in bf16


@pytest.mark.parametrize("arch", list(SERVE_KERNELS))
def test_prefill_and_decode_on_cuda_match_the_cpu(cuda, arch):
    """A reduced model (head widths 32, which the kernels take) serves two
    prompts of 12 and 32 tokens into caches of 48 slots, then 4 decode
    steps fed the same tokens, on the card (the prefill through the
    kernels, one launch a layer of each kind) and on the CPU (plain
    versions), in bf16: each row's logits within SERVE_TOL of its largest
    |logit|, every float cache leaf within SERVE_TOL of its largest
    magnitude and ``pos`` ``==``.  recurrentgemma's 32-slot ring wraps."""
    cfg = ARCHS[arch].reduced(head_dim=32, ssm_head_dim=32)
    params = MT.init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(SV.left_pad(
        [rng.integers(1, cfg.vocab_size, n) for n in (12, 32)], 2))
    fed = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 2, 1)))

    def serve(p, device):
        logits, cache = SV.prefill(p, cfg, toks.to(device), 48)
        out = [logits]
        for i, f in enumerate(fed):
            pos = torch.full((2, 1), toks.shape[1] + i, device=device)
            logits, cache = SV.decode_step(p, cfg, cache, f.to(device), pos)
            out.append(logits)
        return torch.cat(out, dim=1).float().cpu(), cache

    mods = SERVE_KERNELS[arch]
    before = [m.launch_count for m in mods]
    got, got_cache = serve(params, cuda)
    for m, n in zip(mods, before):
        assert m.launch_count == n + _launches_per_layer(cfg, m)
    want, want_cache = serve(MT.tree_map(lambda t: t.cpu(), params), "cpu")
    assert torch.isfinite(got).all()
    row = (got - want).abs().amax(-1) / want.abs().amax(-1)
    assert float(row.max()) < SERVE_TOL
    for g, w in zip(MT.tree_leaves(got_cache), MT.tree_leaves(want_cache)):
        assert g.device.type == "cuda" and g.dtype == w.dtype
        if w.dtype == torch.int64:
            assert torch.equal(g.cpu(), w)
        else:
            err = (g.float().cpu() - w.float()).abs().max()
            assert float(err / w.float().abs().max()) < SERVE_TOL


# ----------------------------------------------------------------- training --
# The backward kernels against autograd through their plain versions
# (reference_attention_bwd, reference_ssd_intra_chunk_bwd), at the forward
# checks' shapes.  Flash attention in bf16: the kernel sums in fp32 and
# rounds each gradient once to bf16, so each gradient is held to 2**-6 of
# its largest magnitude (chip_smoke.py's FLASH_BWD_TOL).
# SSD in float32: sums in other orders, 1e-4 of each gradient's largest
# magnitude (chip_smoke.py's SSD_BWD_TOL).
FLASH_BWD_TOL = 2.0 ** -6
SSD_BWD_TOL = 1e-4
FLASH_BWD_CASES = FLASH_CASES[:6] + [
    (1, 37, 37, 8, 2, 128, True, None, None),
    (1, 200, 200, 4, 1, 256, True, None, None),
    (1, 300, 300, 4, 2, 256, True, 128, None),
    (2, 96, 96, 2, 1, 256, False, 40, 30.0),
    (1, 300, 129, 2, 1, 64, True, 16, None),
    # the tensor-core kernel's tiles (64 keys and ring rows, 128 dQ rows):
    (1, 63, 65, 2, 1, 64, True, None, None),      # either side of 64
    (1, 129, 127, 4, 2, 128, False, None, None),  # either side of 128
    (2, 200, 100, 6, 1, 64, True, 24, None),      # G 6, rows 123.. blind
    (1, 160, 160, 12, 2, 128, True, None, None),  # G 6
    (1, 192, 192, 8, 1, 64, True, 80, None),      # G 8 with a window
    (1, 130, 130, 4, 2, 32, True, None, 20.0),    # hd 32, a softcap
    (1, 150, 150, 2, 1, 256, True, None, 50.0),   # hd 256, a softcap
    (1, 100, 300, 4, 2, 64, False, 50, None),     # Sq < Skv, a window
    (2, 512, 512, 12, 2, 128, True, None, None),  # qwen2's path at S 512
]


def _flash_bwd_operands(cuda, B, Sq, Sk, Hq, Hkv, hd, seed):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    return tuple(torch.randn(s, generator=gen, device=cuda).to(torch.bfloat16)
                 for s in ((B, Sq, Hq, hd), (B, Sk, Hkv, hd),
                           (B, Sk, Hkv, hd), (B, Sq, Hq, hd)))


def _within(got, want, tol) -> bool:
    return float((got.float() - want.float()).abs().max()) <= \
        tol * float(want.float().abs().max())


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,hd,causal,window,softcap",
                         FLASH_BWD_CASES)
def test_flash_attention_bwd_matches_plain_autograd(
        cuda, B, Sq, Sk, Hq, Hkv, hd, causal, window, softcap):
    """dQ, dK and dV of the backward kernel within FLASH_BWD_TOL of autograd
    through the plain version; two launches give the same bits."""
    q, k, v, dout = _flash_bwd_operands(cuda, B, Sq, Sk, Hq, Hkv, hd,
                                        Sq + hd)
    kw = dict(causal=causal, window=window, softcap=softcap)
    _, lse = fa.flash_attention_with_lse(q, k, v, **kw)
    before = fa.bwd_launch_count
    got = fa.flash_attention_bwd(q, k, v, lse, dout, **kw)
    again = fa.flash_attention_bwd(q, k, v, lse, dout, **kw)
    torch.cuda.synchronize()
    assert fa.bwd_launch_count == before + 2
    want = fa.reference_attention_bwd(q, k, v, lse, dout, **kw)
    for g, a, w in zip(got, again, want):
        assert g.dtype == torch.bfloat16 and torch.isfinite(g).all()
        assert torch.equal(g, a)
        assert _within(g, w, FLASH_BWD_TOL)


@pytest.mark.parametrize("B,Sq,Sk,Hq,Hkv,hd,causal,window,softcap",
                         FLASH_CASES[:6] + [FLASH_BWD_CASES[-1]])
def test_flash_attention_lse_and_unchanged_output(cuda, B, Sq, Sk, Hq, Hkv,
                                                  hd, causal, window,
                                                  softcap):
    """The forward kernel's log-sum-exp against ``logsumexp`` of the plain
    scores (rows that see no key keep -1e30 on both sides), and its output
    the same bits with the buffer and without."""
    q, k, v, _ = _flash_bwd_operands(cuda, B, Sq, Sk, Hq, Hkv, hd, Sk + hd)
    kw = dict(causal=causal, window=window, softcap=softcap)
    out, lse = fa.flash_attention_with_lse(q, k, v, **kw)
    plain = fa.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, plain)
    assert torch.allclose(lse, fa.reference_lse(q, k, **kw), atol=1e-4,
                          rtol=1e-5)


def test_flash_attention_autograd_reaches_the_backward_kernel(cuda):
    """Through ``flash_attention`` with operands that require grad, the
    forward kernel runs once and ``backward`` runs the backward kernel
    once, giving what ``flash_attention_bwd`` gives."""
    q, k, v, dout = _flash_bwd_operands(cuda, 2, 256, 256, 4, 2, 64, 7)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    fwd, bwd = fa.launch_count, fa.bwd_launch_count
    out = fa.flash_attention(*leaves, window=100)
    out.backward(dout)
    torch.cuda.synchronize()
    assert (fa.launch_count, fa.bwd_launch_count) == (fwd + 1, bwd + 1)
    _, lse = fa.flash_attention_with_lse(q, k, v, window=100)
    want = fa.flash_attention_bwd(q, k, v, lse, dout, window=100)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad, w)


@pytest.mark.parametrize("B,S,H,P,N,Q", SSD_CASES[:5] + [
    (1, 512, 5, 64, 128, 256), (1, 128, 2, 32, 10, 64),
    (1, 1000, 5, 64, 128, 500),
    # the edges of the kernel's tiles and head groups: 5 and 33 heads
    # across groups of 4, Q either side of a 64-position tile, N 10 padded
    # for TMA and N 124 off a multiple of 16, the path's widths at nc 2
    (1, 256, 5, 64, 128, 256), (1, 256, 33, 32, 64, 128),
    (1, 128, 4, 64, 128, 64), (1, 130, 4, 64, 128, 65),
    (2, 128, 4, 32, 10, 64), (1, 256, 4, 64, 124, 128),
    (2, 512, 32, 64, 128, 256)])
def test_ssd_bwd_matches_plain_autograd(cuda, B, S, H, P, N, Q):
    """dx, dB, dC, ddt and dA of the backward kernel within SSD_BWD_TOL of
    autograd through the plain version, for cotangents of all three
    outputs; two launches give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(S + N)
    nc = S // Q
    args = (torch.randn((B, nc, H, Q, P), generator=gen, device=cuda),
            torch.randn((B, nc, Q, N), generator=gen, device=cuda) * 0.3,
            torch.randn((B, nc, Q, N), generator=gen, device=cuda) * 0.3,
            torch.rand((B, nc, H, Q), generator=gen, device=cuda) * 0.19
            + 0.01,
            torch.rand((H,), generator=gen, device=cuda) * 3.5 + 0.5)
    cot = (torch.randn((B, nc, H, Q, P), generator=gen, device=cuda),
           torch.randn((B, nc, H, N, P), generator=gen, device=cuda),
           torch.randn((B, nc, H, Q), generator=gen, device=cuda))
    before = ssd.bwd_launch_count
    got = ssd.ssd_intra_chunk_bwd(*args, *cot)
    again = ssd.ssd_intra_chunk_bwd(*args, *cot)
    torch.cuda.synchronize()
    assert ssd.bwd_launch_count == before + 2
    want = ssd.reference_ssd_intra_chunk_bwd(*args, *cot)
    for g, a, w, t in zip(got, again, want, args):
        assert g.shape == t.shape and torch.isfinite(g).all()
        assert torch.equal(g, a)
        assert _within(g, w, SSD_BWD_TOL)


def test_ssd_autograd_reaches_the_backward_kernel(cuda):
    """``ssd_forward`` with inputs that require grad: one forward and one
    backward launch, and the inputs' gradients within SSD_BWD_TOL of the
    same function on the plain version's autograd."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    xh = torch.randn((2, 128, 3, 32), generator=gen, device=cuda)
    dtv = torch.rand((2, 128, 3), generator=gen, device=cuda) * 0.2 + 0.01
    A = torch.rand((3,), generator=gen, device=cuda) * 3 + 0.5
    Bm, Cm = (torch.randn((2, 128, 16), generator=gen, device=cuda) * 0.3
              for _ in range(2))
    gy = torch.randn((2, 128, 3, 32), generator=gen, device=cuda)

    def grads(device):
        leaves = [t.to(device).clone().requires_grad_()
                  for t in (xh, dtv, A, Bm, Cm)]
        y, h = ops.ssd_forward(*leaves, chunk=32)
        torch.autograd.backward((y, h), (gy.to(device), torch.ones_like(h)))
        return [leaf.grad for leaf in leaves]

    fwd, bwd = ssd.launch_count, ssd.bwd_launch_count
    got = grads(cuda)
    torch.cuda.synchronize()
    assert (ssd.launch_count, ssd.bwd_launch_count) == (fwd + 1, bwd + 1)
    for g, w in zip(got, grads("cpu")):
        assert _within(g.cpu(), w, SSD_BWD_TOL)


def test_expert_matmul_and_rglru_raise_under_grad(cuda):
    """The two kernels without a backward raise on the card when an operand
    requires grad in grad mode (naming ROADMAP A4b), and launch as before
    under ``no_grad``."""
    x = torch.randn((2, 64, 32), device=cuda).to(torch.bfloat16)
    w = torch.randn((2, 32, 16), device=cuda).to(torch.bfloat16)
    with pytest.raises(NotImplementedError, match="A4b"):
        moe_gmm.expert_matmul(x, w.requires_grad_())
    a = torch.rand((1, 16, 8), device=cuda)
    b = torch.randn((1, 16, 8), device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="A4b"):
        rglru.rglru_scan(a, b)
    with torch.no_grad():
        assert moe_gmm.expert_matmul(x, w).shape == (2, 64, 16)
        assert rglru.rglru_scan(a, b).shape == (1, 16, 8)


@pytest.mark.parametrize("arch,kernel", [("qwen2-1.5b", fa), ("mamba2-370m",
                                                                ssd)])
def test_round_trip_and_train_step_on_cuda(cuda, arch, kernel):
    """A reduced model (four layers, head widths 32) on the card: one
    ``ChainSimulator.round_trip`` over a TR plan (one forward and one
    backward launch a layer) and one train step (two forward launches a
    layer under remat, one backward), against the same on the CPU (plain
    versions) in bf16: the hidden state, ``grad_in``, the loss and the
    global gradient norm within SERVE_TOL."""
    from repro_torch.data import BatchSpec, SyntheticLM, shard_batch
    from repro_torch.optim import make_optimizer
    from repro_torch.train import make_train_step

    cfg = ARCHS[arch].reduced(n_layers=4, head_dim=32, ssm_head_dim=32)
    B, S = 2, 64
    params = MT.init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    cpu_params = MT.tree_map(lambda t: t.cpu(), params)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (B, S)))
    pp = plan_pipeline(cfg, seq_len=S, microbatch=B, mode="TR",
                       device="cpu")

    def round_trip(p, device):
        sim = ChainSimulator(cfg, p, pp.problem.net, pp.problem.profile,
                             pp.problem.request)
        return sim.round_trip(pp.plan, tokens.to(device))

    before = (kernel.launch_count, kernel.bwd_launch_count)
    got = round_trip(params, cuda)
    torch.cuda.synchronize()
    assert (kernel.launch_count, kernel.bwd_launch_count) == (
        before[0] + 4, before[1] + 4)
    want = round_trip(cpu_params, "cpu")
    for g, w in ((got.hidden, want.hidden), (got.grad_in, want.grad_in)):
        assert torch.isfinite(g).all()
        assert _within(g.cpu(), w, SERVE_TOL)

    stream = SyntheticLM(BatchSpec(B, S, cfg.vocab_size), seed=0)
    metrics = []
    for p, device in ((params, cuda), (cpu_params, "cpu")):
        opt = make_optimizer(cfg.optimizer, lr=3e-4, warmup=1, total=50)
        step = make_train_step(cfg, opt)
        before = (kernel.launch_count, kernel.bwd_launch_count)
        _, _, m = step(p, opt.init(p, cfg),
                       shard_batch(stream.batch_at(0), device))
        if device == "cpu":
            assert (kernel.launch_count, kernel.bwd_launch_count) == before
        else:
            torch.cuda.synchronize()
            assert (kernel.launch_count, kernel.bwd_launch_count) == (
                before[0] + 8, before[1] + 4)
        metrics.append({k: float(v) for k, v in m.items()})
    for key in ("loss", "grad_norm"):
        assert abs(metrics[0][key] - metrics[1][key]) <= SERVE_TOL * abs(
            metrics[1][key])


# ------------------------------------------ the serving control plane
def test_gateway_fleet_on_cuda_matches_dfts_np(cuda):
    """A 16-request Poisson fleet through ``ServeGateway.run_stream`` at a
    0.5 s window with exponential holds and the retry queue: ``dfts_torch``
    on the card ``==`` ``dfts_np`` on the host, record for record, solve
    for solve, with scans launched (chip_smoke.py's gate, path 5)."""
    import chip_smoke as cs
    import repro_torch.serve as S

    net, profile = T.nsfnet(source=T.SOURCE), T.resnet101_profile()
    run = cs.StackRun("gateway n16 window 0.5", "gateway", dict(
        n_requests=16, batch_size=2, mode="IF", K=3, seed=0,
        arrival="poisson", model_id="resnet101", hold_model="exp",
        hold_time_s=4.0), (("dfts_torch", "dfts_np"),), 0.5)
    fleet = S.generate_fleet(net, source=T.SOURCE, destination=T.DEST,
                             **run.fleet)
    before = mp.scan_launch_count
    got = cs.drive_stack(S, run, net, profile, fleet, None, "dfts_torch",
                         {"device": "cuda"})
    assert mp.scan_launch_count > before
    want = cs.drive_stack(S, run, net, profile, fleet, None, "dfts_np", None)
    assert cs.serve_view(*got) == cs.serve_view(*want)
    assert S.replay_verify_sim(net, profile, got[0].served)


def test_serve_cli_plans_on_cuda_by_default(cuda, tmp_path, capsys):
    """``python -m repro_torch.serve`` with no device flag: ``bcd_torch`` on
    the card, the same records as the host's ``bcd``."""
    from repro_torch.serve.__main__ import main

    before = mp.scan_launch_count
    assert main(["--n-requests", "8", "--json", str(tmp_path / "card.json")
                 ]) == 0
    assert mp.scan_launch_count > before
    assert main(["--n-requests", "8", "--solver", "bcd", "--json",
                 str(tmp_path / "host.json")]) == 0
    card, host = (json.loads((tmp_path / f"{n}.json").read_text())
                  for n in ("card", "host"))
    assert card["served"] == host["served"]
    assert card["summary"]["solver"] == "bcd_torch"


def test_ft_controller_plans_on_cuda_by_default(cuda):
    """``ElasticPlanController`` with no solver: ``bcd_torch`` on the card,
    launching the scan, with the plans and latencies of the host's ``bcd``
    before and after its middle node fails."""
    import repro_torch.ft as TF

    net, profile = T.nsfnet(source="v4"), T.resnet101_profile()
    req = T.ServiceChainRequest("resnet101", "v4", "v13", 8, T.TR)
    cands = [["v4"], ["v7", "v11"], ["v13"]]
    before = mp.scan_launch_count
    card = TF.ElasticPlanController(net, profile, req, 3, cands)
    assert mp.scan_launch_count > before
    host = TF.ElasticPlanController(net, profile, req, 3, cands,
                                    solver="bcd")
    middle = card.plan.placement[1]
    for ctl in (card, host):
        assert ctl.fail_node(middle, step=1) is not None
    assert card.plan == host.plan
    assert card.result.latency_s == host.result.latency_s


# ------------------------------------------------------- the sweep engine
def test_sweep_grid_on_cuda_matches_the_host(cuda, tmp_path):
    """The ``nsfnet_paper`` grid at one seed and K 2-4 through
    ``SweepRunner`` on the card (the default device): ``bcd_torch``'s
    results, report and CSV rows ``==`` the same grid with the host's
    ``bcd`` once the name is mapped, every ``bcd_torch`` spec presolved,
    scans launched (chip_smoke.py's gates, path 6)."""
    import chip_smoke as cs
    import repro_torch.sweep as W
    from repro_torch.sweep import runner as WR
    from repro_torch.sweep import suites as WS

    grid = [s for s in WS.nsfnet_paper(seeds=1, schemes=("exact", WS.BCD))
            if s.K <= 4]
    host = [s for s in WS.nsfnet_paper(seeds=1, schemes=("exact", "bcd"))
            if s.K <= 4]
    before = mp.scan_launch_count
    runner = W.SweepRunner()
    with cs.presolved_maps(WR) as (maps, _):
        got = runner.run(grid)
    assert mp.scan_launch_count > before
    assert runner.last_stats["n_errors"] == 0
    assert cs._check_presolved(T, WR, grid, maps) == len(grid) // 2
    want = W.SweepRunner(device="cpu").run(host)
    assert (cs.sweep_view(W, got, tmp_path / "card", cs.sweep_names(got))
            == cs.sweep_view(W, want, tmp_path / "host"))
    assert all(W.verify_result(r) for r in got)


def test_sweep_cli_runs_on_cuda_by_default(cuda, tmp_path, capsys):
    """``python -m repro_torch.sweep`` with no device flag runs the
    ``nsfnet_paper`` quick tier's ``bcd_torch`` scenarios on the card."""
    from repro_torch.sweep.__main__ import main

    before = mp.scan_launch_count
    assert main(["--suite", "nsfnet_paper", "--quick", "--no-cache",
                 "--out", str(tmp_path)]) == 0
    assert mp.scan_launch_count > before
    assert "bcd_torch" in capsys.readouterr().out
