"""The port on the card: the CUDA min-plus, flash-attention, SSD,
expert-matmul and RG-LRU kernels against their plain versions,
``dfts_torch`` / ``bcd_torch`` on ``cuda`` against the NumPy oracles, and a
planned chain of a reduced model through the kernels against the same chain
on the CPU.

Every test here is marked ``cuda`` and skips without a card.  The file
imports nothing of JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.configs import ARCHS
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import minplus as mp
from repro_torch.kernels import moe_gmm, ops, rglru
from repro_torch.kernels import ssd
from repro_torch.kernels.minplus import minplus_matmul, minplus_reference
from repro_torch.models import layers as ML
from repro_torch.models import transformer as MT
from repro_torch.msl import ChainSimulator, plan_pipeline

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
    before = mp.launch_count
    dfts = T.solve_batch(problems, "dfts_torch", dedup=False, min_batch=1)
    bcd = T.solve_batch(problems, "bcd_torch", dedup=False, min_batch=1)
    assert mp.launch_count > before
    for p, got_d, got_b in zip(problems, dfts, bcd):
        assert _plain(got_d) == _plain(T.solve(p, "dfts_np"))
        assert _plain(got_b) == _plain(T.solve(p, "bcd"))


# flash attention: the shapes of tests/test_kernels.py plus the model path's
# (qwen2-1.5b at B 2, S 2048), in bf16, the type the path gives the kernel.
# Both sides round fp32 sums taken in other orders once to bf16, so they
# differ by an ulp of bf16 in a few elements: each (batch, query, head) row
# is held to 1e-2 of its own norm, and the largest error to 2**-6 of the
# largest magnitude (chip_smoke.py's FLASH_TOL, which rejects an output
# with l off by 5 % or with each row's diagonal key tile dropped).
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


# SSD intra-chunk: the shapes of tests/test_kernels.py, the reduced mamba2's
# head width 16, and the model path's (mamba2-370m at B 2, S 2048), float32;
# 1e-4 (1e-5 for the decay), the tolerances of tests/test_kernels.py
SSD_CASES = [(2, 128, 4, 32, 16, 32), (1, 256, 2, 64, 128, 64),
             (2, 64, 3, 16, 16, 16), (1, 100, 2, 16, 8, 100),
             (2, 2048, 32, 64, 128, 256)]


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


# expert matmul: the shapes of tests/test_kernels.py and the MoE path's
# (qwen3-moe-30b-a3b, 4 groups of capacity 80 folded to C 320), bf16, each
# activation.  Both sides sum exact products in fp32 (in other orders) and
# round once to bf16, so they differ by an ulp of bf16 in a few elements:
# held to 2**-7 of the largest magnitude and 2**-7 relative, elementwise.
GMM_CASES = [(4, 64, 96, 80), (2, 128, 256, 128), (8, 40, 72, 200),
             (128, 320, 2048, 768), (128, 320, 768, 2048)]


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
    tol = 2.0 ** -7
    assert torch.allclose(out.float(), want.float(),
                          atol=tol * float(want.float().abs().max()),
                          rtol=tol)


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
    bound of a bf16 stack in tests/test_torch_models.py, route-aware for
    MoE as there (every token that diverged did so at a near tie on the
    CPU side, the output compared where the kept experts agree)."""
    cfg = ARCHS[arch].reduced(n_layers=4 * len(ARCHS[arch].pattern),
                              ssm_head_dim=32, head_dim=32)
    params = MT.init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    cpu_params = MT.tree_map(lambda t: t.cpu(), params)
    pp = plan_pipeline(cfg, seq_len=64, microbatch=2, mode="IF",
                       candidate_K=(2,), n_groups_mesh=4, chips_per_group=8)
    tokens = torch.randint(0, cfg.vocab_size, (2, 64),
                           generator=torch.Generator().manual_seed(1))
    routes = {"cuda": [], "cpu": []}
    route = ML.moe_route

    def record(router, cfg_, toks):
        r = route(router, cfg_, toks)
        routes[toks.device.type].append((r.logits, r.idx, r.keep))
        return r

    monkeypatch.setattr(ML, "moe_route", record)
    mods = CHAIN_KERNELS[arch]
    before = [m.launch_count for m in mods]
    got = ChainSimulator(cfg, params, pp.problem.net, pp.problem.profile,
                         pp.problem.request).run_plan(pp.plan, tokens.to(cuda))
    for m, n in zip(mods, before):
        assert m.launch_count == n + _launches_per_layer(cfg, m)
    want = ChainSimulator(cfg, cpu_params, pp.problem.net, pp.problem.profile,
                          pp.problem.request).run_plan(pp.plan, tokens)
    ref = want.hidden.float().reshape(-1, cfg.d_model)
    out = got.hidden.float().cpu().reshape(-1, cfg.d_model)
    if moe_gmm in mods:
        ra = ML.routing_agreement(routes["cuda"], routes["cpu"])
        assert ra.flips_are_near_ties(5e-2)
        assert 2 * int(ra.agree.sum()) >= len(ref)
        ref, out = ref[ra.agree], out[ra.agree]
    err = (out - ref).abs().max()
    assert float(err / ref.abs().max()) < 5e-2
