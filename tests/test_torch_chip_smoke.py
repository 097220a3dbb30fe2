"""chip_smoke.py's checks on the CPU: the rule for profiler windows (with a
stand-in profiler, a window that lost device events is never read, the
next one is, and when every window lost events the calls are timed on a
held stream; a reading under its bound is never reported), SSD's bound, SSD's witness against wrong outputs, the
card-vs-CPU gate of the MoE models on a hand-made routing, the fused
min-plus scan's bound, path 1's recording and host split rehearsed on the
CPU, path 3 (serving) rehearsed on the CPU at reduced size, with two
wrong decodes its teacher-forced gate must reject, and path 2 of the four
configs added last (gemma2-27b, arctic-480b, qwen3-14b, starcoder2-7b) with
the cap on recorded operand sets."""
from __future__ import annotations

import collections
import copy
import dataclasses
import importlib
import json
import shutil
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as cs
import repro_torch.core as T
from repro_torch.configs import ARCHS
from repro_torch.core import torch_solvers as TS
from repro_torch.kernels import minplus as mp
from repro_torch.models import layers as ML
from repro_torch.models import transformer as MT
from test_torch_sweep import one_thread  # noqa: F401  (a fixture)

CALLS = 10
KERNEL = "minplus_kernel"


def _window(us_each: float, events: int, other: int = 0):
    """A stand-in window: ``events`` events of KERNEL at ``us_each`` us and
    ``other`` events of another kernel."""
    by_name, count = {}, collections.Counter()
    if events:
        by_name[KERNEL], count[KERNEL] = us_each * events, events
    if other:
        by_name["elementwise"], count["elementwise"] = 1.0 * other, other
    return 0.0, by_name, count


@pytest.mark.parametrize("windows, must_see, want", [
    ([_window(2.0, CALLS)], KERNEL, 2.0e-3),
    ([_window(2.0, CALLS - 3), _window(3.0, CALLS)], KERNEL, 3.0e-3),
    ([_window(2.0, 0, other=5), _window(2.0, 2 * CALLS, other=5)], KERNEL,
     4.0e-3),
    ([_window(2.0, CALLS - 1)] * cs.PROFILE_WINDOWS, KERNEL, "held"),
    ([_window(2.0, 0)] * cs.PROFILE_WINDOWS, KERNEL, "held"),
    ([_window(2.0, 0)] * cs.PROFILE_WINDOWS, None, "held"),
    ([_window(2.0, CALLS - 1, other=CALLS)] * cs.PROFILE_WINDOWS, None,
     "held"),
    ([_window(2.0, CALLS, other=CALLS)] * 2, None, 3.0e-3),
    ([_window(2.0, 0, other=CALLS)] + [_window(2.0, CALLS, other=CALLS)] * 2,
     None, 3.0e-3),
], ids=["whole", "lost-then-whole", "empty-then-whole", "all-lost",
        "all-empty", "all-empty-plain", "all-lost-plain", "whole-plain",
        "lost-a-kernel-plain"])
def test_a_lossy_window_is_never_read(monkeypatch, capsys, windows,
                                      must_see, want):
    """A window that lost events is never read; without a kernel's name
    (a plain version or a library call, which may launch several kernels a
    call) a window is read only after one that saw the same events."""
    left = list(windows)
    monkeypatch.setattr(cs, "_device_events", lambda fn: left.pop(0))
    monkeypatch.setattr(cs, "_held_queue_ms", lambda fn, calls: 7.5)
    got = cs._kernel_device_ms(lambda: None, CALLS, must_see)
    if want == "held":
        assert got == 7.5
        assert not left
        assert "held stream" in capsys.readouterr().out
    else:
        assert got == pytest.approx(want)


@pytest.mark.parametrize("per_call, want_calls", [
    (1, CALLS), (60, cs.HELD_LAUNCHES // 60), (cs.HELD_LAUNCHES, 1),
    (2 * cs.HELD_LAUNCHES, 1)])
def test_the_held_stream_fallback_keeps_its_queue_short(monkeypatch, capsys,
                                                         per_call,
                                                         want_calls):
    """Every window lost one event of a plain version of ``per_call``
    launches a call: the held-stream timing takes as many calls as keep
    HELD_LAUNCHES launches or fewer behind its hold, and at least one."""
    monkeypatch.setattr(cs, "_device_events", lambda fn: _window(
        0.0, 0, other=per_call * CALLS - 1))
    taken = []
    monkeypatch.setattr(cs, "_held_queue_ms",
                        lambda fn, calls: taken.append(calls) or 7.5)
    assert cs._kernel_device_ms(lambda: None, CALLS, None) == 7.5
    assert taken == [want_calls]
    assert f"{want_calls} calls of {per_call} launches" in \
        capsys.readouterr().out


BOUND_MS = 2.0e-3  # the least time of the stand-in work: 2 us a call


@pytest.mark.parametrize("windows, must_see, held, want", [
    ([_window(1.0, CALLS), _window(2.5, CALLS)], KERNEL, 7.5, 2.5e-3),
    ([_window(0.5, CALLS, other=CALLS)] * 2
     + [_window(2.5, CALLS, other=CALLS)], None, 7.5, 3.5e-3),
    ([_window(1.0, CALLS)] * cs.PROFILE_WINDOWS, KERNEL, 7.5, 7.5),
    ([_window(1.0, CALLS)] * cs.PROFILE_WINDOWS, KERNEL, 1.0e-3, "raises"),
], ids=["half-then-whole", "half-then-whole-plain", "all-half-held",
        "held-under-bound"])
def test_a_reading_under_its_bound_is_never_reported(monkeypatch, capsys,
                                                     windows, must_see,
                                                     held, want):
    """A window whose events are whole but read half the work's least time
    lost events too: it is timed again, the held stream is used when every
    window so reads, and a held stream under the bound raises."""
    left = list(windows)
    monkeypatch.setattr(cs, "_device_events", lambda fn: left.pop(0))
    monkeypatch.setattr(cs, "_held_queue_ms", lambda fn, calls: held)
    if want == "raises":
        with pytest.raises(AssertionError, match="under its bound"):
            cs._kernel_device_ms(lambda: None, CALLS, must_see, BOUND_MS)
        return
    got = cs._kernel_device_ms(lambda: None, CALLS, must_see, BOUND_MS)
    assert got == pytest.approx(want) and got >= BOUND_MS
    assert not left
    assert "under its bound" in capsys.readouterr().out


def test_every_reading_of_a_shape_row_is_held_to_its_bound(monkeypatch):
    """``_shape_row`` gives the shape's bound to each timing of the same
    function (the kernel, its plain version, under grad, the library call)
    and holds the held stream's reading to it; the same-bytes call, which
    skips the work, is held to none."""
    name, spec = "moe_gmm", cs.KERNELS["moe_gmm"]
    s = (4, 8, 32, 16, "silu")
    call = spec.random_operands(torch.Generator().manual_seed(0), s, {},
                                "cpu")
    bound = spec.bound(s)[0]
    given = []

    def timed(fn, calls, must_see, bound_ms=None):
        given.append(bound_ms)
        return 2 * bound

    monkeypatch.setattr(cs, "_kernel_device_ms", timed)
    monkeypatch.setattr(cs, "_held_queue_ms", lambda fn, calls: 2 * bound)
    row = cs._shape_row(name, importlib.import_module(
        "repro_torch.kernels.moe_gmm"), s, call, 1)
    n_same = "same_bytes_ms" in row
    assert given == [bound] * (len(given) - n_same) + [None] * n_same
    assert len(given) - n_same == 2 + spec.grad_timed + (
        row["library_ms"] is not None)
    monkeypatch.setattr(cs, "_held_queue_ms", lambda fn, calls: bound / 2)
    with pytest.raises(AssertionError, match="held stream"):
        cs._shape_row(name, importlib.import_module(
            "repro_torch.kernels.moe_gmm"), s, call, 1)


def test_a_name_no_window_saw_raises(monkeypatch):
    monkeypatch.setattr(cs, "_device_events",
                        lambda fn: _window(2.0, CALLS, other=CALLS))
    monkeypatch.setattr(cs, "_held_queue_ms", lambda fn, calls: 7.5)
    with pytest.raises(AssertionError, match="no_such_kernel"):
        cs._kernel_device_ms(lambda: None, CALLS, "no_such_kernel")


# ---------------------------------------------------------------- SSD ---
PATH_KEY = (2, 8, 32, 256, 64, 128)  # mamba2-370m: (B, nc, H, Q, P, N)


def test_ssd_bound_at_the_path_shape():
    """The least work at the path shape, bounded on the tensor cores where
    the kernel does three TF32 products for each fp32 product; the same
    work at the fp32 rate is the row's second figure."""
    ms, by, n_ops, n_bytes = cs._ssd_bound(PATH_KEY)
    assert (n_ops, n_bytes) == (4_438_097_920, 89_129_088)
    assert cs.SSD_TF32_PASSES == 3
    assert by == "operations"
    assert ms == pytest.approx(3 * n_ops / 495e12 * 1e3)
    assert ms > n_bytes / 3.35e12 * 1e3  # 26.9 us of operations, 26.6 of bytes
    fp32 = cs.KERNELS["ssd"].fp32_bound(PATH_KEY)
    assert fp32 == cs._ssd_fp32_bound(PATH_KEY)
    assert fp32[1] == "operations"
    assert fp32[0] == pytest.approx(n_ops / 67e12 * 1e3)
    assert cs.KERNELS["flash_attention"].fp32_bound(PATH_KEY) is None


def _ssd_args(seed, B=1, S=128, H=4, P=16, N=16, Q=64):
    rng = np.random.default_rng(seed)
    nc = S // Q
    f32 = np.float32
    return tuple(torch.from_numpy(a) for a in (
        rng.standard_normal((B, nc, H, Q, P)).astype(f32),
        (rng.standard_normal((B, nc, Q, N)) * 0.3).astype(f32),
        (rng.standard_normal((B, nc, Q, N)) * 0.3).astype(f32),
        rng.uniform(0.01, 0.2, (B, nc, H, Q)).astype(f32),
        rng.uniform(0.5, 4.0, (H,)).astype(f32)))


@pytest.mark.parametrize("fault", [None, "head 1 with head 0's dt and A",
                                   "each query tile's diagonal score tile "
                                   "dropped"], ids=["plain", "head", "tile"])
def test_ssd_witness_rejects_wrong_outputs(fault):
    """The witness limit passes the plain version and rejects both wrong
    outputs chip_smoke.py builds, at H 4 and Q 64 (two chunks)."""
    from repro_torch.kernels import ssd

    args = _ssd_args(7)
    want = ssd.reference_ssd_intra_chunk(*args)
    exact = ssd.reference_ssd_intra_chunk(*args, dtype=torch.float64)
    wrong = cs._ssd_wrong_outputs(ssd, args)
    assert set(wrong) == {"head 1 with head 0's dt and A",
                          "each query tile's diagonal score tile dropped"}
    got = want if fault is None else wrong[fault]
    rows = cs._ssd_witness(got, want, exact)
    assert [name for name, _, _ in rows] == ["y", "chunk states"]
    within = all(err <= limit for _, err, limit in rows)
    assert within == (fault is None)


# ------------------------------------------------------------- RG-LRU ---
def test_rglru_bound_at_the_path_shape():
    """recurrentgemma-9b's scan, (1, 4096, 4096) float32: a and b read and
    h written once, 201,326,592 bytes, 60.1 us at 3.35 TB/s; its two flops
    an element are far below the fp32 rate."""
    ms, by, n_ops, n_bytes = cs._rglru_bound((1, 4096, 4096))
    assert n_bytes == 201_326_592 and n_ops == 2 * 4096 * 4096
    assert by == "bytes"
    assert ms == pytest.approx(0.0601, rel=1e-3)
    assert cs.KERNELS["rglru"].profiled == "rglru_scan_kernel"
    assert not any(cs.KERNELS["rglru"].profiled in name for name in (
        "rglru_bwd_chunk_summaries", "rglru_bwd_chunk_scan"))


RGLRU_FAULTS = ["the state restarted every stage",
                "a slab carrying the previous slab's state",
                "the last stage unwritten"]


@pytest.mark.parametrize("fault", [None, *RGLRU_FAULTS],
                         ids=["plain", "restart", "slab", "unwritten"])
def test_rglru_checks_reject_wrong_outputs(fault, monkeypatch):
    """Both RG-LRU gates pass the plain version standing in for the kernel
    and each fails every wrong output of ``_rglru_wrong_outputs``, over
    three stages, the last one partial, and three slabs, the last one
    partial.  On the CPU the wrapper is the plain version itself."""
    from repro_torch.kernels import rglru

    args = cs._rglru_operands(torch.Generator().manual_seed(12),
                              (2, 300, 150), "cpu")
    assert 2 * cs.RGLRU_STAGE < 300 < 3 * cs.RGLRU_STAGE
    assert 2 * cs.RGLRU_SLAB < 150 < 3 * cs.RGLRU_SLAB
    wrong = cs._rglru_wrong_outputs(rglru, args)
    assert list(wrong) == RGLRU_FAULTS
    cs._rglru_rejects_wrong_outputs(rglru, args)
    if fault is None:
        assert cs._rglru_check(rglru, [args], "plain") >= 0.0
        assert cs._rglru_check_witness(rglru, [args], "plain") >= 0.0
        return
    monkeypatch.setattr(rglru, "rglru_scan", lambda *a: wrong[fault])
    with pytest.raises(AssertionError, match="past the limit"):
        cs._rglru_check(rglru, [args], "wrong")
    with pytest.raises(AssertionError, match="past the limit"):
        cs._rglru_check_witness(rglru, [args], "wrong")


def test_rglru_checks_reject_a_scan_that_changes_its_bits(monkeypatch):
    """Two launches on the same operands must give the same bits: a scan
    whose second result is one ulp off in one element fails both gates,
    though it is well within their limits."""
    from repro_torch.kernels import rglru

    args = cs._rglru_operands(torch.Generator().manual_seed(13),
                              (1, 70, 40), "cpu")
    want = rglru.reference_rglru_scan(*args)
    nudged = want.clone()
    nudged[0, 5, 7] = torch.nextafter(nudged[0, 5, 7],
                                      torch.tensor(float("inf")))
    results = iter([want, nudged] * 2)
    monkeypatch.setattr(rglru, "rglru_scan", lambda *a: next(results))
    with pytest.raises(AssertionError, match="past the limit"):
        cs._rglru_check(rglru, [args], "changing")
    with pytest.raises(AssertionError, match="past the limit"):
        cs._rglru_check_witness(rglru, [args], "changing")


def test_rglru_generic_cases_reach_both_routes():
    """RGLRU_GENERIC holds a W off a multiple of 4 with S off the stage and
    a base off 16 bytes: both take the forward kernel's cp.async route,
    every other case its TMA route, and each operand is the contiguous
    (B, S, W) asked for."""
    from repro_torch.kernels import rglru

    gen = torch.Generator().manual_seed(2)
    routes = {}
    for shape in cs.RGLRU_GENERIC:
        a, b = cs._rglru_operands(gen, shape, "cpu")
        assert a.shape == b.shape == tuple(shape[:3])
        assert a.is_contiguous() and b.is_contiguous()
        assert a.storage_offset() == (shape[3] if len(shape) > 3 else 0)
        routes[tuple(shape)] = rglru.tma_route(a, b, torch.empty_like(a))
    assert routes[(2, 77, 75)] is False and 77 % cs.RGLRU_STAGE
    assert routes[(3, 130, 96, 1)] is False
    assert sum(routes.values()) == len(routes) - 2


def test_rglru_generic_checks_run_on_the_cpu():
    """Phase 3's RG-LRU checks, forward and backward, over every
    RGLRU_GENERIC case (a base off 16 bytes among them), with the plain
    versions standing in for the kernels."""
    from repro_torch.kernels import rglru

    gen = torch.Generator().manual_seed(2)
    assert cs._rglru_check(rglru, [cs._rglru_operands(gen, s, "cpu")
                                   for s in cs.RGLRU_GENERIC],
                           "generic") >= 0.0
    assert cs._rglru_bwd_check(rglru, [cs._rglru_bwd_operands(gen, s, "cpu")
                                       for s in cs.RGLRU_GENERIC],
                               "generic") >= 0.0


# ---------------------------------------------------- MoE routing gate ---
def _routes(logits, idx):
    """One MoE layer's routing of 8 tokens (2 sequences of 4) to 1 of 4
    experts, no drops."""
    logits = torch.tensor(logits, dtype=torch.float32)[None]  # (1, 8, 4)
    idx = torch.tensor(idx)[None, :, None]
    return [types.SimpleNamespace(logits=logits, idx=idx,
                                  keep=torch.ones_like(idx, dtype=torch.bool))]


CPU_LOGITS = [[1.0, 0.0, -1.0, -1.0]] * 8


@pytest.mark.parametrize("case", ["near-tie", "past-flip-off", "not-near-tie",
                                  "before-flip-off"])
def test_moe_gate_on_a_hand_made_routing(case):
    """Token 1 of the first sequence takes expert 1 on the card where the
    CPU's router takes expert 0.  At a near tie, with the later tokens of
    that sequence far from the CPU's own run but equal to the replay, the
    gate passes; a token past the flip off the replay, a flip that is no
    near tie, or a token before the flip off the CPU's run raise."""
    cpu_logits = [row[:] for row in CPU_LOGITS]
    cpu_logits[1] = [1.0, 0.999 if case != "not-near-tie" else 0.0, -1.0,
                     -1.0]
    cpu = _routes(cpu_logits, [0] * 8)
    card = _routes(cpu_logits, [0, 1, 0, 0, 0, 0, 0, 0])
    gen = torch.Generator().manual_seed(0)
    own = torch.randn((8, 4), generator=gen)
    got = own.clone()
    got[1:4] += 0.5  # the flip's sequence from the flip on: another path
    replayed = got.clone()
    if case == "past-flip-off":
        replayed[2] += 0.1
    if case == "before-flip-off":
        got[0] += 0.1
        replayed[0] += 0.1
    if case == "near-tie":
        line = cs._moe_gate(got, own, replayed, card, cpu, rows=2)
        assert "1 of 8 tokens keep other experts" in line
        assert "the 5 tokens before their sequence's first" in line
    else:
        match = ("near ties" if case == "not-near-tie"
                 else "differ past the limit")
        with pytest.raises(AssertionError, match=match):
            cs._moe_gate(got, own, replayed, card, cpu, rows=2)


# ------------------------------------------------------ min-plus scan ---
@pytest.mark.parametrize("key, n_ops, n_bytes", [
    ((1, 5, 4), 152, 784), ((1, 3, 8), 288, 1_360),
    ((512, 5, 4), 77_824, 401_408), ((512, 3, 8), 147_456, 696_320),
    ((1, 1, 4), 8, 80)], ids=str)
def test_scan_bound_at_the_path_shapes(key, n_ops, n_bytes):
    """Path 1's scans (bcd_torch's batch-1 tours and the warm pass's
    groups of 512) and a scan of no step: bound by their bytes, well under
    a microsecond, so the kernel stays at the launch floor."""
    ms, by, ops, nbytes = cs._scan_bound(key)
    assert (ops, nbytes) == (n_ops, n_bytes)
    assert by == "bytes"
    assert ms == pytest.approx(n_bytes / 3.35e12 * 1e3)
    assert ms > n_ops / 34e12 * 1e3
    assert ms < 1e-3


@pytest.fixture
def plain_scans(monkeypatch):
    """Counts the scans made, apart from chip_smoke's recording: each call
    of the plain version, which the wrapper takes on CPU tensors."""
    made = {"n": 0}
    ref = mp.minplus_scan_reference

    def counting(*args, **kw):
        made["n"] += 1
        return ref(*args, **kw)

    monkeypatch.setattr(mp, "minplus_scan_reference", counting)
    return made


def test_recorded_passes_sees_every_scan(plain_scans):
    """run_main_path's recording, rehearsed on the CPU over sequential and
    pipelined instances through dfts_torch and bcd_torch: the recorded
    minplus_scan calls are the scans made, per pass and in all, and the CPU
    launches no kernel."""
    problems = cs.build_population(T)[56:72]
    before, scan = mp.scan_launch_count, TS.minplus_scan
    run = cs.recorded_passes(T, TS, mp, [
        ("dfts", problems, "dfts_torch"), ("dfts again", problems,
                                           "dfts_torch"),
        ("bcd", problems[6:10], "bcd_torch")], "cpu")
    shapes, operands = run["recorded"]
    passes = run["passes"]
    assert sum(shapes.values()) == plain_scans["n"] == sum(
        r["scans"] for r in passes.values())
    assert passes["dfts"]["scans"] == passes["dfts again"]["scans"] < 16
    assert passes["bcd"]["scans"] > 0
    assert mp.scan_launch_count == before
    assert all(r["launches"] == 0 for r in passes.values())
    for key, recorded in operands.items():
        assert 0 < len(recorded) <= cs.RECORDED_OPERANDS
        assert all(tuple(args[0].shape) == key for args, _ in recorded)
    assert TS.minplus_scan is scan  # the recorder is taken out again


def test_host_split_times_each_part_and_restores_the_functions():
    problems = cs.build_population(T)[56:72]
    originals = {name: getattr(TS, name) for name in cs.HOST_SPLIT.values()}
    with cs.timed_calls(TS, cs.HOST_SPLIT) as spent:
        T.solve_batch(problems, "dfts_torch", dedup=False, device="cpu")
    assert set(spent) == set(cs.HOST_SPLIT)
    assert all(s > 0.0 for s in spent.values())
    assert all(getattr(TS, name) is fn for name, fn in originals.items())


# ------------------------------------------------------------- path 3 ---
# reduced traffic: qwen2 and mamba2 pad to 32 (two SSD chunks of 16) and
# decode 16 (the forward over 48 is three); qwen3-moe's four prompts pad to
# 12, so that with MoE groups of 16 (``moe_groups``) the prefill's 48
# tokens are three groups and the forward's 4 x 20 five, as the card's are
# whole groups of 1,024, and a decode step routes its 4 tokens at C 2;
# recurrentgemma's and gemma2's 40-token prompts overfill their 32-slot
# rings, which every decode step wraps
SERVE_REHEARSAL = {
    "qwen2-1.5b": cs.ServeTraffic(2, 20, 32, 16, 48),
    "mamba2-370m": cs.ServeTraffic(2, 20, 32, 16, 48),
    "qwen3-moe-30b-a3b": cs.ServeTraffic(4, 8, 12, 8, 24),
    "recurrentgemma-9b": cs.ServeTraffic(1, 40, 40, 8, 48),
    "gemma2-27b": cs.ServeTraffic(1, 40, 40, 8, 48),
}


def install_cpu_launches(monkeypatch):
    """The kernels' modules, with each wrapper at the site chip_smoke.py
    records counting its CPU calls as launches (through ``monkeypatch``),
    and torch.cuda's synchronise and memory statistics made no-ops."""
    mods = {m: importlib.import_module(f"repro_torch.kernels.{m}")
            for m in dict.fromkeys(map(cs._module, cs.KERNELS))}
    for name, spec in cs.KERNELS.items():
        mod = mods[cs._module(name)]
        monkeypatch.setattr(mod, spec.counter, getattr(mod, spec.counter))
        site = importlib.import_module(spec.site[0])

        def counting(*args, _fn=getattr(site, spec.site[1]), _mod=mod,
                     _count=spec.counter, **kw):
            setattr(_mod, _count, getattr(_mod, _count) + 1)
            return _fn(*args, **kw)

        monkeypatch.setattr(site, spec.site[1], counting)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **kw: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a, **kw: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda *a, **kw: 0)
    monkeypatch.setattr(cs, "_card_line", lambda: "the CPU (rehearsal)")
    return mods


@pytest.fixture
def cpu_launches(monkeypatch):
    """``install_cpu_launches``, the counts restored after the test."""
    return install_cpu_launches(monkeypatch)


def _serve(name, mods):
    """run_serve_path, and for an MoE model run_moe_serve_cut on its cut,
    as run_model_path runs them."""
    cfg = ARCHS[name].reduced()
    params = MT.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    run = cs.run_serve_path(name, cfg, params, SERVE_REHEARSAL[name],
                            cs.MODELS[name].kernels, mods, "cpu")
    if cfg.n_experts:
        run.update(cs.run_moe_serve_cut(name, *cs.serve_cut(cfg, params),
                                        SERVE_REHEARSAL[name], "cpu"))
    return run


@pytest.mark.usefixtures("moe_groups")
@pytest.mark.parametrize("name", list(SERVE_REHEARSAL))
def test_serve_path_rehearsed_on_the_cpu(name, cpu_launches, capsys,
                                        monkeypatch):
    """run_serve_path at reduced size in bf16, the plain versions standing
    in for the kernels: every gate passes, the prefill's kernel calls are
    counted and recorded, one call a layer of each kind (the expert matmul
    three an MoE layer in the prefill and in every decode step), and the
    serving numbers are printed; for qwen3-moe the no-drop check takes
    every row and the CPU gate SERVE_CPU_STEPS decode steps after a
    prefill of the prompts' last 8 tokens (two groups of 16 over the 4
    rows, as the card's 128 are four of 1,024 over 32)."""
    cfg = ARCHS[name].reduced()
    traffic = SERVE_REHEARSAL[name]
    monkeypatch.setattr(cs, "SERVE_CPU_TOKENS", 8)
    run = _serve(name, cpu_launches)
    kinds = MT.layer_kinds(cfg.n_layers, cfg.pattern)
    per_layer = {"flash_attention": ("attn", "local_attn", "moe"),
                 "ssd": ("ssd",), "rglru": ("rglru",)}
    for k in cs.KERNELS:
        want = sum(kind in per_layer.get(k, ()) for kind in kinds)
        if k == "moe_gmm":
            want = 3 * kinds.count("moe") * traffic.max_new
        assert run["launches"][k] == want
        assert sum(run["recorded"][k][0].values()) == want
    out = capsys.readouterr().out
    assert "the same tokens as the loop" in out
    assert "tokens/s" in out and "p90" in out and "byte bound" in out
    assert run["cache_bytes"] > 0 and run["tokens_per_s"] > 0
    assert run["decode_ms_p50"] <= run["decode_ms_p90"]
    assert run["decode_bound_ms"] > 0
    if cfg.n_experts:
        assert "each of the 7 decode steps moe_gmm 6" in out
        assert run["no_drop_rows"] == traffic.batch
        assert run["cpu_steps"] == min(cs.SERVE_CPU_STEPS,
                                       traffic.max_new - 1)
        assert "(no slot drops), 4 of 4 rows" in out
        assert "all 4 rows of their last 8 prompt tokens" in out


@pytest.mark.usefixtures("moe_groups")
@pytest.mark.parametrize("fault", ["attention", "ssd", "moe", "capacity"])
def test_serve_path_rejects_a_wrong_decode(fault, cpu_launches,
                                           monkeypatch):
    """The teacher-forced gate fails a decode whose attention masks out
    the new token's own key, one whose SSD prefill hands the decode steps
    a zero state, and one whose decode steps leave out the MoE FFN's
    output (the no-drop check at 2 layers); the capacity gate fails a
    decode step whose MoE capacity is taken over the cache's length
    instead of the step's own tokens (it then drops no slot, which no
    comparison of two runs of the same code can see)."""
    if fault == "moe":
        ffn = ML.moe_ffn

        def wrong(p, cfg, x):
            y, aux = ffn(p, cfg, x)
            return (torch.zeros_like(y) if x.shape[1] == 1 else y), aux

        monkeypatch.setattr(ML, "moe_ffn", wrong)
        with pytest.raises(AssertionError, match="no-drop teacher-forced"):
            _serve("qwen3-moe-30b-a3b", cpu_launches)
        return
    if fault == "capacity":
        traffic, route = SERVE_REHEARSAL["qwen3-moe-30b-a3b"], ML.moe_route

        def wrong(router, cfg, toks):
            r = route(router, cfg, toks)
            if toks.shape[1] != traffic.batch:  # not a decode step's group
                return r
            C = max(1, int(traffic.cache_len * cfg.moe_top_k
                           / cfg.n_experts * cfg.capacity_factor))
            return ML.routing_of_picks(r.logits, r.probs, r.idx, C)

        monkeypatch.setattr(ML, "moe_route", wrong)
        with pytest.raises(AssertionError, match="not the reference's"):
            _serve("qwen3-moe-30b-a3b", cpu_launches)
        return
    if fault == "attention":
        attend = ML._decode_attention

        def wrong(cfg, q, k, v, q_positions, kv_positions, window=None):
            return attend(cfg, q, k, v, q_positions - 1, kv_positions,
                          window)

        monkeypatch.setattr(ML, "_decode_attention", wrong)
        name = "qwen2-1.5b"
    else:
        forward = ML.ssd_forward

        def wrong(*args):
            y, h = forward(*args)
            return y, torch.zeros_like(h)

        monkeypatch.setattr(ML, "ssd_forward", wrong)
        name = "mamba2-370m"
    with pytest.raises(AssertionError, match="teacher-forced"):
        _serve(name, cpu_launches)


# ------------------------------------------------- path 2, the last four ---
# run_model_path for the configs path 2 added last, reduced: gemma2 at B 1
# x S 64 (past its window of 32; path 3's traffic SERVE_REHEARSAL's),
# arctic (2 layers, as on the card), qwen3-14b and starcoder2 at B 2 x S
# 32; the card-vs-CPU check at S 16 (arctic's at its first layer, as on the
# card), path 7's forward on the same traffic in two microbatches
MODEL_REHEARSAL = {"gemma2-27b": (1, 64), "arctic-480b": (2, 32),
                   "qwen3-14b": (2, 32), "starcoder2-7b": (2, 32)}


def _wall_ms(fn, *_args) -> float:
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


@pytest.fixture
def model_rehearsal(cpu_launches, monkeypatch):
    """The patches run_model_path needs on the CPU: the reduced configs of
    MODEL_REHEARSAL's models, their traffic, CHECK_SEQ 16, the profiler's
    chain run timed by the wall, MoE groups of 16 tokens (a microbatch of
    32 is two, as on the card) and GMM_TILE 16 (the reduced D of 64 is under
    three tiles); yields the kernels' modules."""
    monkeypatch.setattr(ML, "MOE_GROUP", 16)
    monkeypatch.setattr(cs, "GMM_TILE", 16)
    monkeypatch.setattr(cs, "CHECK_SEQ", 16)
    monkeypatch.setattr(cs, "_device_us",
                        lambda fn: (_wall_ms(fn) * 1e3, 0.0, {}))
    monkeypatch.setattr(cs, "_kernel_device_ms",
                        lambda fn, calls, must_see, bound_ms=None:
                        _wall_ms(fn))
    monkeypatch.setattr(cs, "_held_queue_ms", _wall_ms)
    for name, (batch, seq) in MODEL_REHEARSAL.items():
        monkeypatch.setitem(ARCHS, name, ARCHS[name].reduced())
        monkeypatch.setitem(cs.MODELS, name, cs.MODELS[name]._replace(
            batch=batch, seq=seq))
        monkeypatch.setitem(cs.PIPELINE, name, cs.PipeTraffic(2, seq))
    monkeypatch.setitem(cs.SERVE, "gemma2-27b",
                        SERVE_REHEARSAL["gemma2-27b"])
    return cpu_launches


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("name", list(MODEL_REHEARSAL))
def test_model_path_of_the_last_configs_rehearsed_on_the_cpu(
        name, model_rehearsal, capsys):
    """run_model_path at reduced size, the plain versions standing in for
    the kernels: every gate of paths 2 and 7 passes (the chain ``==``
    apply_stack, the card-vs-CPU check, each microbatch ``==`` its
    forward), and for gemma2 path 3's; the scan and the model's kernels
    launch, each call recorded, flash once a layer and the expert matmul
    three times an MoE layer; arctic's card-vs-CPU check is printed as
    narrowed to its first layer."""
    run = cs.run_model_path(name, model_rehearsal, "cpu")
    cfg = ARCHS[name]
    kinds = MT.layer_kinds(cfg.n_layers, cfg.pattern)
    assert run["launches"]["minplus_scan"] > 0
    assert run["launches"]["flash_attention"] == len(kinds)
    assert run["launches"]["moe_gmm"] == 3 * kinds.count("moe_dense")
    for k in cs.KERNELS:
        assert sum(run["recorded"][k][0].values()) == run["launches"][k]
    assert run["pipeline"]["launches"]["flash_attention"] == \
        cs.PIPE_MICRO * len(kinds)
    assert (run["serve"] is not None) == (name == "gemma2-27b")
    out = capsys.readouterr().out
    assert "chain's hidden state == monolithic apply_stack" in out
    assert "pipelined forward == T.forward of each microbatch's rows" in out
    narrowed = "the card-vs-CPU check narrowed to the first 1 of the 2 layers"
    assert (narrowed in out) == (name == "arctic-480b")
    n = 1 if name == "arctic-480b" else 2 * len(cfg.pattern)
    assert f"{name}: first {n} blocks at S 16" in out
    if name == "gemma2-27b":
        assert "the same tokens as the loop" in out


@pytest.mark.usefixtures("one_thread")
def test_operand_cap_keeps_one_host_set_and_times_it_alone(
        model_rehearsal, monkeypatch, capsys):
    """With RECORDED_BYTES_CAP below the expert matmul's operand sets and
    above flash attention's (32 KiB against 42-52 KiB and 16 KiB at
    reduced size, as arctic-480b's expert products pass it on the card and
    its attention does not), a recorded shape past it keeps one set,
    copied to the host, the expert weights that paths 2 and 7 both record
    copied once and taken from there by the card-vs-CPU check; once the
    model's weights are freed each such shape is checked and timed alone
    (``settle_big_shapes``) and its operands dropped, and the kernel phase
    takes its row as settled."""
    monkeypatch.setattr(cs, "RECORDED_BYTES_CAP", 2 ** 15)
    settled, settle = [], cs._settle

    def watched(name, mod, s, calls, launches, device):
        assert len(calls) == 1
        assert all(t.device.type == "cpu" for t in calls[0][0])
        settled.append((name, s, calls[0][0][1]))
        return settle(name, mod, s, calls, launches, device)

    monkeypatch.setattr(cs, "_settle", watched)
    hosted = []
    on_host = cs._on_host
    monkeypatch.setattr(cs, "_on_host",
                        lambda t: hosted.append(on_host(t)) or hosted[-1])
    run = cs.run_model_path("arctic-480b", model_rehearsal, "cpu")
    assert {name for name, _, _ in settled} == {"moe_gmm"}
    weights = {}
    for _, s, w in settled:
        weights.setdefault(s[1], set()).add(id(w))
    assert len(weights) == 2  # path 2's C and path 7's
    assert weights[max(weights)] == weights[min(weights)]  # one host copy
    assert weights[min(weights)] <= {id(t) for t in hosted}
    records = [run["recorded"]["moe_gmm"], run["pipeline"]["recorded"][
        "moe_gmm"]]
    for _, operands in records:
        assert all(isinstance(v, cs.Settled) for v in operands.values())
    out = capsys.readouterr().out
    n_settled = out.count("checked and timed alone")
    assert n_settled == len(settled) > 0
    merged = cs._merge(records)
    row = cs.check_model_path(
        "moe_gmm", model_rehearsal["moe_gmm"], merged,
        {"arctic-480b": run["launches"]["moe_gmm"],
         "pipeline/arctic-480b": run["pipeline"]["launches"]["moe_gmm"]},
        0.0, "cpu")
    assert "checked and timed alone" not in capsys.readouterr().out
    assert len(row["shapes"]) == len(merged[0])
    assert [r["launches"] for r in row["shapes"]] == sorted(
        merged[0].values(), reverse=True)
    assert row["launches"] == sum(merged[0].values())


def test_an_unsettled_shape_past_the_cap_raises(monkeypatch):
    """The kernel phase takes a shape past RECORDED_BYTES_CAP only as its
    model's turn settled it: one that arrives with its operands raises."""
    monkeypatch.setattr(cs, "RECORDED_BYTES_CAP", 2 ** 10)
    s = (4, 8, 32, 16, "silu")  # 6 KiB of operands
    call = cs.KERNELS["moe_gmm"].random_operands(
        torch.Generator().manual_seed(0), s, {}, "cpu")
    recorded = (collections.Counter({s: 3}), {s: [call]})
    with pytest.raises(AssertionError, match="no turn settled"):
        cs.check_model_path("moe_gmm", importlib.import_module(
            "repro_torch.kernels.moe_gmm"), recorded, {"arctic-480b": 3},
            0.0, "cpu")


def test_new_generic_flash_rows_pass_check_generic(monkeypatch):
    """The FLASH_GENERIC rows of head groups 5, 7 and 9 and of gemma2-27b's
    mask through ``check_generic`` on the CPU (forward and backward against
    the plain versions there; the card holds the kernels to them), the
    other kernels' lists cut to their first case."""
    rows = cs.FLASH_GENERIC[-4:]
    assert [hq // hkv for _, _, _, hq, hkv, *_ in rows[:3]] == [5, 7, 9]
    assert rows[3][5:] == (128, True, 256, 50.0)
    monkeypatch.setattr(cs, "FLASH_GENERIC", rows)
    for name in ("SSD_GENERIC", "GMM_GENERIC", "RGLRU_GENERIC"):
        monkeypatch.setattr(cs, name, getattr(cs, name)[:1])
    mods = {m: importlib.import_module(f"repro_torch.kernels.{m}")
            for m in dict.fromkeys(map(cs._module, cs.KERNELS))}
    errs = cs.check_generic(mods, "cpu")
    assert set(errs) >= {"flash_attention", "flash_attention_bwd"}


# ------------------------------------------------------------- path 4 ---
# reduced traffic: B 2 x S 32 (two SSD chunks of 16), four steps; the
# card-vs-CPU gradient check at S 16; the models at four layers (four
# pattern groups, so that the TR plan has stages to chain), recurrentgemma
# at six (two repetitions of rglru, rglru, local_attn), as the card runs it
TRAIN_REHEARSAL = {name: cs.TrainTraffic(2, 32, 4, cs.TRAIN[name].kernels)
                   for name in cs.TRAIN}
REHEARSAL_LAYERS = {"qwen2-1.5b": 4, "mamba2-370m": 4,
                    "qwen3-moe-30b-a3b": 4, "recurrentgemma-9b": 6}
# (forward, backward) launches of a train step (remat on), each kernel
TRAIN_STEP_LAUNCHES = {
    "qwen2-1.5b": {"flash_attention": (8, 4)},
    "mamba2-370m": {"ssd": (8, 4)},
    "qwen3-moe-30b-a3b": {"flash_attention": (8, 4), "moe_gmm": (24, 12)},
    "recurrentgemma-9b": {"flash_attention": (4, 2), "rglru": (8, 4)},
}


class _PlainWithBackward(torch.autograd.Function):
    """The CPU's plain forward (through the site's counting wrapper) with
    its backward routed through the backward wrapper, as the card's
    autograd Functions route theirs, so that the rehearsal counts the
    backward launches; on the CPU both wrappers take the plain
    versions."""

    @staticmethod
    def forward(ctx, fwd, bwd, kw, *args):
        outs = fwd(*args, **kw)
        ctx.bwd, ctx.kw = bwd, kw
        ctx.save_for_backward(*args, *cs._tuple(outs))
        return outs

    @staticmethod
    def backward(ctx, *cot):
        saved = ctx.saved_tensors
        grads = ctx.bwd(saved, cot, ctx.kw)
        return (None, None, None, *grads)


def route_backward(monkeypatch, gmm_bwd, rglru_bwd):
    """The model's expert matmul and RG-LRU scan (``layers.expert_matmul``,
    ``layers.rglru_scan``, as they stand) with their backward taken through
    ``gmm_bwd(x, w, dy, activation=..., z=...)`` (z the forward's
    pre-activation in the operands' type, as the card's forward keeps it;
    None without an activation) and ``rglru_bwd(a, h, g)``
    (``_PlainWithBackward``), as the card's autograd Functions take
    theirs."""
    from repro_torch.kernels import moe_gmm

    gmm_site, rglru_site = ML.expert_matmul, ML.rglru_scan

    def gmm(x, w, activation="none"):
        z = (moe_gmm.reference_expert_matmul(
            x.detach(), w.detach(), activation=activation, keep_z=True)[1]
            if activation != "none" else None)
        return _PlainWithBackward.apply(
            gmm_site, lambda saved, cot, kw: gmm_bwd(*saved[:2], cot[0],
                                                     z=z, **kw),
            {"activation": activation}, x, w)

    def scan(a, b):
        return _PlainWithBackward.apply(
            rglru_site, lambda saved, cot, kw: rglru_bwd(saved[0], saved[2],
                                                         cot[0]), {}, a, b)

    monkeypatch.setattr(ML, "expert_matmul", gmm)
    monkeypatch.setattr(ML, "rglru_scan", scan)


def install_cpu_backward(monkeypatch, cpu_launches):
    """``cpu_launches`` (``install_cpu_launches``'s modules), with the
    backward of flash attention, SSD, the expert matmul and the RG-LRU
    scan taken through their backward wrappers (``_PlainWithBackward``)."""
    fa = cpu_launches["flash_attention"]
    ssd = cpu_launches["ssd"]
    from repro_torch.kernels import ops

    flash_site, ssd_site = ML.flash_attention, ops.ssd_intra_chunk
    gmm, rglru = cpu_launches["moe_gmm"], cpu_launches["rglru"]
    route_backward(monkeypatch,
                   lambda *a, **kw: gmm.expert_matmul_bwd(*a, **kw),
                   lambda *a: rglru.rglru_scan_bwd(*a))

    def flash_bwd(saved, cot, kw):
        q, k, v, _ = saved
        lse = fa.reference_lse(q, k, **kw)
        return fa.flash_attention_bwd(q, k, v, lse, cot[0], **kw)

    def flash(q, k, v, **kw):
        return _PlainWithBackward.apply(flash_site, flash_bwd, kw, q, k, v)

    def ssd_bwd(saved, cot, kw):
        return ssd.ssd_intra_chunk_bwd(*saved[:5], *cot)

    def intra(*args):
        return _PlainWithBackward.apply(ssd_site, ssd_bwd, {}, *args)

    monkeypatch.setattr(ML, "flash_attention", flash)
    monkeypatch.setattr(ops, "ssd_intra_chunk", intra)
    monkeypatch.setattr(cs, "CHECK_SEQ", 16)
    monkeypatch.setattr(cs, "_device_us", lambda fn: (cs._wall(fn) * 1e6,
                                                      0.0, {}))
    return cpu_launches


@pytest.fixture
def cpu_backward(cpu_launches, monkeypatch):
    """``install_cpu_backward`` on ``cpu_launches``."""
    return install_cpu_backward(monkeypatch, cpu_launches)


@pytest.mark.parametrize("name", list(TRAIN_REHEARSAL))
def test_train_path_rehearsed_on_the_cpu(name, cpu_backward, capsys):
    """run_train_path at reduced size in bf16, the plain versions standing
    in for the kernels: the round trip's and the train steps' gates pass,
    with one forward and one backward call a layer of each kernel's kinds
    (three of the expert matmul's) in the round trip and twice the forward
    calls (rematerialised) and one backward in each step, counted and
    recorded, and the loss falling.  For MoE the gradient gate replays the
    card's expert picks on the CPU and prints every leaf by name."""
    cfg = ARCHS[name].reduced(n_layers=REHEARSAL_LAYERS[name])
    traffic = TRAIN_REHEARSAL[name]
    params = MT.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    run = cs.run_train_path(name, cfg, params, traffic, cpu_backward, "cpu")
    rt, tr = run["round trip"], run["train"]
    assert [fwd for fwd, _ in traffic.pairs()] == list(
        TRAIN_STEP_LAUNCHES[name])
    for fwd, bwd in traffic.pairs():
        per_step = TRAIN_STEP_LAUNCHES[name][fwd]
        assert cs._train_launches(cfg, fwd) == per_step
        assert (rt["launches"][fwd], rt["launches"][bwd]) == (per_step[1],
                                                             per_step[1])
        assert (tr["launches"][fwd], tr["launches"][bwd]) == tuple(
            4 * n for n in per_step)
    for part in (rt, tr):
        for k in cs.KERNELS:
            assert sum(part["recorded"][k][0].values()) == part["launches"][k]
            for calls in part["recorded"][k][1].values():
                assert all(a.device.type == "cpu" for args, _ in calls
                           for a in args if torch.is_tensor(a))
    assert run["losses"][2] < run["losses"][0]
    out = capsys.readouterr().out
    assert "charges == segment_comp_dir_s" in out and "tokens/s" in out
    assert "parameter gradients" in out and "warm round trip stage 0 BW" in out
    # the card-vs-CPU check reads the weights the round trip ran on, before
    # the steps move them
    assert out.index("parameter gradients") < out.index("train steps (")
    if cfg.n_experts:
        assert "the CPU replayed the card's picks" in out
        assert "router" in out and "w_down" in out


@pytest.mark.parametrize("name,kernel,fault", [
    ("qwen3-moe-30b-a3b", "moe_gmm", "dW without act'"),
    ("recurrentgemma-9b", "rglru", "lambda without a's shift")])
def test_train_gate_rejects_a_wrong_backward_on_the_card(
        name, kernel, fault, cpu_backward, monkeypatch):
    """_train_check_on_cpu fails when the card's backward kernel gives one
    of its check's wrong gradients: the calls of the gate's card runs (its
    first grad_in and parameter-gradient runs) take the wrong gradient,
    the CPU's and the floor's the plain version, so the floor is 0 and
    CHECK_TOL binds."""
    cfg = ARCHS[name].reduced(n_layers=REHEARSAL_LAYERS[name])
    n = cs.TRAIN_CHECK_DEPTH * len(cfg.pattern)
    sub_cfg = dataclasses.replace(cfg, n_layers=n)
    card_calls = 2 * cs._train_launches(sub_cfg, kernel)[1]
    mod = cpu_backward[kernel]
    name_bwd = cs.KERNELS[f"{kernel}_bwd"].site[1]
    right = getattr(mod, name_bwd)
    calls = []

    def wrong(*args, **kw):
        calls.append(1)
        if len(calls) > card_calls or kw.get("activation") == "none":
            return right(*args, **kw)  # (without act', dW is right there)
        if kernel == "moe_gmm":
            return cs._gmm_bwd_wrong_outputs(mod, args, kw)[fault]
        return cs._rglru_bwd_wrong_outputs(mod, args)[fault]

    monkeypatch.setattr(mod, name_bwd, wrong)
    params = MT.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 32),
                           generator=torch.Generator().manual_seed(4))
    kinds = MT.layer_kinds(cfg.n_layers, cfg.pattern)

    def stage(stack, h):
        pos = torch.arange(h.shape[1]).expand(h.shape[0], h.shape[1])
        for i in range(n):
            h, _, _ = MT.apply_block(stack["layers"][i], cfg, kinds[i], h,
                                     ML.Ctx(mode="prefill", positions=pos),
                                     None)
        return h

    with pytest.raises(AssertionError, match="past the limit"):
        cs._train_check_on_cpu(name, cfg, params, tokens, stage)
    assert len(calls) == 2 * card_calls


@pytest.mark.parametrize("floor", [0.0, 0.0148, 0.0199, 0.02, 0.0207])
def test_train_gate_limit_leaves_check_tol_below_it(floor):
    """Path 4's gradient limit is CHECK_TOL wherever the plain versions on
    the card lie within CHECK_TOL of the CPU, and GRAD_FLOOR_FACTOR times
    that floor only where the floor itself passes CHECK_TOL."""
    want = (cs.CHECK_TOL if floor < cs.CHECK_TOL
            else cs.GRAD_FLOOR_FACTOR * floor)
    assert cs._grad_limit(floor) == want
    assert cs._grad_limit(floor) >= max(cs.CHECK_TOL, floor)
    assert 1.0 < cs.GRAD_FLOOR_FACTOR < cs.FLOOR_FACTOR


@pytest.mark.parametrize("name", ["qwen3-moe-30b-a3b", "recurrentgemma-9b"])
@pytest.mark.parametrize("free", [2 ** 40, 2 ** 20])
def test_fresh_train_path_counts_the_state_first(name, free, cpu_backward,
                                                 monkeypatch, capsys):
    """run_fresh_train_path on the reduced config (the CPU standing in for
    the card): the weights counted before they are allocated, four times
    that held to the card's free memory, then fresh float32 weights at
    TRAIN's depth and path 4 on them; a card without room for the state
    raises before any weight is drawn."""
    from repro_torch import configs

    reduced = ARCHS[name].reduced()
    monkeypatch.setitem(configs.ARCHS, name, reduced)
    layers = cs.TRAIN[name].layers
    monkeypatch.setitem(cs.TRAIN, name, TRAIN_REHEARSAL[name]._replace(
        layers=layers))
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda *a: (free, free))
    drawn = []
    init = MT.init_params
    monkeypatch.setattr(MT, "init_params",
                        lambda *a, **kw: drawn.append(1) or init(*a, **kw))
    if free < 2 ** 30:
        with pytest.raises(AssertionError, match="does not fit"):
            cs.run_fresh_train_path(name, cpu_backward, "cpu")
        assert not drawn
        return
    run = cs.run_fresh_train_path(name, cpu_backward, "cpu")
    assert drawn == [1] and run["losses"][2] < run["losses"][0]
    out = capsys.readouterr().out
    assert f"path 4 at {layers} of {reduced.n_layers} layers" in out
    cfg = dataclasses.replace(reduced, n_layers=layers)
    weights = cs._planned_bytes(cfg, "cpu")
    assert f"{4 * weights} B with their gradients" in out
    assert weights == sum(t.numel() * 4 for t in MT.tree_leaves(
        MT.init_params(torch.Generator().manual_seed(0), cfg, "cpu")))


def _flash_bwd_case():
    gen = torch.Generator().manual_seed(8)
    shape = (1, 130, 130, 4, 2, 32, True, None, None)
    kw = cs._flash_kw(shape)
    return cs._flash_bwd_operands(fa_module(), gen, shape, kw, "cpu"), kw


def fa_module():
    return importlib.import_module("repro_torch.kernels.flash_attention")


@pytest.mark.parametrize("fault", [None, "dK and dV without the sum over "
                                   "the G query heads",
                                   "dQ that ignores the causal mask"])
def test_flash_bwd_check_rejects_wrong_outputs(fault, monkeypatch):
    """The backward check passes the plain version and fails each wrong
    gradient of ``_flash_bwd_wrong_outputs`` standing in for the kernel."""
    fa = fa_module()
    args, kw = _flash_bwd_case()
    cs._flash_bwd_rejects_wrong_outputs(fa, args, kw)
    if fault is None:
        assert cs._flash_bwd_check(fa, [(args, kw)], "plain") >= 0.0
        return
    wrong = cs._flash_bwd_wrong_outputs(fa, args, kw)[fault]
    monkeypatch.setattr(fa, "flash_attention_bwd", lambda *a, **k: wrong)
    with pytest.raises(AssertionError, match="past the limit"):
        cs._flash_bwd_check(fa, [(args, kw)], "wrong")


def test_flash_bwd_witness_is_computed_and_printed(capsys, monkeypatch):
    """The flash backward check's float64 witness on the path's recorded
    operands: each gradient's largest error, over its largest magnitude, of
    the kernel and of the fp32 plain version against the plain version run
    in float64, printed beside the gate.  On the CPU the wrapper is the
    plain version, so the two columns agree; a kernel standing in with the
    plain gradients rounded to bf16 shows that rounding in its column
    alone."""
    fa = fa_module()
    args, kw = _flash_bwd_case()
    exact = fa.reference_attention_bwd(*args, **kw, dtype=torch.float64)
    want = fa.reference_attention_bwd(*args, **kw)
    assert all(e.dtype == torch.float64 for e in exact)
    rows = cs._flash_bwd_witness(want, want, exact)
    assert [name for name, _, _ in rows] == ["dQ", "dK", "dV"]
    assert all(err_k == err_p < 1e-5 for _, err_k, err_p in rows)
    cs._flash_bwd_check(fa, [(args, kw)], "plain", witness=True)
    assert capsys.readouterr().out.count("against float64") == 1
    rounded = tuple(w.to(torch.bfloat16) for w in want)
    monkeypatch.setattr(fa, "flash_attention_bwd", lambda *a, **k: rounded)
    cs._flash_bwd_check(fa, [(args, kw)], "rounded", witness=True)
    line = next(line for line in capsys.readouterr().out.splitlines()
                if "against float64" in line)
    for name, err_k, err_p in cs._flash_bwd_witness(rounded, want, exact):
        assert f"{name} kernel {err_k!r}, plain {err_p!r}" in line
        assert err_p < 1e-5 < err_k <= 2.0 ** -8


@pytest.mark.parametrize("fault", [None, "ddt without the reverse-cumsum "
                                   "term", "dA with its sign flipped"])
def test_ssd_bwd_check_rejects_wrong_outputs(fault, monkeypatch):
    """The backward check (with its float64 witness) passes the plain
    version and fails each wrong gradient of ``_ssd_bwd_wrong_outputs``
    standing in for the kernel."""
    from repro_torch.kernels import ssd

    args = cs._ssd_bwd_operands(torch.Generator().manual_seed(9),
                                (1, 128, 3, 16, 8, 64), "cpu")
    cs._ssd_bwd_rejects_wrong_outputs(ssd, args)
    if fault is None:
        assert cs._ssd_bwd_check(ssd, [args], "plain", witness=True) >= 0.0
        return
    wrong = cs._ssd_bwd_wrong_outputs(ssd, args)[fault]
    monkeypatch.setattr(ssd, "ssd_intra_chunk_bwd", lambda *a: wrong)
    with pytest.raises(AssertionError, match="past a limit"):
        cs._ssd_bwd_check(ssd, [args], "wrong", witness=True)


@pytest.mark.parametrize("fault", [None, "dW without act'",
                                   "dX through W un-transposed",
                                   "act' of Y instead of Z",
                                   "the kernel given Y as Z",
                                   "the kernel given the next expert's Z"])
def test_gmm_bwd_check_rejects_wrong_outputs(fault, monkeypatch):
    """The expert matmul's backward check (with its float64 witness)
    passes the plain version and fails each wrong gradient of
    ``_gmm_bwd_wrong_outputs`` and ``_gmm_bwd_wrong_z`` standing in for the
    kernel, at a ragged D and F with silu, z the forward's pre-activation
    in bf16 (the plain version forms its own)."""
    from repro_torch.kernels import moe_gmm

    args, kw = cs._gmm_bwd_operands(torch.Generator().manual_seed(10),
                                    (3, 70, 50, 33, "silu"), "cpu")
    cs._gmm_bwd_rejects_wrong_outputs(moe_gmm, args, kw)
    if fault is None:
        assert cs._gmm_bwd_check(moe_gmm, [(args, kw)], "plain",
                                 witness=True) >= 0.0
        return
    wrong = {**cs._gmm_bwd_wrong_outputs(moe_gmm, args, kw),
             **cs._gmm_bwd_wrong_z(moe_gmm, args, kw)}[fault]
    monkeypatch.setattr(moe_gmm, "expert_matmul_bwd", lambda *a, **k: wrong)
    with pytest.raises(AssertionError, match="past a limit"):
        cs._gmm_bwd_check(moe_gmm, [(args, kw)], "wrong", witness=True)


@pytest.mark.parametrize("fault", [None, "the case's Z is Y",
                                   "the launch writes Y as Z",
                                   "the launch writes the next expert's Z"])
def test_gmm_keep_z_check_rejects_a_wrong_z(fault, monkeypatch):
    """The check of the forward's launch that keeps Z passes the plain
    version's Z (skipping the product without an activation) and fails a
    case whose Z is the output Y, and a launch that writes Y or the next
    expert's Z as its Z."""
    from repro_torch.kernels import moe_gmm

    gen = torch.Generator().manual_seed(11)
    cases = [cs._gmm_bwd_operands(gen, s, "cpu") for s in (
        (3, 70, 50, 33, "silu"), (2, 64, 48, 40, "gelu"),
        (2, 16, 32, 24, "none"))]
    if fault is None:
        assert cs._gmm_keep_z_check(moe_gmm, cases) >= 0.0
        return
    if fault == "the case's Z is Y":
        (x, w, dy), kw = cases[0]
        cases[0] = ((x, w, dy), {**kw, "z": moe_gmm.expert_matmul(
            x, w, kw["activation"])})
    else:
        right = cs._gmm_forward_with_z

        def launch(gmm, x, w, act):
            y, z = right(gmm, x, w, act)
            return y, (y if "Y" in fault else torch.roll(z, 1, dims=0))

        monkeypatch.setattr(cs, "_gmm_forward_with_z", launch)
    with pytest.raises(AssertionError, match="cases failed"):
        cs._gmm_keep_z_check(moe_gmm, cases)


@pytest.mark.parametrize("fault", [None, "da_t = lambda_t h_t (the shift "
                                   "dropped)", "lambda without a's shift"])
def test_rglru_bwd_check_rejects_wrong_outputs(fault, monkeypatch):
    """The RG-LRU backward check (with its float64 witness) passes the
    plain version and fails each wrong gradient of
    ``_rglru_bwd_wrong_outputs`` standing in for the kernel, over a chunk
    and a half."""
    from repro_torch.kernels import rglru

    args = cs._rglru_bwd_operands(torch.Generator().manual_seed(11),
                                  (2, 192, 40), "cpu")
    cs._rglru_bwd_rejects_wrong_outputs(rglru, args)
    if fault is None:
        assert cs._rglru_bwd_check(rglru, [args], "plain",
                                   witness=True) >= 0.0
        return
    wrong = cs._rglru_bwd_wrong_outputs(rglru, args)[fault]
    monkeypatch.setattr(rglru, "rglru_scan_bwd", lambda *a: wrong)
    with pytest.raises(AssertionError, match="past a limit"):
        cs._rglru_bwd_check(rglru, [args], "wrong", witness=True)


def test_new_backward_bounds_at_the_path_shapes():
    """The expert matmul's backward at qwen3-moe-30b-a3b's gate product:
    two products with silu (Z read from the forward), 257.7 GFLOP, bound by
    the 1.27 GB of x, w, dY, Z, dX and dW at 0.378 ms; without silu, bound
    by the 1.20 GB of x, w, dY, dX and dW at 0.359 ms.  The RG-LRU backward
    at recurrentgemma-9b's shape: a, h, g read and da, db written, 335.5 MB,
    0.100 ms."""
    ms, by, n_ops, n_bytes = cs._gmm_bwd_bound((128, 320, 2048, 768, "silu"))
    assert n_ops == 2 * 2 * 128 * 320 * 2048 * 768 == 257_698_037_760
    assert n_bytes == 1_266_679_808
    assert by == "bytes" and ms == pytest.approx(0.3781, rel=1e-3)
    ms, by, n_ops, n_bytes = cs._gmm_bwd_bound((128, 320, 2048, 768, "none"))
    assert n_bytes == 1_203_765_248 and by == "bytes"
    assert ms == pytest.approx(0.3593, rel=1e-3)
    ms, by, _, n_bytes = cs._rglru_bwd_bound((1, 4096, 4096))
    assert n_bytes == 20 * 4096 * 4096 and by == "bytes"
    assert ms == pytest.approx(0.1002, rel=1e-3)


def test_backward_bounds_at_the_path_shapes():
    """The flash backward's five products are 2.5 times the forward's
    operations: 64.5 GFLOP at qwen2-1.5b's shape, 65 us at 989 TFLOP/s;
    the SSD backward's at mamba2-370m's shape, bound by operations."""
    key = (2, 2048, 12, 2048, 2, 128, True, None, None)
    ms, by, n_ops, _ = cs._flash_bwd_bound(key)
    assert n_ops == 5 * cs._flash_bound(key)[2] // 2 == 64_455_966_720
    assert by == "operations" and ms == pytest.approx(0.0652, rel=1e-3)
    ms, by, n_ops, n_bytes = cs._ssd_bwd_bound((2, 8, 32, 256, 64, 128))
    assert by == "operations" and n_ops > 2 * cs._ssd_work(
        (2, 8, 32, 256, 64, 128))[0]


# ------------------------------------------------- path 5: the serve stack
def _short_stack_runs():
    """``_stack_runs`` with shorter fleets: 8 chains a gateway fleet, 64 in
    the stream; the failure cell stays at 16 (its failures must hit)."""
    size = {"admit": 8, "gateway": 8, "sim": 16}
    out = []
    for run in cs._stack_runs():
        n = 64 if run.fleet["n_requests"] == 512 else size[run.driver]
        out.append(run._replace(fleet=dict(run.fleet, n_requests=n)))
    return out


@pytest.fixture
def counted_scans(monkeypatch):
    """The solvers' ``minplus_scan`` counting its CPU calls as launches
    (the count restored after the test)."""
    monkeypatch.setattr(mp, "scan_launch_count", mp.scan_launch_count)
    scan = TS.minplus_scan

    def counting(*args, **kw):
        mp.scan_launch_count += 1
        return scan(*args, **kw)

    monkeypatch.setattr(TS, "minplus_scan", counting)


def test_serve_stack_path_rehearsed_on_the_cpu(counted_scans, capsys):
    """Path 5 on shortened fleets: every card run == its oracle, each with
    scans, the launches those of the card runs alone, and the recorder and
    the solve log taken out again."""
    import repro_torch.serve as S

    scan, solve = TS.minplus_scan, S.planner.solve
    runs = _short_stack_runs()
    out = cs.run_serve_stack_path(T, TS, mp, device="cpu", runs=runs)
    shapes, operands = out["recorded"]
    assert out["launches"] == mp.scan_launch_count == sum(shapes.values())
    assert out["matmul_launches"] == 0
    assert TS.minplus_scan is scan and S.planner.solve is solve
    assert all(0 < len(ops) <= cs.RECORDED_OPERANDS
               for ops in operands.values())
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("serve stack: ") and " == " in ln]
    assert len(lines) == sum(len(run.pairs) for run in runs)
    assert {(1, 5, 4), (1, 3, 2)} <= set(shapes)  # scalar replans
    assert any(n > 1 for n, _, _ in shapes)  # presolve waves


def _wrong_dfts_torch(monkeypatch, fault):
    """The registry's ``dfts_torch`` with its first feasible result made
    wrong: one plan's middle stage on the stage's other candidate, or the
    latency one ulp high."""
    info = T.get_solver("dfts_torch")  # loads the registry
    done = []

    def spoil(res, candidates):
        if res.plan is None or done:
            return res
        done.append(res)
        if fault == "placement":
            place = list(res.plan.placement)
            place[1] = next(c for c in candidates[1] if c != place[1])
            return dataclasses.replace(
                res, plan=dataclasses.replace(res.plan, placement=place))
        lat = res.latency
        return dataclasses.replace(res, latency=dataclasses.replace(
            lat, computation_s=float(np.nextafter(lat.computation_s,
                                                  np.inf))))

    def fn(net, profile, request, K, candidates, **kw):
        return spoil(info.fn(net, profile, request, K, candidates, **kw),
                     candidates)

    def batch(problems, **kw):
        return [spoil(r, p.candidates)
                for r, p in zip(info.batch_fn(problems, **kw), problems)]

    monkeypatch.setitem(T.engine._REGISTRY, "dfts_torch",
                        dataclasses.replace(info, fn=fn, batch_fn=batch))
    return done


@pytest.mark.parametrize("fault", ["placement", "latency"])
def test_serve_stack_gate_rejects_a_wrong_solver(fault, counted_scans,
                                                 monkeypatch):
    run = next(r for r in _short_stack_runs()
               if r.label.startswith("static"))
    done = _wrong_dfts_torch(monkeypatch, fault)
    with pytest.raises(AssertionError, match="differs from dfts_np"):
        cs.run_serve_stack_path(T, TS, mp, device="cpu", runs=[
            run._replace(pairs=(("dfts_torch", "dfts_np"),))])
    assert len(done) == 1


# ------------------------------------------------- path 6: the sweep engine
@pytest.mark.usefixtures("one_thread")
def test_sweep_path_rehearsed_on_the_cpu(counted_scans, capsys):
    """Path 6 on the quick tier of ``nsfnet_paper`` and the
    ``nsfnet_gateway`` quick tier: every suite == its host run, every
    ``bcd_torch`` spec presolved, the scans launched, the pool == the
    serial run, and the recorder and the presolve watch taken out again."""
    from repro_torch.sweep import runner as WR

    scan, presolve = TS.minplus_scan, WR.SweepRunner._batch_presolve
    out = cs.run_sweep_path(T, TS, mp, device="cpu", card="cpu",
                            quick=True, fleets=("nsfnet_gateway",))
    shapes, operands = out["recorded"]
    assert out["launches"] == sum(shapes.values()) > 0
    assert mp.scan_launch_count > out["launches"]  # the profiled presolve
    assert out["matmul_launches"] == 0
    assert TS.minplus_scan is scan
    assert WR.SweepRunner._batch_presolve is presolve
    assert all(0 < len(ops) <= cs.RECORDED_OPERANDS
               for ops in operands.values())
    lines = capsys.readouterr().out.splitlines()
    assert sum(" == the host's bcd " in ln for ln in lines) == 2
    assert any("36 of 36 single-chain bcd_torch scenarios presolved" in ln
               for ln in lines)
    assert any("spawned workers (cpu) == the serial run" in ln
               for ln in lines)
    assert {(1, 3, 2), (1, 5, 2)} <= set(shapes)


def _wrong_bcd_torch(monkeypatch, fault):
    """The registry's ``bcd_torch`` with its first feasible result made
    wrong: one plan's middle stage on the stage's other candidate, or the
    latency one ulp high."""
    info = T.get_solver("bcd_torch")
    done = []

    def spoil(res, candidates):
        if not res.feasible or done or len(candidates) < 3:
            return res
        done.append(res)
        plan = res.plan
        if fault == "placement":
            place = list(plan.placement)
            place[1] = next(c for c in candidates[1] if c != place[1])
            plan = dataclasses.replace(plan, placement=place)
            return dataclasses.replace(res, plan=plan)
        lat = res.latency
        return dataclasses.replace(res, latency=dataclasses.replace(
            lat, computation_s=float(np.nextafter(lat.computation_s,
                                                  np.inf))))

    def batch(problems, **kw):
        return [spoil(r, p.candidates)
                for r, p in zip(info.batch_fn(problems, **kw), problems)]

    monkeypatch.setitem(T.engine._REGISTRY, "bcd_torch",
                        dataclasses.replace(info, batch_fn=batch))
    return done


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("fault, gate", [
    ("placement", "verify_result fails"),
    ("latency", "differs from the host's bcd")])
def test_sweep_gate_rejects_a_wrong_solver(fault, gate, counted_scans,
                                           monkeypatch):
    """A plan with its middle stage moved fails ``verify_result``; a
    latency an ulp high passes it (it holds to 1e-9) and fails the ``==``
    gate against the host's ``bcd``."""
    done = _wrong_bcd_torch(monkeypatch, fault)
    with pytest.raises(AssertionError, match=gate):
        cs.run_sweep_path(T, TS, mp, device="cpu", card="cpu", quick=True,
                          fleets=())
    assert len(done) == 1


# ------------------------------------------------ path 7: the pipeline ---
# reduced configs deepened to four groups (recurrentgemma to two full
# repetitions and its two remainder layers, at S 64 past its window of 32),
# B 2 in two microbatches
PIPE_REHEARSAL = {
    "qwen2-1.5b": (4, cs.PipeTraffic(2, 32)),
    "mamba2-370m": (4, cs.PipeTraffic(2, 32)),
    "qwen3-moe-30b-a3b": (4, cs.PipeTraffic(2, 32)),
    "recurrentgemma-9b": (8, cs.PipeTraffic(2, 64)),
}


def _pipe(name, mods):
    n_layers, traffic = PIPE_REHEARSAL[name]
    cfg = ARCHS[name].reduced(n_layers=n_layers)
    params = MT.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    return cfg, params, cs.run_pipeline_path(name, cfg, params, traffic,
                                             mods, "cpu")


@pytest.fixture
def moe_groups(monkeypatch):
    """MoE dispatch groups of 16 tokens: a microbatch of 32 is two groups,
    as one of 2,048 is two of 1,024 on the card, so that its routing is
    the whole batch's."""
    monkeypatch.setattr(ML, "MOE_GROUP", 16)


@pytest.mark.usefixtures("one_thread", "moe_groups")
@pytest.mark.parametrize("name", list(PIPE_REHEARSAL))
def test_pipeline_path_rehearsed_on_the_cpu(name, cpu_launches, capsys):
    """run_pipeline_path at reduced size in bf16, the plain versions
    standing in for the kernels: every gate passes (each microbatch
    ``==`` its forward, the aux ``==``, the whole batch within CHECK_TOL,
    route-aware for MoE), and the plan's scans and the model's kernel
    calls are counted and recorded, M calls a layer."""
    cfg, _, run = _pipe(name, cpu_launches)
    kinds = MT.layer_kinds(cfg.n_layers, cfg.pattern)
    per_layer = {"flash_attention": ("attn", "local_attn", "moe"),
                 "ssd": ("ssd",), "rglru": ("rglru",)}
    for k, kk in per_layer.items():
        want = cs.PIPE_MICRO * sum(kind in kk for kind in kinds)
        assert run["launches"][k] == want
    assert run["launches"]["minplus_scan"] > 0
    if cfg.n_experts:
        assert run["launches"]["moe_gmm"] > 0
    for k in cs.KERNELS:
        assert sum(run["recorded"][k][0].values()) == run["launches"][k]
    out = capsys.readouterr().out
    assert "pipelined forward == T.forward of each microbatch's rows" in out
    assert run["K"] >= 2 and run["segments"][-1][1] == -(
        -cfg.n_layers // len(cfg.pattern))


def _late_schedule(stack, h_mb, *, cfg, mesh, plan, n_micro):
    """The GPipe schedule with every hand-off delivered one tick late (a
    stage first reads zeros, then its predecessor's output of two ticks
    before)."""
    from repro_torch.msl import pipeline as MP

    K, M = plan.K, n_micro
    mb, S = h_mb[0].shape[:2]
    ctx = ML.Ctx(mode="train", positions=torch.arange(S).expand(mb, S))
    first = [lo - 1 for lo, _ in plan.segments]
    zero = torch.zeros(())
    received = pending = [(torch.zeros_like(h_mb[0]), zero)] * K
    outs, auxes = [None] * M, [None] * M
    for t in range(M + K - 1):
        sent = list(pending)
        for s in range(K):
            if not s <= t < s + M:
                continue
            x, aux = (h_mb[t], zero) if s == 0 else received[s]
            y, aux = MP._stage_apply(stack.stages[s], first[s], cfg, x, aux,
                                     ctx)
            if s == K - 1:
                outs[t - (K - 1)], auxes[t - (K - 1)] = y, aux
            else:
                sent[s + 1] = (y, aux)
        received, pending = pending, sent
    return outs, auxes


@pytest.mark.usefixtures("one_thread", "moe_groups")
@pytest.mark.parametrize("fault", ["late hand-off", "aux over M"])
def test_pipeline_gate_rejects_a_wrong_schedule(fault, cpu_launches,
                                                monkeypatch):
    """A schedule that hands each stage's output on one tick late fails the
    per-microbatch ``==`` gate; an aux divided by M instead of M + K - 1
    fails the aux gate (on the MoE model, whose aux is not 0)."""
    from repro_torch.msl import pipeline as MP

    if fault == "late hand-off":
        monkeypatch.setattr(MP, "pipelined_apply", _late_schedule)
        name, match = "qwen2-1.5b", "pipelined hidden state differs"
    else:
        forward = MP.pipeline_forward

        def over_m(params, batch, cfg, mesh, plan, n_micro):
            h, aux = forward(params, batch, cfg, mesh, plan, n_micro)
            return h, aux * (n_micro + plan.K - 1) / n_micro

        monkeypatch.setattr(MP, "pipeline_forward", over_m)
        name, match = "qwen3-moe-30b-a3b", "pipelined aux"
    with pytest.raises(AssertionError, match=match):
        _pipe(name, cpu_launches)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("name", ["qwen2-1.5b", "mamba2-370m"])
def test_pipeline_train_path_rehearsed_on_the_cpu(name, cpu_backward,
                                                  capsys):
    """run_pipeline_train_path at reduced size: the pipelined gradients of
    the first two repetitions against the sequential loss's, then four
    steps with two forward calls (rematerialised) and one backward a layer
    and microbatch each, counted and recorded, and the loss falling."""
    n_layers, traffic = PIPE_REHEARSAL[name]
    cfg = ARCHS[name].reduced(n_layers=n_layers)
    sequential = {"losses": [], "step_ms_p50": 1.0, "tokens_per_s": 1.0,
                  "peak_bytes": 0}
    run = cs.run_pipeline_train_path(
        name, cfg, TRAIN_REHEARSAL[name], cpu_backward, "cpu", sequential)
    fwd, bwd = TRAIN_REHEARSAL[name].kernels
    assert cs._pipe_train_launches(cfg, fwd, 2) == (16, 8)
    assert (run["launches"][fwd], run["launches"][bwd]) == (64, 32)
    for k in cs.KERNELS:
        assert sum(run["recorded"][k][0].values()) == run["launches"][k]
    assert run["losses"][2] < run["losses"][0]
    out = capsys.readouterr().out
    assert "pipelined vs sequential loss_fn" in out
    assert "path 4's sequential step on the same weights and tokens" in out


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("fault", [None, "AdamW's step restarted at 0"])
def test_launch_path_rehearsed_on_the_cpu(fault, cpu_backward, monkeypatch,
                                          capsys):
    """run_launch_path on the CPU: the resumed run's final checkpoint ``==``
    the straight run's, the flash forward and backward counted; a resume
    that restarts AdamW's step at 0 fails that gate."""
    if fault:
        from repro_torch.models import convert

        restore = convert.opt_state_from_jax

        def restart(*args, **kw):
            return dict(restore(*args, **kw), step=0)

        monkeypatch.setattr(convert, "opt_state_from_jax", restart)
        with pytest.raises(AssertionError, match="is not the straight run"):
            cs.run_launch_path(cpu_backward, "cpu")
        return
    run = cs.run_launch_path(cpu_backward, "cpu")
    assert run["launches"]["flash_attention"] > 0
    assert run["launches"]["flash_attention_bwd"] > 0
    assert "4 steps + --resume" in capsys.readouterr().out


# ------------------------------------------------------------- path 8 ---
# reduced traffic: the reduced configs (head width 16, 8 memory positions),
# B 2 x S 24 (vision B 1), prompts of 4-12 tokens and 8 new, four steps
PP_REHEARSAL = cs.TrainTraffic(4, 32, 2, ("flash_attention",
                                          "flash_attention_bwd"), layers=4)


def ranks_setup(fault=None) -> None:
    """A path 10 rank's rehearsal setup (run in each spawned rank): the
    wrappers counting their CPU calls, the backward through the backward
    wrappers, torch on one thread, and the fault named: "late hand-off"
    hands each stage the microbatch before the one it should get (zeros
    first), "no data reduction" leaves each replica its own gradients."""
    from repro_torch.msl import pipeline as MP

    mp_ = pytest.MonkeyPatch()
    install_cpu_backward(mp_, install_cpu_launches(mp_))
    torch.set_num_threads(1)
    if fault == "late hand-off":
        recv, held = MP._recv, {}

        def late(mesh, specs, src, tag, keep):
            got = recv(mesh, specs, src, tag, keep)
            if tag != 0:  # the cotangents come back on time
                return got
            prev = held.get("prev", [torch.zeros_like(t) for t in got])
            held["prev"] = got
            return prev

        mp_.setattr(MP, "_recv", late)
    elif fault == "no data reduction":
        reduce = MP._reduce_grads

        def own(sp, grads, cfg, mesh, plan, keep):
            return reduce(sp, grads, cfg, dataclasses.replace(mesh, n_data=1),
                          plan, keep)

        mp_.setattr(MP, "_reduce_grads", own)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("fault, match", [
    (None, None), ("late hand-off", "update lies"),
    ("no data reduction", "copies of")])
def test_ranks_path_rehearsed_on_cpu_gloo_ranks(fault, match, cpu_backward,
                                                capsys):
    """run_ranks_path on 4 gloo ranks on the CPU (reduced qwen2, 4 layers,
    B 4 x S 32, 2 steps): the ranks' losses and parameters within CHECK_TOL
    of the one-process step's, their update within PP_UPDATE_TOL, the
    replicas' copies the same bits, each rank's flash launches its two
    layers' (M 2, remat: 8 forward and 4 backward a step); a late hand-off
    fails the update gate (on random weights the loss is about log V
    whatever the hidden state), and a step that skips the data reduction
    the replicas' agreement."""
    import functools

    cfg = ARCHS["qwen2-1.5b"].reduced(n_layers=4)

    def run():
        return cs.run_ranks_path(
            cpu_backward, "cpu", "the CPU (rehearsal)", cfg=cfg,
            traffic=PP_REHEARSAL,
            rank_setup=functools.partial(ranks_setup, fault))

    if fault is not None:
        with pytest.raises(AssertionError, match=f"path 10: .*{match}"):
            run()
        return
    res = run()
    assert res["route"] == "gloo-cpu"
    assert cs._pipe_train_launches(cfg, "flash_attention", 2,
                                   range(2)) == (8, 4)
    assert res["launches"]["flash_attention"] == 4 * 2 * 8
    assert res["launches"]["flash_attention_bwd"] == 4 * 2 * 4
    out = capsys.readouterr().out
    assert out.count("path 10 on the CPU (rehearsal): rank") == 4
    assert "route gloo-cpu" in out and "the replicas'" in out


CROSS_REHEARSAL = {
    "whisper-small": cs.CrossModel(
        2, 24, cs.ServeTraffic(2, 4, 12, 8, 24),
        cs.TrainTraffic(2, 24, 4, cs.CROSS["whisper-small"].train.kernels),
        check_seq=16),
    "llama-3.2-vision-90b": cs.CrossModel(
        1, 24, cs.ServeTraffic(1, 4, 12, 8, 24), check_seq=16),
}


@pytest.fixture
def cross_rehearsal(cpu_backward, monkeypatch):
    """cpu_backward, with the cross-attention configs reduced in
    ``repro_torch.configs.ARCHS``, path 8's traffic CROSS_REHEARSAL and the
    card's free memory read as 64 of 80 GB."""
    for name in CROSS_REHEARSAL:
        monkeypatch.setitem(ARCHS, name, ARCHS[name].reduced())
    monkeypatch.setattr(cs, "CROSS", CROSS_REHEARSAL)
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda *a: (64 << 30, 80 << 30))
    return cpu_backward


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("name", list(CROSS_REHEARSAL))
def test_cross_path_rehearsed_on_the_cpu(name, cross_rehearsal, capsys):
    """run_cross_path at reduced size in bf16, the plain versions standing
    in for the kernels: every gate passes; the forward calls flash once an
    encoder layer and a self- and cross-attention, serving as often in the
    prefill and once a cross block a decode step, and whisper's train
    steps twice a forward attention (remat) and once a backward."""
    cfg = ARCHS[name]
    spec = CROSS_REHEARSAL[name]
    run = cs.run_cross_path(name, cross_rehearsal, "cpu")
    calls = cs._cross_attention_calls(cfg)
    assert calls == {"whisper-small": 6, "llama-3.2-vision-90b": 10}[name]
    assert run["forward"]["launches"]["flash_attention"] == calls
    assert run["serve"]["launches"]["flash_attention"] == calls + (
        spec.serve.max_new - 1) * cs._cross_layers(cfg)
    for part in (run["forward"], run["serve"], run["train"]):
        if part is None:
            continue
        for k in cs.KERNELS:
            assert sum(part["recorded"][k][0].values()) == part["launches"][k]
    if spec.train is not None:
        steps = spec.train.steps
        assert run["train"]["launches"]["flash_attention"] == 2 * steps * calls
        assert run["train"]["launches"]["flash_attention_bwd"] == steps * calls
        assert run["train"]["losses"][2] < run["train"]["losses"][0]
    else:
        assert run["train"] is None
    out = capsys.readouterr().out
    assert "gates closed: the hidden states of two memories == True" in out
    assert "the cross K/V come from the prefill" in out
    assert "generate takes no memory" in out and "tokens/s" in out


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("fault, gate", [
    ("a cross block that ignores its gate", "gates do not gate"),
    ("a decode that projects the memory again", "read the memory")])
def test_cross_path_rejects_a_wrong_cross_block(fault, gate, cross_rehearsal,
                                                monkeypatch):
    """A cross block that ignores ``xgate`` fails the gates' check, and a
    decode step that projects the memory again instead of reusing the
    prefill's cross K/V fails the cache's check (its logits are the same:
    only reading the memory tells it apart)."""
    if fault.startswith("a cross block"):
        block = ML.attention_block

        def ungated(p, cfg, x, ctx, cache, window=None, cross=False):
            if cross:
                p = {k: v for k, v in p.items() if k != "xgate"}
            return block(p, cfg, x, ctx, cache, window=window, cross=cross)

        monkeypatch.setattr(ML, "attention_block", ungated)
    else:
        attend = ML._cross_attention

        def again(p, cfg, x, ctx, cache):
            if cache is not None and ctx.decoding:  # as a prefill does
                out, _ = attend(p, cfg, x, dataclasses.replace(
                    ctx, mode="prefill"), None)
                return out, cache
            return attend(p, cfg, x, ctx, cache)

        monkeypatch.setattr(ML, "_cross_attention", again)
    with pytest.raises(AssertionError, match=gate):
        cs.run_cross_path("whisper-small", cross_rehearsal, "cpu")


# ---------------------------------------------------------------- path 9 --
# path 9 at reduced size: a production-style cell on a 2 x 2 fake mesh and
# the two one-card cells, the configs shrunk as the other rehearsals shrink
# them
DRYRUN_REDUCED = {"n_layers": 2}
DRYRUN_TRAIN = ["dry_train", 64, 2, "train"]
DRYRUN_DECODE = ["dry_decode", 32, 4, "decode"]


def _dryrun_rehearsal_specs():
    cell = {"arch": "qwen2-1.5b", "mesh": [2, 2], "shape": DRYRUN_TRAIN,
            "reduced": DRYRUN_REDUCED}
    train = dict(cell, mesh=[1, 1])
    decode = {"arch": "qwen3-moe-30b-a3b", "mesh": [1, 1],
              "shape": DRYRUN_DECODE, "reduced": DRYRUN_REDUCED,
              "overrides": cs.MODELS["qwen3-moe-30b-a3b"].overrides}
    pp = {"pp": "qwen2-1.5b", "K": 2, "reduced": {"n_layers": 4},
          "n_cards": 8, "batch": 8, "seq": 64}
    return [cell], train, decode, pp


def _real_step_args():
    """The reduced steps' arguments on the CPU, as paths 4 and 3 hold them
    on the card, and a CPU time of each step (for the p50 gate)."""
    import time

    from repro_torch import serving as SV
    from repro_torch.data import BatchSpec, SyntheticLM, shard_batch
    from repro_torch.optim import make_optimizer
    from repro_torch.train import make_train_step

    S, B = DRYRUN_TRAIN[1:3]
    cfg = ARCHS["qwen2-1.5b"].reduced(**DRYRUN_REDUCED)
    params = MT.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    opt = make_optimizer(cfg.optimizer)
    state = opt.init(params, cfg)
    batch = shard_batch(SyntheticLM(BatchSpec(B, S, cfg.vocab_size))
                        .batch_at(0), "cpu")
    train_bytes = cs.storage_bytes((params, state, batch))
    t0 = time.perf_counter()
    make_train_step(cfg, opt)(params, state, batch)
    train_ms = (time.perf_counter() - t0) * 1e3

    moe = dataclasses.replace(
        ARCHS["qwen3-moe-30b-a3b"].reduced(**DRYRUN_REDUCED),
        **cs.MODELS["qwen3-moe-30b-a3b"].overrides)
    Bd, L = DRYRUN_DECODE[2], DRYRUN_DECODE[1]
    mparams = MT.init_params(torch.Generator().manual_seed(0), moe, "cpu")
    cache = {"stack": MT.init_cache(moe, Bd, L, "cpu")}
    toks = torch.zeros((Bd, 1), dtype=torch.int64)
    pos = torch.full((Bd, 1), 3)
    decode_bytes = cs.storage_bytes((mparams, cache, (toks, pos)))
    t0 = time.perf_counter()
    SV.decode_step(mparams, moe, cache, toks, pos)
    decode_ms = (time.perf_counter() - t0) * 1e3
    return {"qwen2-1.5b": {"train": {
        "arg_bytes": train_bytes, "step_ms_p50": train_ms,
        "peak_bytes": 0}},
        "qwen3-moe-30b-a3b": {"serve": {
            "decode_arg_bytes": decode_bytes, "decode_ms_p50": decode_ms,
            "decode_bytes": 0, "peak_bytes": 0}}}


@pytest.fixture(scope="module")
def dryrun_rehearsal():
    """Path 9 run once at reduced size: its artifacts and the CPU's
    numbers."""
    mp = pytest.MonkeyPatch()
    mp.setattr(cs, "dryrun_specs", _dryrun_rehearsal_specs)
    try:
        by_model = _real_step_args()
        run = cs.run_dryrun_path(by_model, "cpu")
    finally:
        mp.undo()
    return run, by_model


def test_dryrun_path_rehearsed_on_the_cpu(dryrun_rehearsal):
    """run_dryrun_path at reduced size: the production-style cell on a
    2 x 2 fake mesh passes its gates, and each one-card cell's argument
    bytes equal the storages of the same arguments made on the CPU."""
    run, by_model = dryrun_rehearsal
    (cell,), tr, de = run["cells"], run["train"], run["decode"]
    assert cell["status"] == "ok" and cell["devices"] == 4
    assert tr["memory"]["argument_bytes"] == by_model["qwen2-1.5b"][
        "train"]["arg_bytes"]
    assert de["memory"]["argument_bytes"] == by_model["qwen3-moe-30b-a3b"][
        "serve"]["decode_arg_bytes"]
    assert tr["cost"]["kernel_flops"]["flash_attention_bwd"] > 0
    assert de["cost"]["kernel_flops"]["moe_gmm"] > 0


@pytest.mark.parametrize("fault", [None, "a hand-off left out",
                                   "a stage over the card"])
def test_dryrun_pp_gate(fault, dryrun_rehearsal):
    """The pipelined step's dry run at reduced size (K 2 x 4 fake ranks)
    passes its gate: the plan the host planner's, the hand-offs their
    closed form, every stage within a card; one tick's hand-off left out
    and a stage's peak past the card's memory fail it."""
    from repro_torch.launch.mesh import HBM_PER_CARD

    run, _ = dryrun_rehearsal
    spec = _dryrun_rehearsal_specs()[3]
    pp = copy.deepcopy(run["pp"])
    if fault is None:
        assert "== the host planner's" in cs._dryrun_pp_gate(pp, spec)
        return
    if fault == "a hand-off left out":
        pp["stages"][1]["handoff_bytes"] -= pp["stages"][1][
            "handoff_bytes"] // 2
        match = "hand-offs count"
    else:
        pp["stages"][0]["memory"]["per_device_bytes"] = HBM_PER_CARD + 1
        match = "peaks at"
    with pytest.raises(AssertionError, match=match):
        cs._dryrun_pp_gate(pp, spec)


@pytest.mark.parametrize("fault", ["global FLOPs as one card's",
                                   "an argument count that drops a leaf",
                                   "the H100 peak 10 times too high"])
def test_dryrun_gates_reject_wrong_counts(fault, dryrun_rehearsal):
    run, by_model = dryrun_rehearsal
    cell = copy.deepcopy(run["cells"][0])
    tr = copy.deepcopy(run["train"])
    train = by_model["qwen2-1.5b"]["train"]
    cs._dryrun_gate(cell, "train")
    cs._one_card_gate("train", tr, train["arg_bytes"], train["step_ms_p50"])
    if fault == "global FLOPs as one card's":
        cell["cost"]["flops_per_device"] *= cell["devices"]
        with pytest.raises(AssertionError, match="share"):
            cs._dryrun_gate(cell, "train")
        return
    if fault == "an argument count that drops a leaf":
        cfg = ARCHS["qwen2-1.5b"].reduced(**DRYRUN_REDUCED)
        leaf = cfg.d_model * 4  # final_norm's float32 storage
        tr["memory"]["argument_bytes"] -= leaf
        with pytest.raises(AssertionError, match="arguments hold"):
            cs._one_card_gate("train", tr, train["arg_bytes"],
                              train["step_ms_p50"])
        return
    tr["roofline"]["peak_flops"] *= 10
    with pytest.raises(AssertionError, match="compute term"):
        cs._one_card_gate("train", tr, train["arg_bytes"],
                          train["step_ms_p50"])


# ------------------------------------------------------------ lint phase --
REPO = Path(cs.__file__).resolve().parent
# the lint phase and the summary after it (chip_smoke.report), run as the
# smoke's process runs them: the lint started from ``root``
LINT_RUN = r"""
import sys
from pathlib import Path
sys.path.insert(0, sys.argv[1])
import chip_smoke as cs
lint = cs.start_lint(Path(sys.argv[2]))
try:
    sys.exit(cs.report(lint, {}, [], "card", 0.0, "cpu", 0))
finally:
    lint.stop()
"""


def _lint_run(root: Path) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", LINT_RUN, str(REPO),
                           str(root)], capture_output=True, text=True,
                          timeout=300, env={"PATH": "/usr/bin:/bin"})


def test_lint_phase_passes_on_the_tree():
    """The port's tree lints clean under its baseline: the phase prints its
    line and the run ends with the result line."""
    proc = _lint_run(REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert json.loads(lines[-1])["ok"] is True
    lint = next(ln for ln in lines if ln.startswith("lint: "))
    assert "exit 0: 0 finding(s)" in lint and "1 baseline-suppressed" in lint


def test_lint_phase_fails_the_run_on_a_seeded_finding(tmp_path):
    """A copy of the tree with a wall-clock read seeded in its ``core/``:
    the lint exits 1, the run exits non-zero and prints no result line."""
    shutil.copytree(REPO / "src" / "repro_torch",
                    tmp_path / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "csrc"))
    shutil.copy(REPO / "lint_baseline_torch.txt", tmp_path)
    (tmp_path / "pytest.ini").write_text("[pytest]\n")  # the root marker
    (tmp_path / "src" / "repro_torch" / "core" / "seeded.py").write_text(
        "import time\n\n\ndef stamp():\n    return time.time()\n")
    proc = _lint_run(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "src/repro_torch/core/seeded.py:5:0: [determinism] wall-clock " \
        "call time.time()" in proc.stderr

