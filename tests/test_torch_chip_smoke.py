"""chip_smoke.py's checks on the CPU: the rule for profiler windows (with a
stand-in profiler, a window that lost device events is never read, the
next one is, and when every window lost events the calls are timed on a
held stream), SSD's bound, SSD's witness against wrong outputs, the
card-vs-CPU gate of the MoE models on a hand-made routing, the fused
min-plus scan's bound, and path 1's recording and host split rehearsed on
the CPU."""
from __future__ import annotations

import collections
import types

import numpy as np
import pytest
import torch

import chip_smoke as cs
import repro_torch.core as T
from repro_torch.core import torch_solvers as TS
from repro_torch.kernels import minplus as mp

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
], ids=["whole", "lost-then-whole", "empty-then-whole", "all-lost",
        "all-empty", "all-empty-plain", "all-lost-plain"])
def test_a_lossy_window_is_never_read(monkeypatch, capsys, windows,
                                      must_see, want):
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
