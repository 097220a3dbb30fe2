"""chip_smoke.py's checks on the CPU: the rule for profiler windows (with a
stand-in profiler, a window that lost device events is never read, the
next one is, and when every window lost events the calls are timed on a
held stream), SSD's bound, SSD's witness against wrong outputs, the
card-vs-CPU gate of the MoE models on a hand-made routing, the fused
min-plus scan's bound, path 1's recording and host split rehearsed on the
CPU, and path 3 (serving) rehearsed on the CPU at reduced size, with two
wrong decodes its teacher-forced gate must reject."""
from __future__ import annotations

import collections
import dataclasses
import importlib
import types

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


# ------------------------------------------------------------- path 3 ---
# reduced traffic: qwen2 and mamba2 pad to 32 (two SSD chunks of 16) and
# decode 16 (the forward over 48 is three); recurrentgemma's 40-token
# prompt overfills its 32-slot ring, which every decode step wraps
SERVE_REHEARSAL = {
    "qwen2-1.5b": cs.ServeTraffic(2, 20, 32, 16, 48),
    "mamba2-370m": cs.ServeTraffic(2, 20, 32, 16, 48),
    "recurrentgemma-9b": cs.ServeTraffic(1, 40, 40, 8, 48),
}


@pytest.fixture
def cpu_launches(monkeypatch):
    """The kernels' modules, with each wrapper at the site chip_smoke.py
    records counting its CPU calls as launches (the counts restored after
    the test), and torch.cuda's synchronise and memory statistics made
    no-ops."""
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


def _serve(name, mods):
    cfg = ARCHS[name].reduced()
    params = MT.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    return cs.run_serve_path(name, cfg, params, SERVE_REHEARSAL[name],
                             cs.MODELS[name].kernels, mods, "cpu")


@pytest.mark.parametrize("name", list(SERVE_REHEARSAL))
def test_serve_path_rehearsed_on_the_cpu(name, cpu_launches, capsys):
    """run_serve_path at reduced size in bf16, the plain versions standing
    in for the kernels: every gate passes, the prefill's kernel calls are
    counted and recorded, one call a layer of each kind, and the serving
    numbers are printed."""
    cfg = ARCHS[name].reduced()
    run = _serve(name, cpu_launches)
    kinds = MT.layer_kinds(cfg.n_layers, cfg.pattern)
    per_layer = {"flash_attention": ("attn", "local_attn"), "ssd": ("ssd",),
                 "rglru": ("rglru",)}
    for k in cs.KERNELS:
        want = sum(kind in per_layer.get(k, ()) for kind in kinds)
        assert run["launches"][k] == want
        assert sum(run["recorded"][k][0].values()) == want
    out = capsys.readouterr().out
    assert "the same tokens as the loop" in out
    assert "tokens/s" in out and "p90" in out
    assert run["cache_bytes"] > 0 and run["tokens_per_s"] > 0
    assert run["decode_ms_p50"] <= run["decode_ms_p90"]


@pytest.mark.parametrize("fault", ["attention", "ssd"])
def test_serve_path_rejects_a_wrong_decode(fault, cpu_launches,
                                           monkeypatch):
    """The teacher-forced gate fails a decode whose attention masks out
    the new token's own key, and one whose SSD prefill hands the decode
    steps a zero state."""
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


# ------------------------------------------------------------- path 4 ---
# reduced traffic: B 2 x S 32 (two SSD chunks of 16), four steps; the
# card-vs-CPU gradient check at S 16; the models deepened to four pattern
# groups, so that the TR plan has stages to chain
TRAIN_REHEARSAL = {
    "qwen2-1.5b": cs.TrainTraffic(2, 32, 4, cs.TRAIN["qwen2-1.5b"].kernels),
    "mamba2-370m": cs.TrainTraffic(2, 32, 4,
                                   cs.TRAIN["mamba2-370m"].kernels),
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


@pytest.fixture
def cpu_backward(cpu_launches, monkeypatch):
    """cpu_launches, with flash attention's and SSD's backward taken
    through their backward wrappers (``_PlainWithBackward``)."""
    fa = cpu_launches["flash_attention"]
    ssd = cpu_launches["ssd"]
    from repro_torch.kernels import ops

    flash_site, ssd_site = ML.flash_attention, ops.ssd_intra_chunk

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


@pytest.mark.parametrize("name", list(TRAIN_REHEARSAL))
def test_train_path_rehearsed_on_the_cpu(name, cpu_backward, capsys):
    """run_train_path at reduced size in bf16, the plain versions standing
    in for the kernels: the round trip's and the train steps' gates pass,
    with one forward and one backward call a layer in the round trip and
    two forward calls (rematerialised) and one backward a layer in each
    step, counted and recorded."""
    cfg = ARCHS[name].reduced(n_layers=4)
    traffic = TRAIN_REHEARSAL[name]
    params = MT.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    run = cs.run_train_path(name, cfg, params, traffic, cpu_backward, "cpu")
    fwd, bwd = traffic.kernels
    assert cs._train_launches(cfg, fwd) == (8, 4)
    rt, tr = run["round trip"], run["train"]
    assert (rt["launches"][fwd], rt["launches"][bwd]) == (4, 4)
    assert (tr["launches"][fwd], tr["launches"][bwd]) == (32, 16)
    for part in (rt, tr):
        for k in cs.KERNELS:
            assert sum(part["recorded"][k][0].values()) == part["launches"][k]
    assert run["losses"][2] < run["losses"][0]
    out = capsys.readouterr().out
    assert "charges == segment_comp_dir_s" in out and "tokens/s" in out
    assert "parameter gradients" in out and "warm round trip stage 0 BW" in out
    # the card-vs-CPU check reads the weights the round trip ran on, before
    # the steps move them
    assert out.index("parameter gradients") < out.index("train steps (")


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
