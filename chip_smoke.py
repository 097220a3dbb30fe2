#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's two paths once on an NVIDIA GPU and check them.

    python3 chip_smoke.py        # from the repository root; needs one card

Path 1 is the batched planner: ``ProblemInstance`` ->
``repro_torch.core.solve_batch`` -> ``dfts_torch`` / ``bcd_torch`` on
``cuda`` -> ``Plan`` + ``LatencyBreakdown``, through the min-plus kernel.
Path 2 is plan execution: ``repro_torch.msl.plan_pipeline`` (``bcd_torch``
on ``cuda``, the min-plus kernel again) -> ``ChainSimulator.run_plan``,
which runs four models at full width and full depth with random weights
from a seed, one after the other (MODELS):

* qwen2-1.5b, B 2 x S 2048, every block through the flash-attention kernel;
* mamba2-370m, B 2 x S 2048, every block through the SSD kernel;
* qwen3-moe-30b-a3b, B 2 x S 2048, every block through flash attention and
  three launches of the expert-matmul kernel.  Its one change from the
  published config: the weights are stored in bf16 (61.1 GB; 122 GB in
  float32 fits no card), which the bf16 compute rounds them to at every use
  anyway; the router stays float32;
* recurrentgemma-9b, B 1 x S 4096 (so that the 2048-token window of its
  local attention cuts keys), its ``rglru`` blocks through the RG-LRU kernel
  and its ``local_attn`` blocks through flash attention at head width 256.

Phases, in order; any failure exits non-zero:

1. device: a CUDA card is required; its name and power limit are printed;
   TF32 is switched off for float32 products and convolutions;
2. build: every kernel is built from the sources in the checkout, one
   ``nvcc`` per source, all started together (sm_90a, ``build/kernels/``);
3. kernel vs plain, generic: min-plus held with ``==`` against its plain
   version (ties, +inf holes, off-tile shapes); flash attention in bf16 at
   FLASH_TOL, SSD in float32 at SSD_TOL, the expert matmul in bf16 at
   GMM_TOL and the RG-LRU scan at RGLRU_TOL, at ``tests/test_kernels.py``'s
   shapes and a few more;
4. path 1: the 96-instance population of the solver benchmark (NSFNET,
   ResNet-101 at its full 37 layer groups) through ``dfts_torch`` (distinct,
   then cycled to 1024) and ``bcd_torch``, every outcome ``==`` the port's
   NumPy oracles, with the min-plus launch count over exactly this run and
   every launch's shape and first operands recorded; then min-plus against
   its plain version on the recorded operands, each shape timed;
5. path 2, one model after the other: the counts set to 0, the plan and the
   planned chain run on the card, the counts read (min-plus and each of the
   model's kernels must have launched), every kernel call's shape and first
   operands recorded; the chain's hidden state ``==`` the port's monolithic
   ``apply_stack`` on the card (the same blocks in the same order); the
   first two groups at S 512 on the card (kernels) within CHECK_TOL of
   their largest magnitude of the same groups on the CPU (plain versions),
   in bf16 (route-aware for MoE: a token whose kept experts differ must
   first differ at a near tie on the CPU side, and the tokens that keep
   the same experts at every layer are compared); each stage's measured compute printed beside the
   planner's prediction; the model freed before the next;
6. kernel vs plain at path 2's shapes, on the recorded operands and random
   ones: flash attention at FLASH_TOL, which must also reject two wrong
   outputs (l off by 5 %, each row's diagonal key tile dropped); SSD's y and
   chunk states, and the RG-LRU scan, on the recorded operands against a
   float64 witness, at SSD_WITNESS and RGLRU_WITNESS times the plain
   version's own error (random operands at SSD_TOL and RGLRU_TOL); the
   expert matmul at GMM_TOL; then each shape timed by ``torch.profiler``
   device time beside its plain version, its bound and its library
   yardstick (``scaled_dot_product_attention`` for flash attention,
   ``torch.bmm`` with the activation for the expert matmul; SSD and RG-LRU
   have no single library call);
7. one JSON line of per-kernel numbers, the card line, then the result line.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import importlib
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
FP64_OPS_PER_S = 34e12      # H100 SXM fp64 outside the tensor cores (ditto)
FP32_OPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores (ditto)
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor cores (ditto)
EXTRA_SHAPE = (1024, 1, 16, 16)  # (batch, M, K, N): a scan at Sp = 16
RECORDED_OPERANDS = 3  # operand sets kept per shape of a kernel's calls
CHECK_SEQ = 512        # path 2: sequence of the card-vs-CPU check
# Flash attention, bf16: kernel and plain version round fp32 values summed
# in different orders once to bf16, so they differ by an ulp of bf16 in a
# few elements.  Held per (batch, query, head) row of width hd, scaled to
# the row: ||got - want|| / ||want|| below FLASH_TOL[0], and
# max |got - want| at most FLASH_TOL[1] * max |want| over the whole output.
FLASH_TOL = (1e-2, 2.0 ** -6)
FLASH_TILE = 64  # keys per tile of csrc/flash_attention.cu (BK)
SSD_TOL = (1e-4, 1e-4, 1e-5)  # y, chunk states, decay (tests/test_kernels.py)
# SSD on the path's recorded operands: y and the chunk states are held to
# their float64 values; over each output the kernel's largest error there
# may be SSD_WITNESS times the plain version's own (or eps of the largest
# value, where the plain version is exact).  The decay stays at SSD_TOL[2].
SSD_WITNESS = 4.0
FP32_EPS = 2.0 ** -23
# Expert matmul, bf16: both sides sum exact products in fp32 (in other
# orders) and round once to bf16, so they differ by an ulp of bf16 in a few
# elements: elementwise within GMM_TOL of |want| plus GMM_TOL of max |want|.
GMM_TOL = 2.0 ** -7
# RG-LRU, float32: the kernel's sequential chunks and the plain version's
# doubling scan round the same recurrence in other orders: max |got - want|
# at most RGLRU_TOL of max |want| (tests/test_kernels.py's 1e-5).  On the
# path's recorded operands both are held to the float64 witness: the
# kernel's largest error at most RGLRU_WITNESS times the plain version's
# (or eps of the largest value, where the plain version is exact).
RGLRU_TOL = 1e-5
RGLRU_WITNESS = 4.0
CHECK_TOL = 2e-2  # path 2, card vs CPU, first two groups: of the largest
#                   magnitude (PERF.md gives the readings it was set from)


class PathModel(NamedTuple):
    """One model of path 2: the kernels its blocks run, its batch and
    sequence, and its changes from the published config."""
    kernels: tuple[str, ...]
    batch: int
    seq: int
    overrides: dict = {}


# path 2, in this order
MODELS = {
    "qwen2-1.5b": PathModel(("flash_attention",), 2, 2048),
    "mamba2-370m": PathModel(("ssd",), 2, 2048),
    "qwen3-moe-30b-a3b": PathModel(("flash_attention", "moe_gmm"), 2, 2048,
                                   {"param_dtype": "bfloat16"}),
    "recurrentgemma-9b": PathModel(("flash_attention", "rglru"), 1, 4096),
}
# (B, Sq, Skv, Hq, Hkv, hd, causal, window, softcap): tests/test_kernels.py's
# cases, rows that see no key, and randomised GQA shapes
FLASH_GENERIC = [
    (2, 128, 128, 4, 2, 64, True, None, None),
    (1, 200, 200, 8, 1, 64, True, None, 50.0),
    (2, 256, 256, 4, 4, 128, True, 64, None),
    (1, 64, 256, 2, 2, 64, False, None, None),
    (1, 96, 96, 6, 3, 32, True, 32, 30.0),
    (1, 48, 16, 2, 1, 32, False, 8, None),
    (1, 37, 37, 8, 2, 128, True, None, None),
    (1, 130, 130, 4, 4, 32, True, None, None),
    (3, 70, 70, 2, 1, 64, False, None, None),
    (1, 200, 200, 4, 1, 256, True, None, None),
    (1, 300, 300, 4, 2, 256, True, 128, None),
    (2, 96, 96, 2, 1, 256, False, 40, 30.0),
]
# (B, S, H, P, N, Q): tests/test_kernels.py's cases, head width 16, a ragged Q
SSD_GENERIC = [(2, 128, 4, 32, 16, 32), (1, 256, 2, 64, 128, 64),
               (2, 64, 3, 16, 16, 16), (1, 100, 2, 16, 8, 100)]
# (E, C, D, F, activation): tests/test_kernels.py's cases, a ragged D and F
# (element loads), one row tile short of the MoE path's C
GMM_GENERIC = [(4, 64, 96, 80, "none"), (2, 128, 256, 128, "silu"),
               (8, 40, 72, 200, "gelu"), (3, 70, 50, 33, "silu"),
               (2, 256, 2048, 768, "none")]
# (B, S, W): tests/test_kernels.py's cases, one step, a chunk and a half
RGLRU_GENERIC = [(2, 64, 128), (1, 100, 48), (3, 256, 512), (2, 1, 300),
                 (1, 192, 1000)]


def _card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _costs(gen, shape, device, *, ties=False, p_inf=0.2):
    """Cost-like float64 matrices on the card: non-negative values (small
    integers when ``ties``, so that many sums tie) with +inf holes."""
    if ties:
        x = torch.randint(0, 3, shape, generator=gen).double()
    else:
        x = torch.rand(shape, generator=gen, dtype=torch.float64) * 10.0
    x[torch.rand(shape, generator=gen) < p_inf] = float("inf")
    return x.to(device)


def _device_us(fn) -> tuple[float, float, dict]:
    """Run ``fn`` once under ``torch.profiler``: (wall us, device us summed
    over every kernel and copy, device us by kernel name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
    return wall, sum(by_name.values()), by_name


def _time_ms(fn, reps=21, inner=50) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back calls,
    by CUDA events, after a warm-up.  When the host takes longer per call
    than the card, this is the time per call the caller sees."""
    for _ in range(5):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _pin_argmin(device) -> None:
    inf = float("inf")
    x = torch.tensor([[2.0, 1.0, 1.0, 3.0], [inf, inf, inf, inf],
                      [5.0, inf, 5.0, 4.0]], dtype=torch.float64,
                     device=device)
    if x.argmin(dim=1).tolist() != [1, 0, 3]:
        raise AssertionError("torch.argmin on cuda is not first-occurrence")


def _compare(mp, pairs) -> tuple[int, int, float]:
    """(cases, mismatches, max_abs_err) of the kernel against its plain
    version on each ``(a, b)`` pair, ``val`` and ``idx`` compared by ==."""
    mismatches, max_err = 0, 0.0
    for a, b in pairs:
        val, idx = mp.minplus_matmul(a, b)
        rval, ridx = mp.minplus_reference(a, b)
        torch.cuda.synchronize()
        if not (torch.equal(val, rval) and torch.equal(idx, ridx)):
            mismatches += 1
        fin = torch.isfinite(rval)
        if fin.any():
            max_err = max(max_err, float((val[fin] - rval[fin]).abs().max()))
    return len(pairs), mismatches, max_err


def _random_pairs(gen, shape, device) -> list:
    """Random costs and tie-forcing small integers at ``(batch, M, K, N)``,
    each with +inf holes and, where M > 1, an all-+inf row."""
    batch, m, k, n = shape
    out = []
    for ties in (False, True):
        a = _costs(gen, batch + (m, k), device, ties=ties)
        b = _costs(gen, batch + (k, n), device, ties=ties)
        if m > 1:
            a[..., 0, :] = float("inf")
        out.append((a, b))
    return out


def check_minplus_generic(mp, device) -> dict:
    """Phase 3 for the min-plus kernel: the tie rule of torch's own argmin
    pinned on the card, then ``==`` against the plain version at shapes off
    any tile of 256 threads."""
    _pin_argmin(device)
    gen = torch.Generator().manual_seed(0)
    sizes = (1, 3, 16, 17, 33)
    pairs = [p for batch in [(), (3,), (2, 2)] for m in sizes for k in sizes
             for n in sizes for p in _random_pairs(gen, (batch, m, k, n),
                                                   device)]
    n, mismatches, max_err = _compare(mp, pairs)
    if mismatches:
        raise AssertionError(f"minplus kernel disagrees with its plain "
                             f"version in {mismatches} of {n} generic cases")
    print(f"minplus generic: {n} cases == plain version, max_abs_err "
          f"{max_err!r}")
    return {"cases": n, "max_abs_err": max_err}


def _kernel_device_ms(fn, calls, must_see: str | None) -> float:
    """Device time per call of ``fn`` under ``torch.profiler``, summed over
    every device kernel (or only those whose name holds ``must_see``).
    Raises when the profiler records none."""
    _, _, by_name = _device_us(lambda: [fn() for _ in range(calls)])
    us = sum(t for name, t in by_name.items()
             if must_see is None or must_see in name)
    if us <= 0.0:
        raise AssertionError(f"the profiler recorded no device time for "
                             f"{must_see or 'the plain version'}: "
                             f"{sorted(by_name)}")
    return us / calls / 1e3


def _bound_ms(shape) -> tuple[float, str, int]:
    batch, m, k, n = shape
    nb = 1
    for d in batch:
        nb *= d
    n_bytes = 8 * nb * (m * k + k * n) + (8 + 4) * nb * m * n
    n_ops = 2 * nb * m * n * k  # one add and one compare per (b, m, n, k)
    byte_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    op_ms = n_ops / FP64_OPS_PER_S * 1e3
    return (max(byte_ms, op_ms), "bytes" if byte_ms >= op_ms else
            "operations", n_bytes)


def check_minplus_path(mp, device, shapes, operands, generic) -> dict:
    """Phase 5 for the min-plus kernel: ``==`` against the plain version at
    every shape the main path launched (on the recorded operands and on
    random and tie-forcing ones), plus EXTRA_SHAPE; then each path shape
    timed.  The returned numbers are those of the shape with the most
    launches."""
    gen = torch.Generator().manual_seed(1)
    all_shapes = sorted(shapes, key=lambda s: (-shapes[s], s))
    pairs = [args for s in all_shapes for args, _ in operands[s]]
    for s in all_shapes + [((EXTRA_SHAPE[0],),) + EXTRA_SHAPE[1:]]:
        pairs += _random_pairs(gen, s, device)
    n, mismatches, max_err = _compare(mp, pairs)
    if mismatches:
        raise AssertionError(f"minplus kernel disagrees with its plain "
                             f"version in {mismatches} of {n} cases at the "
                             f"path's shapes")
    print(f"minplus at the path's shapes: {n} cases == plain version "
          f"(recorded operands, random, ties), max_abs_err {max_err!r}")

    rows = {}
    for s in all_shapes:
        a, b = _random_pairs(gen, s, device)[0]
        ms = _kernel_device_ms(lambda: mp.minplus_matmul(a, b), 200,
                               "minplus_kernel")
        plain = _kernel_device_ms(lambda: mp.minplus_reference(a, b), 200,
                                  None)
        bound, by, n_bytes = _bound_ms(s)
        rows[s] = {"ms": ms, "plain_ms": plain, "bound_ms": bound,
                   "bound_by": by, "a": a, "b": b}
        print(f"minplus {s} float64, {shapes[s]} launches on the path: "
              f"device time per launch (torch.profiler) kernel {ms!r} ms, "
              f"plain {plain!r} ms; bound {bound!r} ms by {by} "
              f"({n_bytes} B at 3.35 TB/s)")
    top = all_shapes[0]
    row = rows[top]
    a, b = row.pop("a"), row.pop("b")
    call_ms = _time_ms(lambda: mp.minplus_matmul(a, b))
    plain_call_ms = _time_ms(lambda: mp.minplus_reference(a, b))
    print(f"minplus at {top}, per call seen by the caller (CUDA events): "
          f"kernel {call_ms!r} ms, plain {plain_call_ms!r} ms")
    return {"name": "minplus", "route": "cuda",
            "source": KERNELS["minplus"].source,
            "replaces": KERNELS["minplus"].replaces,
            "max_abs_err": max(max_err, generic["max_abs_err"]),
            "mismatches": mismatches, "shape": [list(top[0]), *top[1:]],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "call_ms": call_ms, "plain_call_ms": plain_call_ms,
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None}


def build_population(C) -> list:
    """The solver benchmark's population (benchmarks/solver_throughput.py),
    built with the port's own classes: (K, per_stage) in {(3, 6), (5, 4)},
    IF/TR, b in {8, 128}, seeds 1-8, then the 32 TR-pipe instances, M = 4."""
    net = C.nsfnet(source=C.SOURCE)
    profile = C.resnet101_profile()

    def inst(K, per_stage, seed, **req):
        cands = C.candidate_sets(K, seed, C.NSFNET_NODES, C.SOURCE, C.DEST,
                                 per_stage=per_stage)
        return C.ProblemInstance(net, profile, C.ServiceChainRequest(
            profile.model_id, C.SOURCE, C.DEST, **req), K, cands)

    configs, seeds = [(3, 6), (5, 4)], range(1, 9)
    out = [inst(K, ps, s, batch_size=b, mode=mode)
           for K, ps in configs for mode in (C.IF, C.TR) for b in (8, 128)
           for s in seeds]
    out += [inst(K, ps, s, batch_size=b, mode=C.TR, schedule=C.PIPE,
                 n_microbatches=4)
            for K, ps in configs for b in (8, 128) for s in seeds]
    return out


def _plain(out) -> tuple:
    if out.plan is None:
        return (False,)
    p, lb = out.plan, out.latency
    return (True, tuple(map(tuple, p.segments)), tuple(p.placement),
            tuple(map(tuple, p.paths)), tuple(p.tail_path),
            (lb.computation_s, lb.transmission_s, lb.propagation_s,
             lb.bubble_s))


def run_main_path(C, TS, mp, device: str = "cuda") -> dict:
    """Phase 4: the planner on ``device``, held against the NumPy oracles
    on the CPU.  Returns the launch count and the recorded minplus shapes
    and operands."""
    problems = build_population(C)
    if len(set(problems)) != 96:
        raise AssertionError("the population must hold 96 distinct instances")
    cycled = [problems[i % len(problems)] for i in range(1024)]
    for p in problems:
        if p.profile.L != 37 or len(p.net.nodes) != 14:
            raise AssertionError("ResNet-101 at full width on NSFNET expected")

    with record_calls(TS, "minplus_matmul", _minplus_key) as (shapes,
                                                             operands):
        mp.launch_count = 0
        t0 = time.perf_counter()
        dfts_distinct = C.solve_batch(problems, "dfts_torch", dedup=False,
                                      device=device)
        launches_dfts = mp.launch_count
        t1 = time.perf_counter()
        dfts_cycled = C.solve_batch(cycled, "dfts_torch", dedup=False,
                                    device=device)
        t2 = time.perf_counter()
        bcd_out = C.solve_batch(problems, "bcd_torch", dedup=False,
                                device=device)
        t3 = time.perf_counter()
        launches = mp.launch_count
    if launches == 0:
        raise AssertionError("the main path launched no minplus kernel")
    if sum(shapes.values()) != launches:
        raise AssertionError(f"{sum(shapes.values())} recorded minplus calls "
                             f"against {launches} launches")
    print("minplus launches on the main path by (batch, M, K, N): " +
          ", ".join(f"{s}: {c}" for s, c in shapes.most_common()))
    print(f"main path: dfts_torch 96 distinct {t1 - t0!r} s "
          f"({launches_dfts} minplus launches), 1024 cycled {t2 - t1!r} s, "
          f"bcd_torch 96 distinct {t3 - t2!r} s; minplus launches in all "
          f"{launches}")

    cache = C.EvalCache()
    want_dfts = [C.solve(p, "dfts_np", cache=cache) for p in problems]
    t4 = time.perf_counter()
    want_bcd = [C.solve(p, "bcd", cache=C.EvalCache()) for p in problems]
    print(f"oracles on the CPU: bcd 96 distinct {time.perf_counter() - t4!r}"
          f" s")
    mismatches = 0
    for got, want in [(dfts_distinct, want_dfts),
                      (dfts_cycled, want_dfts * 11),
                      (bcd_out, want_bcd)]:
        for g, w in zip(got, want):
            mismatches += _plain(g) != _plain(w)
    n_feasible = sum(o.feasible for o in dfts_distinct)
    for o in dfts_distinct + bcd_out:
        if o.feasible and not (0.0 < o.objective < float("inf")):
            raise AssertionError(f"non-finite latency {o.objective!r}")
    if mismatches:
        raise AssertionError(f"{mismatches} outcomes differ from the NumPy "
                             f"oracles")
    print(f"parity: 96 + 1024 dfts_torch and 96 bcd_torch outcomes == "
          f"dfts_np / bcd ({n_feasible} of 96 feasible)")

    # warm throughput: the recurring 1024-instance batch, best of 3 passes
    warm_torch = min(_wall(lambda: C.solve_batch(
        cycled, "dfts_torch", dedup=False, device=device)) for _ in range(3))
    warm_np = min(_wall(lambda: [C.solve(p, "dfts_np", cache=cache)
                                 for p in cycled]) for _ in range(3))
    print(f"warm instances/s at batch 1024: dfts_torch ({device}) "
          f"{1024 / warm_torch!r}, dfts_np (cpu) {1024 / warm_np!r}")
    if device == "cuda":
        wall, dev, by_name = _device_us(lambda: C.solve_batch(
            cycled, "dfts_torch", dedup=False, device=device))
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        print(f"warm dfts_torch pass at batch 1024 under the profiler: wall "
              f"{wall!r} us, device busy {dev!r} us (share {dev / wall!r}); "
              f"top device time: {top}")
    return {"launches": launches, "shapes": shapes, "operands": operands}


def _wall(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


# ------------------------------------------------------------------ builds --
def build_kernels(mods: dict) -> None:
    """Phase 2: every kernel built at once, one ``nvcc`` per source; the
    first failure raises."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(mods)) as pool:
        list(pool.map(lambda m: m.build(), mods.values()))
    for name, m in mods.items():
        info = m.LIBRARY.build_info
        print(f"build: {name} in {info['seconds']!r} s ({info['path']})")
        if info["log"]:
            print(info["log"].strip())
    print(f"build: all kernels in {time.perf_counter() - t0!r} s of wall "
          f"time")


# ------------------------------------------------ flash attention and SSD --
def _flash_operands(gen, shape, device):
    B, Sq, Sk, Hq, Hkv, hd = shape[:6]
    return tuple(torch.randn(s, generator=gen).to(device, torch.bfloat16)
                 for s in ((B, Sq, Hq, hd), (B, Sk, Hkv, hd),
                           (B, Sk, Hkv, hd)))


def _flash_kw(shape) -> dict:
    return dict(zip(("causal", "window", "softcap"), shape[6:]))


def _flash_errors(got, want) -> tuple[float, float]:
    """(the worst (batch, query, head) row's ||got - want|| / ||want||,
    max |got - want| / max |want|), in float32."""
    g, w = got.float(), want.float()
    d = g - w
    rows = d.norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)
    return float(rows.max()), float(d.abs().max() / w.abs().max())


def _flash_within(errors) -> bool:
    return errors[0] < FLASH_TOL[0] and errors[1] <= FLASH_TOL[1]


def _flash_check(fa, cases, what: str) -> float:
    """The kernel against its plain version on each ``((q, k, v), kw)`` at
    FLASH_TOL; raises on a failure, else returns the max_abs_err."""
    failures, worst, max_err = 0, (0.0, 0.0), 0.0
    for (q, k, v), kw in cases:
        out = fa.flash_attention(q, k, v, **kw)
        want = fa.reference_attention(q, k, v, **kw)
        errors = _flash_errors(out, want)
        failures += not _flash_within(errors)
        worst = tuple(map(max, worst, errors))
        max_err = max(max_err, float((out.float() - want.float()).abs().max()))
    line = (f"flash_attention {what}: {len(cases)} bf16 cases, worst row "
            f"{worst[0]!r} (limit {FLASH_TOL[0]}), max error {worst[1]!r} of "
            f"the largest |want| (limit {FLASH_TOL[1]}), max_abs_err "
            f"{max_err!r}")
    if failures:
        raise AssertionError(f"{line}: {failures} cases past the limits")
    print(line)
    return max_err


def _flash_rejects_wrong_outputs(fa, args, kw) -> None:
    """FLASH_TOL must reject two deliberately wrong outputs on these causal
    operands: the plain version with the normaliser l off by 5 %, and
    attention with each row's diagonal key tile dropped (rows past the
    first tile; the tile the kernel would skip if its causal walk stopped
    one tile short)."""
    q, k, v = args
    if not kw.get("causal") or kw.get("window") or kw.get("softcap"):
        raise ValueError(f"plain causal attention expected, got {kw}")
    want = fa.reference_attention(q, k, v, **kw)
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    qi = torch.arange(Sq, device=q.device)[:, None]
    ki = torch.arange(k.shape[1], device=q.device)[None, :]
    diagonal = (qi // FLASH_TILE == ki // FLASH_TILE) & (qi >= FLASH_TILE)
    s = torch.einsum("bqkgh,bskh->bkgqs",
                     q.float().reshape(B, Sq, Hkv, Hq // Hkv, hd), k.float())
    s = s * (kw.get("scale") or hd ** -0.5)
    w = torch.softmax(s.masked_fill((qi < ki) | diagonal, -1e30), dim=-1)
    dropped = torch.einsum("bkgqs,bskh->bqkgh", w, v.float())
    wrong = {"l off by 5 %": (want.float() / 1.05).to(want.dtype),
             "diagonal key tile dropped":
                 dropped.reshape(q.shape).to(want.dtype)}
    for what, out in wrong.items():
        errors = _flash_errors(out, want)
        if _flash_within(errors):
            raise AssertionError(f"FLASH_TOL passes a wrong output ({what}): "
                                 f"{errors}")
        print(f"flash_attention check rejects a wrong output ({what}): worst "
              f"row {errors[0]!r}, max error {errors[1]!r} of the largest "
              f"|want|")


def _ssd_operands(gen, shape, device):
    B, S, H, P, N, Q = shape
    nc = S // Q
    return (torch.randn((B, nc, H, Q, P), generator=gen).to(device),
            (torch.randn((B, nc, Q, N), generator=gen) * 0.3).to(device),
            (torch.randn((B, nc, Q, N), generator=gen) * 0.3).to(device),
            (torch.rand((B, nc, H, Q), generator=gen) * 0.19 + 0.01
             ).to(device),
            (torch.rand((H,), generator=gen) * 3.5 + 0.5).to(device))


def _ssd_check(ssd, cases, what: str) -> float:
    """The kernel against its plain version on each case, each output at
    its tolerance in SSD_TOL; raises on a failure, else returns the
    max_abs_err."""
    failures, max_err = 0, 0.0
    for args in cases:
        got = ssd.ssd_intra_chunk(*args)
        want = ssd.reference_ssd_intra_chunk(*args)
        for g, w, tol in zip(got, want, SSD_TOL):
            failures += not torch.allclose(g, w, atol=tol, rtol=tol)
            max_err = max(max_err, float((g - w).abs().max()))
    line = (f"ssd {what}: {len(cases)} float32 cases within {SSD_TOL} of the "
            f"plain version, max_abs_err {max_err!r}")
    if failures:
        raise AssertionError(f"{line}: {failures} outputs past the limits")
    print(line)
    return max_err


def _by_head(t):
    """The largest |t| of each head (axis 2 of an SSD output)."""
    return t.abs().amax(dim=(0, 1, 3, 4))


def _ssd_check_witness(ssd, cases, what: str) -> float:
    """The kernel and its plain version against the plain version computed
    in float64: over each case's y and chunk states, the kernel's largest
    error may be SSD_WITNESS times the plain version's (or eps of the
    largest value, where the plain version is exact), so the kernel is
    within (1 + SSD_WITNESS) times the plain version's own error of it; the
    decay is held to the plain version at SSD_TOL[2].  Prints the errors
    per head.  Raises on a failure, else returns the max_abs_err against
    the plain version."""
    failures, max_err = 0, 0.0
    for n, args in enumerate(cases):
        got = ssd.ssd_intra_chunk(*args)
        want = ssd.reference_ssd_intra_chunk(*args)
        exact = ssd.reference_ssd_intra_chunk(*args, dtype=torch.float64)
        cum_max = float((args[4][None, None, :, None].double()
                         * args[3].double()).sum(-1).max())
        for name, g, w, e in zip(("y", "chunk states"), got, want, exact):
            err_k, err_p = _by_head(g.double() - e), _by_head(w.double() - e)
            worst_k, worst_p = float(err_k.max()), float(err_p.max())
            limit = SSD_WITNESS * max(worst_p, FP32_EPS * float(e.abs().max()))
            failures += not worst_k <= limit
            vs_plain = float((g - w).abs().max())
            max_err = max(max_err, vs_plain)
            ratio = err_k / err_p.clamp_min(1e-300)
            print(f"ssd {what}, case {n}, {name} against float64: kernel "
                  f"{worst_k!r} (limit {limit!r}), plain {worst_p!r}; kernel "
                  f"vs plain {vs_plain!r}; largest |value| "
                  f"{float(e.abs().max())!r}, |cum|max {cum_max!r}; per "
                  f"head, kernel over plain error {float(ratio.min())!r} to "
                  f"{float(ratio.max())!r}:")
            print("  " + " ".join(f"{a:.3g}/{b:.3g}" for a, b in
                                  zip(err_k.tolist(), err_p.tolist())))
        if not torch.allclose(got[2], want[2], atol=SSD_TOL[2],
                              rtol=SSD_TOL[2]):
            failures += 1
        max_err = max(max_err, float((got[2] - want[2]).abs().max()))
    if failures:
        raise AssertionError(f"ssd {what}: {failures} outputs past the "
                             f"limits")
    return max_err


def _gmm_operands(gen, shape, device):
    """x and w of an expert matmul at ``(E, C, D, F, activation)`` in bf16,
    w scaled by D^-1/2 (outputs of order 1), with the activation as kw."""
    E, C, D, F_, act = shape
    x = torch.randn((E, C, D), generator=gen).to(device, torch.bfloat16)
    w = (torch.randn((E, D, F_), generator=gen) * D ** -0.5).to(
        device, torch.bfloat16)
    return (x, w), {"activation": act}


def _gmm_check(gmm, cases, what: str) -> float:
    """The kernel against its plain version on each ``((x, w), kw)`` at
    GMM_TOL; raises on a failure, else returns the max_abs_err."""
    failures, max_err, worst = 0, 0.0, 0.0
    for (x, w), kw in cases:
        got = gmm.expert_matmul(x, w, **kw).float()
        want = gmm.reference_expert_matmul(x, w, **kw).float()
        top = float(want.abs().max())
        d = (got - want).abs()
        failures += not bool((d <= GMM_TOL * (want.abs() + top)).all())
        max_err = max(max_err, float(d.max()))
        worst = max(worst, float(d.max()) / top)
    line = (f"moe_gmm {what}: {len(cases)} bf16 cases, max error {worst!r} of "
            f"the largest |want| (elementwise limit {GMM_TOL} of |want| + "
            f"{GMM_TOL} of the largest), max_abs_err {max_err!r}")
    if failures:
        raise AssertionError(f"{line}: {failures} cases past the limit")
    print(line)
    return max_err


def _rglru_operands(gen, shape, device):
    """a in [0.7, 0.999) and b of an RG-LRU scan at ``(B, S, W)``."""
    return ((torch.rand(shape, generator=gen) * 0.299 + 0.7).to(device),
            (torch.randn(shape, generator=gen) * 0.1).to(device))


def _rglru_check(rglru, cases, what: str) -> float:
    """The kernel against its plain version on each ``(a, b)`` at RGLRU_TOL
    of the largest |h|; raises on a failure, else returns the
    max_abs_err."""
    failures, max_err, worst = 0, 0.0, 0.0
    for a, b in cases:
        got, want = rglru.rglru_scan(a, b), rglru.reference_rglru_scan(a, b)
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        failures += not rel <= RGLRU_TOL
        max_err, worst = max(max_err, err), max(worst, rel)
    line = (f"rglru {what}: {len(cases)} float32 cases, max error {worst!r} "
            f"of the largest |h| (limit {RGLRU_TOL}), max_abs_err {max_err!r}")
    if failures:
        raise AssertionError(f"{line}: {failures} cases past the limit")
    print(line)
    return max_err


def _rglru_check_witness(rglru, cases, what: str) -> float:
    """The kernel and its plain version against the plain version computed
    in float64: the kernel's largest error at most RGLRU_WITNESS times the
    plain version's (or eps of the largest value, where the plain version
    is exact).  Raises on a failure, else returns the max_abs_err against
    the plain version."""
    failures, max_err = 0, 0.0
    for n, (a, b) in enumerate(cases):
        got, want = rglru.rglru_scan(a, b), rglru.reference_rglru_scan(a, b)
        exact = rglru.reference_rglru_scan(a, b, dtype=torch.float64)
        top = float(exact.abs().max())
        err_k = float((got.double() - exact).abs().max())
        err_p = float((want.double() - exact).abs().max())
        limit = RGLRU_WITNESS * max(err_p, FP32_EPS * top)
        failures += not err_k <= limit
        vs_plain = float((got - want).abs().max())
        max_err = max(max_err, vs_plain)
        print(f"rglru {what}, case {n}, against float64: kernel {err_k!r} "
              f"(limit {limit!r}), plain {err_p!r}; kernel vs plain "
              f"{vs_plain!r}; largest |h| {top!r}, a in "
              f"[{float(a.min())!r}, {float(a.max())!r}]")
    if failures:
        raise AssertionError(f"rglru {what}: {failures} cases past the "
                             f"limit")
    return max_err


def check_generic(mods, device) -> dict:
    """Phase 3 for the kernels of path 2: each against its plain version on
    random operands at shapes off the path."""
    gen = torch.Generator().manual_seed(2)
    return {
        "flash_attention": _flash_check(
            mods["flash_attention"], [(_flash_operands(gen, s, device),
                                       _flash_kw(s)) for s in FLASH_GENERIC],
            "generic"),
        "ssd": _ssd_check(mods["ssd"], [_ssd_operands(gen, s, device)
                                        for s in SSD_GENERIC], "generic"),
        "moe_gmm": _gmm_check(mods["moe_gmm"], [
            _gmm_operands(gen, s, device) for s in GMM_GENERIC], "generic"),
        "rglru": _rglru_check(mods["rglru"], [
            _rglru_operands(gen, s, device) for s in RGLRU_GENERIC],
            "generic")}


@contextlib.contextmanager
def record_calls(module, name: str, key_fn):
    """Record every call of ``module.<name>`` inside the block: a count per
    ``key_fn(*args, **kw)`` and up to RECORDED_OPERANDS clones of its
    operands per key.  The recorder calls the function it replaced, so the
    wrappers' launch counts are untouched."""
    shapes: collections.Counter = collections.Counter()
    operands: dict = collections.defaultdict(list)
    wrapped = getattr(module, name)

    def recorder(*args, **kw):
        key = key_fn(*args, **kw)
        shapes[key] += 1
        if len(operands[key]) < RECORDED_OPERANDS:
            operands[key].append((tuple(a.clone() if torch.is_tensor(a)
                                        else a for a in args), dict(kw)))
        return wrapped(*args, **kw)

    setattr(module, name, recorder)
    try:
        yield shapes, operands
    finally:
        setattr(module, name, wrapped)


def _flash_key(q, k, v, *, causal=True, window=None, softcap=None,
               scale=None):
    return (*q.shape[:3], k.shape[1], k.shape[2], q.shape[3], causal, window,
            softcap)  # (B, Sq, Hq, Skv, Hkv, hd, ...)


def _ssd_key(x, Bm, Cm, dt, A):
    B, nc, H, Q, P = x.shape
    return (B, nc, H, Q, P, Bm.shape[-1])


def _minplus_key(a, b):
    return (tuple(a.shape[:-2]), a.shape[-2], a.shape[-1], b.shape[-1])


def _gmm_key(x, w, activation="none"):
    return (*x.shape, w.shape[2], activation)  # (E, C, D, F, activation)


def _rglru_key(a, b):
    return tuple(a.shape)  # (B, S, W)


@contextlib.contextmanager
def record_routes():
    """Record every MoE layer's routing inside the block: yields a list of
    (logits, idx, keep), one per layer in order."""
    from repro_torch.models import layers as ML

    routes: list = []
    route = ML.moe_route

    def recorder(router, cfg, toks):
        r = route(router, cfg, toks)
        routes.append((r.logits, r.idx, r.keep))
        return r

    ML.moe_route = recorder
    try:
        yield routes
    finally:
        ML.moe_route = route


def _check_on_cpu(name, cfg, params, tokens, pos) -> None:
    """The first two groups at S = CHECK_SEQ on the card (kernels) against
    the same groups on the CPU (plain versions), within CHECK_TOL of the
    largest magnitude; route-aware where they hold MoE layers: every token
    whose kept experts differ must first differ at a near tie on the CPU
    side (``routing_agreement``, within CHECK_TOL of the largest |logit|),
    half the tokens at least must keep the same experts at every layer, and
    those are compared."""
    from repro_torch.models import layers as ML
    from repro_torch.models import transformer as MT

    n = 2 * len(cfg.pattern)
    sub = {"layers": params["stack"]["layers"][:n]}
    x = MT.embed_tokens(params, cfg, tokens[:, :CHECK_SEQ])
    ctx = ML.Ctx(mode="prefill", positions=pos[:, :CHECK_SEQ])
    t0 = time.perf_counter()
    with record_routes() as card_routes:
        on_card, _, _ = MT.apply_stack(sub, cfg, n, cfg.pattern, x, ctx,
                                       None)
    with record_routes() as cpu_routes:
        on_cpu, _, _ = MT.apply_stack(
            MT.tree_map(lambda t: t.cpu(), sub), cfg, n, cfg.pattern,
            x.cpu(), ML.Ctx(mode="prefill", positions=ctx.positions.cpu()),
            None)
    got = on_card.float().cpu().reshape(-1, cfg.d_model)
    want = on_cpu.float().reshape(-1, cfg.d_model)
    routed = ""
    if cpu_routes:
        ra = ML.routing_agreement(card_routes, cpu_routes)
        routed = (f"; routing: {ra.flips} of {ra.picks} expert picks differ "
                  f"by slot, {ra.diverged} of {len(want)} tokens keep other "
                  f"experts at some layer, each first at a near tie (the "
                  f"largest distance of a differing expert from the CPU's "
                  f"top-k cut {ra.worst_gap!r} of the largest |logit|, "
                  f"limit {CHECK_TOL}); {int(ra.agree.sum())} tokens keep "
                  f"the same experts at every layer and are compared")
        if not ra.flips_are_near_ties(CHECK_TOL) \
                or 2 * int(ra.agree.sum()) < len(want):
            raise AssertionError(f"{name}: the card's routing is not the "
                                 f"CPU's up to near ties{routed}")
        got, want = got[ra.agree], want[ra.agree]
    err = float((got - want).abs().max() / want.abs().max())
    if not err < CHECK_TOL:
        raise AssertionError(f"{name}: first two groups on the card differ "
                             f"from the CPU by {err!r} of the largest "
                             f"magnitude (limit {CHECK_TOL}){routed}")
    print(f"{name}: first {n} blocks at S {CHECK_SEQ}, card (kernels) vs CPU "
          f"(plain versions) in {cfg.compute_dtype}: {err!r} of the largest "
          f"magnitude (limit {CHECK_TOL}){routed}, in "
          f"{time.perf_counter() - t0!r} s")


def run_model_path(name: str, mods: dict, device) -> dict:
    """Phase 5 for one model: plan and run its chain on ``device`` with the
    kernels' counts taken over exactly that, then the checks.  Returns the
    counts and the recorded kernel calls."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import layers as ML
    from repro_torch.models import transformer as MT
    from repro_torch.msl import ChainSimulator, plan_pipeline

    spec = MODELS[name]
    cfg = dataclasses.replace(ARCHS[name], **spec.overrides)
    B, S = spec.batch, spec.seq
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = MT.init_params(torch.Generator(device=device).manual_seed(0),
                            cfg, device=device)
    n_params = sum(t.numel() for t in MT.tree_leaves(params))
    n_bytes = sum(t.numel() * t.element_size()
                  for t in MT.tree_leaves(params))
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(1)
                           ).to(device)
    torch.cuda.synchronize()
    print(f"{name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params} parameters, {n_bytes} B ({cfg.param_dtype}, compute "
          f"{cfg.compute_dtype}; changed from the published config: "
          f"{spec.overrides or 'nothing'}) on the card in "
          f"{time.perf_counter() - t0!r} s; B {B} x S {S}")

    with contextlib.ExitStack() as stack:
        recorded = {k: stack.enter_context(record_calls(
            importlib.import_module(ks.site[0]), ks.site[1], ks.key))
            for k, ks in KERNELS.items()}
        for m in mods.values():
            m.launch_count = 0
        t1 = time.perf_counter()
        pp = plan_pipeline(cfg, seq_len=S, microbatch=B, mode="IF",
                           device=device)
        t2 = time.perf_counter()
        sim = ChainSimulator(cfg, params, pp.problem.net, pp.problem.profile,
                             pp.problem.request)
        out = sim.run_plan(pp.plan, tokens)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        launches = {k: m.launch_count for k, m in mods.items()}
    for k in ("minplus",) + spec.kernels:
        if launches[k] == 0:
            raise AssertionError(f"{name}: path 2 launched no {k} kernel")
    for k, (shapes, _) in recorded.items():
        if sum(shapes.values()) != launches[k]:
            raise AssertionError(f"{name}: {sum(shapes.values())} recorded "
                                 f"{k} calls against {launches[k]} launches")
    print(f"{name}: plan_pipeline (bcd_torch on cuda) K {pp.K}, groups "
          f"{pp.segments} on {pp.placement}, predicted "
          f"{pp.predicted_latency_s!r} s, in {t2 - t1!r} s; chain run in "
          f"{t3 - t2!r} s; launches on path 2 {launches}")
    for t in out.traces:
        print(f"{name}: stage {t.stage} on {t.node}, groups {t.groups}: "
              f"measured compute {t.compute_s_measured!r} s, predicted "
              f"{t.compute_s_predicted!r} s; transfer charged "
              f"{t.transfer_s_charged!r} s, smashed {t.smashed_bytes!r} B")

    wall, busy, by_name = _device_us(lambda: sim.run_plan(pp.plan, tokens))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"{name}: warm chain run under the profiler: wall {wall!r} us, "
          f"device busy {busy!r} us (share {busy / wall!r}); top device "
          f"time: {top}")
    warm = sim.run_plan(pp.plan, tokens)
    for t in warm.traces:
        print(f"{name}: warm stage {t.stage}, groups {t.groups}: measured "
              f"compute {t.compute_s_measured!r} s")

    h = out.hidden
    if h.shape != (B, S, cfg.d_model) or not torch.isfinite(h).all():
        raise AssertionError(f"{name}: hidden state {tuple(h.shape)} is not "
                             f"finite of shape {(B, S, cfg.d_model)}")
    pos = torch.arange(S, device=device).expand(B, S)
    ctx = ML.Ctx(mode="prefill", positions=pos)
    mono, _, _ = MT.apply_stack(params["stack"], cfg, cfg.n_layers,
                                cfg.pattern, MT.embed_tokens(params, cfg,
                                                             tokens), ctx,
                                None)
    if not torch.equal(h, mono):
        raise AssertionError(f"{name}: the chain's hidden state differs from "
                             f"apply_stack by up to "
                             f"{float((h.float() - mono.float()).abs().max())}")
    print(f"{name}: chain's hidden state == monolithic apply_stack on the card "
          f"(max |h| {float(h.float().abs().max())!r}); peak device memory "
          f"{torch.cuda.max_memory_allocated()} B")
    _check_on_cpu(name, cfg, params, tokens, pos)
    del params, sim, out, warm, h, mono
    torch.cuda.empty_cache()
    return {"launches": launches, "recorded": recorded}


def _flash_bound(key) -> tuple[float, str, int, int]:
    B, Sq, Hq, Skv, Hkv, hd, causal, window, _ = key
    qi = torch.arange(Sq)[:, None]
    ki = torch.arange(Skv)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool)
    if causal:
        mask &= qi >= ki
    if window is not None:
        mask &= qi - ki < window
    pairs = int(mask.sum())
    n_ops = 4 * B * Hq * hd * pairs  # q.k and p.v, a multiply-add each
    n_bytes = 2 * (2 * B * Sq * Hq * hd + 2 * B * Skv * Hkv * hd)
    op_ms = n_ops / BF16_OPS_PER_S * 1e3
    byte_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return (max(op_ms, byte_ms), "operations" if op_ms >= byte_ms else
            "bytes", n_ops, n_bytes)


def _ssd_bound(key) -> tuple[float, str, int, int]:
    """C B^T counted once per (batch, chunk), as the heads share it, and
    every product over causal pairs only: the least work."""
    B, nc, H, Q, P, N = key
    pairs = Q * (Q + 1) // 2
    n_ops = (2 * N * pairs * B * nc + 2 * P * pairs * B * nc * H
             + 2 * Q * N * P * B * nc * H)
    n_bytes = 4 * (B * nc * H * Q * P * 2 + 2 * B * nc * Q * N
                   + 2 * B * nc * H * Q + H + B * nc * H * N * P)
    op_ms = n_ops / FP32_OPS_PER_S * 1e3
    byte_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return (max(op_ms, byte_ms), "operations" if op_ms >= byte_ms else
            "bytes", n_ops, n_bytes)


def _gmm_bound(key) -> tuple[float, str, int, int]:
    """Every row of the buffers, filled or not, as the function computes
    them: 2 E C D F operations, x and w read and the output written once."""
    E, C, D, F_, _ = key
    n_ops = 2 * E * C * D * F_
    n_bytes = 2 * (E * C * D + E * D * F_ + E * C * F_)
    op_ms = n_ops / BF16_OPS_PER_S * 1e3
    byte_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return (max(op_ms, byte_ms), "operations" if op_ms >= byte_ms else
            "bytes", n_ops, n_bytes)


def _rglru_bound(key) -> tuple[float, str, int, int]:
    """a and b read and h written once; a multiply-add per element."""
    n = key[0] * key[1] * key[2]
    n_ops, n_bytes = 2 * n, 12 * n
    op_ms = n_ops / FP32_OPS_PER_S * 1e3
    byte_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return (max(op_ms, byte_ms), "operations" if op_ms >= byte_ms else
            "bytes", n_ops, n_bytes)


def _flash_path_check(fa, recorded, random) -> float:
    err = _flash_check(fa, recorded + random, "at path 2's shapes (recorded "
                       "operands and random)")
    _flash_rejects_wrong_outputs(fa, *next(
        case for case in recorded if case[1].get("causal", True)
        and not case[1].get("window") and not case[1].get("softcap")))
    return err


def _gmm_path_check(gmm, recorded, random) -> float:
    return _gmm_check(gmm, recorded + random, "at path 2's shapes (recorded "
                      "operands and random)")


def _rglru_path_check(rglru, recorded, random) -> float:
    err = _rglru_check_witness(rglru, [args for args, _ in recorded],
                               "recorded at path 2's shapes")
    return max(err, _rglru_check(rglru, [args for args, _ in random],
                                 "random at path 2's shapes"))


def _ssd_path_check(ssd, recorded, random) -> float:
    err = _ssd_check_witness(ssd, [args for args, _ in recorded],
                             "recorded at path 2's shapes")
    return max(err, _ssd_check(ssd, [args for args, _ in random],
                               "random at path 2's shapes"))


def _flash_library(args, kw):
    """One ``scaled_dot_product_attention`` call on the same operands, the
    library yardstick (never called by the port): causal, or with the
    causal window as a boolean mask; None where the options have no such
    call (a softcap, or no causal mask)."""
    if not kw.get("causal", True) or kw.get("softcap"):
        return None
    qt, kt, vt = (t.transpose(1, 2) for t in args)
    window = kw.get("window")
    if window is None:
        return lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2)
    qi = torch.arange(qt.shape[2], device=qt.device)[:, None]
    ki = torch.arange(kt.shape[2], device=qt.device)[None, :]
    mask = (qi >= ki) & (qi - ki < window)
    return lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask, enable_gqa=True).transpose(1, 2)


def _gmm_library(args, kw):
    """One ``torch.bmm`` (with the activation, for the gate) on the same
    operands, the library yardstick (never called by the port)."""
    x, w = args
    act = {"none": lambda t: t, "silu": F.silu,
           "gelu": lambda t: F.gelu(t, approximate="tanh")}[
        kw.get("activation", "none")]
    return lambda: act(torch.bmm(x, w))  # noqa: E731


class Kernel(NamedTuple):
    """What the script knows of one kernel: where it comes from, where path
    2 calls it (the function recorded), and, for the kernels of path 2's
    models, how it is checked, timed and bounded at the recorded shapes."""
    source: str
    replaces: str
    site: tuple[str, str]   # (module, name) of the call that is recorded
    key: Callable           # a recorded call -> its shape key
    profiled: str = ""      # part of the kernel's name in the profiler
    wrapper: str = ""       # the wrapper's and the plain version's names
    plain: str = ""
    random_operands: Callable | None = None  # (gen, key, kw, device)
    check: Callable | None = None  # (module, recorded, random) -> max err
    bound: Callable | None = None  # key -> (ms, by, operations, bytes)
    library: Callable = lambda args, kw: None  # noqa: E731


KERNELS = {
    "minplus": Kernel(
        "src/repro_torch/kernels/csrc/minplus.cu",
        "src/repro/kernels/minplus.py:35",
        ("repro_torch.core.torch_solvers", "minplus_matmul"), _minplus_key),
    "flash_attention": Kernel(
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:29",
        ("repro_torch.models.layers", "flash_attention"), _flash_key,
        "flash_attention_kernel", "flash_attention", "reference_attention",
        lambda gen, s, kw, device: (_flash_operands(
            gen, (s[0], s[1], s[3], s[2], s[4], s[5]), device), kw),
        _flash_path_check, _flash_bound, _flash_library),
    "ssd": Kernel(
        "src/repro_torch/kernels/csrc/ssd.cu",
        "src/repro/kernels/ssd.py:25",
        ("repro_torch.kernels.ops", "ssd_intra_chunk"), _ssd_key,
        "ssd_intra_chunk_kernel", "ssd_intra_chunk",
        "reference_ssd_intra_chunk",
        lambda gen, s, kw, device: (_ssd_operands(
            gen, (s[0], s[1] * s[3], s[2], s[4], s[5], s[3]), device), kw),
        _ssd_path_check, _ssd_bound),
    "moe_gmm": Kernel(
        "src/repro_torch/kernels/csrc/moe_gmm.cu",
        "src/repro/kernels/moe_gmm.py:22",
        ("repro_torch.models.layers", "expert_matmul"), _gmm_key,
        "expert_matmul_kernel", "expert_matmul", "reference_expert_matmul",
        lambda gen, s, kw, device: _gmm_operands(gen, s, device),
        _gmm_path_check, _gmm_bound, _gmm_library),
    "rglru": Kernel(
        "src/repro_torch/kernels/csrc/rglru.cu",
        "src/repro/kernels/rglru.py:23",
        ("repro_torch.models.layers", "rglru_scan"), _rglru_key,
        "rglru_chunk", "rglru_scan", "reference_rglru_scan",
        lambda gen, s, kw, device: (_rglru_operands(gen, s, device), kw),
        _rglru_path_check, _rglru_bound),
}


def check_model_path(name: str, mod, recorded, launches_by_path: dict,
                     generic_err: float, device) -> dict:
    """Phase 6 for a kernel of path 2: the kernel against its plain version
    at every shape path 2 launched (recorded operands and random ones),
    then each shape timed.  Returns the kernels-line entry: the numbers of
    the shape with the most launches, and every shape's under ``shapes``."""
    spec = KERNELS[name]
    shapes, operands = recorded
    gen = torch.Generator().manual_seed(3)
    order = sorted(shapes, key=lambda s: (-shapes[s], str(s)))
    err = spec.check(mod, [case for s in order for case in operands[s]],
                     [spec.random_operands(gen, s, operands[s][0][1], device)
                      for s in order])
    rows = {}
    for s in order:
        args, kw = operands[s][0]
        wrapper, plain = getattr(mod, spec.wrapper), getattr(mod, spec.plain)
        ms = _kernel_device_ms(lambda: wrapper(*args, **kw), 20,
                               spec.profiled)
        plain_ms = _kernel_device_ms(lambda: plain(*args, **kw), 20, None)
        bound, by, n_ops, n_bytes = spec.bound(s)
        library = spec.library(args, kw)
        library_ms = None
        if library is not None:
            lib_err = float((library().float()
                             - plain(*args, **kw).float()).abs().max())
            library_ms = _kernel_device_ms(library, 20, None)
            print(f"{name} {s}: library yardstick (never called by the port) "
                  f"{library_ms!r} ms, max_abs_err vs plain {lib_err!r}")
        rows[s] = {"shape": list(s), "launches": shapes[s], "ms": ms,
                   "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                   "library_ms": library_ms}
        print(f"{name} {s}, {shapes[s]} launches on path 2: device time per "
              f"launch (torch.profiler) kernel {ms!r} ms, plain {plain_ms!r} "
              f"ms; bound {bound!r} ms by {by} ({n_ops} operations, "
              f"{n_bytes} B)")
    top = rows[order[0]]
    return {"name": name, "route": "cuda", "source": spec.source,
            "replaces": spec.replaces,
            "launches": sum(launches_by_path.values()),
            "max_abs_err": max(err, generic_err), "mismatches": 0,
            **{k: v for k, v in top.items() if k != "launches"},
            "launches_by_path": launches_by_path,
            "shapes": [rows[s] for s in order]}


def _merge(recorded: list) -> tuple:
    """One kernel's recorded calls of several models, as one record."""
    shapes: collections.Counter = collections.Counter()
    operands: dict = {}
    for s, ops in recorded:
        shapes.update(s)
        operands.update(ops)
    return shapes, operands


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core as C
    import repro_torch.core.torch_solvers as TS

    t_start = time.perf_counter()
    device = torch.device("cuda")
    card = _card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card}; torch {torch.__version__}, cuda "
          f"{torch.version.cuda}; TF32 off for float32 products")

    mods = {k: importlib.import_module(f"repro_torch.kernels.{k}")
            for k in KERNELS}
    mp = mods["minplus"]
    build_kernels(mods)
    generic = check_minplus_generic(mp, device)
    generic_new = check_generic(mods, device)

    path = run_main_path(C, TS, mp)
    minplus = check_minplus_path(mp, device, path["shapes"],
                                 path["operands"], generic)
    minplus["launches"] = path["launches"]
    minplus["launches_by_path"] = {"planner": path["launches"]}

    by_model = {}
    for name in MODELS:
        by_model[name] = run_model_path(name, mods, device)
        minplus["launches_by_path"][name] = \
            by_model[name]["launches"]["minplus"]
    kernels = [minplus]
    for kernel in ("flash_attention", "ssd", "moe_gmm", "rglru"):
        models = [m for m, spec in MODELS.items() if kernel in spec.kernels]
        kernels.append(check_model_path(
            kernel, mods[kernel],
            _merge([by_model[m]["recorded"][kernel] for m in models]),
            {m: by_model[m]["launches"][kernel] for m in models},
            generic_new[kernel], device))

    order = ["name", "route", "source", "replaces", "launches", "mismatches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "shape", "launches_by_path", "call_ms",
             "plain_call_ms", "shapes"]
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start!r} s")
    print(json.dumps({"kernels": [{k: kern[k] for k in order if k in kern}
                                  for kern in kernels]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
