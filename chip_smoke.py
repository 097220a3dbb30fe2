#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on an NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; needs one card

The main path is the batched planner: ``ProblemInstance`` ->
``repro_torch.core.solve_batch`` -> ``dfts_torch`` / ``bcd_torch`` on
``cuda`` -> ``Plan`` + ``LatencyBreakdown``.  Phases, in order; any failure
exits non-zero:

1. device: a CUDA card is required; its name and power limit are printed;
2. build: every kernel of the path is built from the sources in the checkout
   (``nvcc`` for sm_90a, into ``build/kernels/``);
3. kernel vs plain, generic: each kernel is held with ``==`` against its
   plain PyTorch version on the card (random costs with +inf holes, forced
   ties, all-+inf rows, off-tile shapes with batch dims);
4. main path: the 96-instance population of the solver benchmark (NSFNET,
   ResNet-101 at its full 37 layer groups) through ``dfts_torch`` (distinct,
   then cycled to 1024) and ``bcd_torch`` on ``cuda``, every outcome held
   with ``==`` against the port's NumPy oracles ``dfts_np`` / ``bcd`` on the
   CPU, with the kernels' launch counts taken over exactly this run and the
   operand shapes and first operands of every launch recorded;
5. kernel vs plain at the path's shapes: ``==`` on the recorded operands and
   on random and tie-forcing ones of each recorded shape, then each shape
   timed by ``torch.profiler`` device time beside its plain version and its
   bound; the kernels line carries the shape with the most launches;
6. one JSON line of per-kernel numbers, the card line, then the result line.
"""
from __future__ import annotations

import collections
import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
FP64_OPS_PER_S = 34e12      # H100 SXM fp64 outside the tensor cores (ditto)
EXTRA_SHAPE = (1024, 1, 16, 16)  # (batch, M, K, N): a scan at Sp = 16
RECORDED_OPERANDS = 3  # operand pairs kept per (batch, M, K, N) on the path


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


@contextlib.contextmanager
def record_minplus(TS, mp):
    """Record every minplus call the planner makes inside the block: a
    count per ``(batch, M, K, N)`` and up to RECORDED_OPERANDS clones of
    its operands per shape.  The recorder calls the wrapper itself, so the
    wrapper's launch count is untouched."""
    shapes: collections.Counter = collections.Counter()
    operands: dict = collections.defaultdict(list)
    wrapped = TS.minplus_matmul

    def recorder(a, b):
        key = (tuple(a.shape[:-2]), a.shape[-2], a.shape[-1], b.shape[-1])
        shapes[key] += 1
        if len(operands[key]) < RECORDED_OPERANDS:
            operands[key].append((a.clone(), b.clone()))
        return mp.minplus_matmul(a, b)

    TS.minplus_matmul = recorder
    try:
        yield shapes, operands
    finally:
        TS.minplus_matmul = wrapped


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
    pairs = [p for s in all_shapes for p in operands[s]]
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
            "source": "src/repro_torch/kernels/csrc/minplus.cu",
            "replaces": "src/repro/kernels/minplus.py:35",
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

    with record_minplus(TS, mp) as (shapes, operands):
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core as C
    import repro_torch.core.torch_solvers as TS
    from repro_torch.kernels import minplus as mp

    device = torch.device("cuda")
    card = _card_line()
    print(f"card: {card}; torch {torch.__version__}, cuda "
          f"{torch.version.cuda}")

    t0 = time.perf_counter()
    mp.build()
    print(f"build: minplus in {time.perf_counter() - t0!r} s "
          f"({mp.build_info['path']})")
    if mp.build_info["log"]:
        print(mp.build_info["log"].strip())

    generic = check_minplus_generic(mp, device)
    path = run_main_path(C, TS, mp)
    kernel = check_minplus_path(mp, device, path["shapes"], path["operands"],
                                generic)
    kernel["launches"] = path["launches"]
    order = ["name", "route", "source", "replaces", "launches", "mismatches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "shape", "call_ms", "plain_call_ms"]
    print(json.dumps({"kernels": [{k: kernel[k] for k in order}]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
