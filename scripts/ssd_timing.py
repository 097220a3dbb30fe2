#!/usr/bin/env python3
"""The SSD intra-chunk kernel on the card, quickly: its build report, a
check against its plain version at a few shapes (the generic ones, head
counts across a head group's edge, a ragged chunk, narrow states), against
the float64 witness at mamba2-370m's path shape, two launches compared bit
for bit, then its time per launch at the path shape by CUDA events.

    PYTHONPATH=src python3 scripts/ssd_timing.py      # needs one CUDA card
    PYTHONPATH=src python3 scripts/ssd_timing.py --variant parent=other/ssd.cu

Each ``--variant NAME=FILE.cu`` builds another version of the kernel with
the same C entry (a copy of ``csrc/ssd.cu`` changed for an ablation, or
another commit's) and times it beside the kernel, in turns (variant,
kernel, kernel, variant).  A variant is only timed and checked against the
plain version at the path shape, not held to the witness.  The path is
mamba2-370m's: B 2, nc 8 chunks of Q 256, H 32 heads of P 64, state N 128.
Each time is the median over 5 repetitions of the mean of 20 back-to-back
launches, after 3 launches of warm-up; chip_smoke.py gives the profiler's
device times, and its tolerances, witness and bounds are used here.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from _kernel_timing import variant_library, with_library  # noqa: E402
from repro_torch.kernels import ssd  # noqa: E402

PATH = (2, 2048, 32, 64, 128, 256)  # (B, S, H, P, N, Q)
PATH_KEY = (2, 8, 32, 256, 64, 128)  # chip_smoke's key: (B, nc, H, Q, P, N)
# (B, S, H, P, N, Q): chip_smoke.py's generic shapes, head counts across the
# kernel's group of 4 heads, a ragged chunk, narrow states, long chunks
# whose scans do not fit in shared memory, the path
CHECKS = [*cs.SSD_GENERIC,
          (1, 256, 1, 64, 128, 256), (1, 256, 33, 64, 128, 256),
          (2, 200, 5, 64, 128, 100), (1, 256, 3, 16, 8, 256),
          (1, 256, 6, 32, 64, 256), (1, 3000, 4, 16, 16, 3000), PATH]


def _ms(fn, n=20) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def _with(lib, fn):
    return with_library(ssd, "LIBRARY", lib, fn)


def _within(got, want) -> bool:
    return all(torch.allclose(g, w, atol=t, rtol=t)
               for g, w, t in zip(got, want, cs.SSD_TOL))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--variant", action="append", default=[],
                        metavar="NAME=FILE.cu")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("ssd_timing: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    t0 = time.perf_counter()
    ssd.build()
    print(f"build {time.perf_counter() - t0!r} s")
    print(ssd.LIBRARY.build_info["log"])
    libs = {"kernel": ssd.LIBRARY}
    for v in args.variant:
        name, source = v.split("=", 1)
        libs[name] = variant_library(ssd.LIBRARY, name, source)

    gen = torch.Generator().manual_seed(0)
    failures = 0
    for shape in CHECKS:
        ops = cs._ssd_operands(gen, shape, "cuda")
        got = ssd.ssd_intra_chunk(*ops)
        want = ssd.reference_ssd_intra_chunk(*ops)
        ok = _within(got, want)
        failures += not ok
        errs = [float((g - w).abs().max()) for g, w in zip(got, want)]
        print(f"{shape} (B, S, H, P, N, Q): max |kernel - plain| of y, chunk "
              f"states, decay {errs}, within {cs.SSD_TOL}: {ok}")
    ops = cs._ssd_operands(gen, PATH, "cuda")
    got = ssd.ssd_intra_chunk(*ops)
    again = ssd.ssd_intra_chunk(*ops)
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    failures += not same
    print(f"path shape, two launches bit for bit equal: {same}")
    want = ssd.reference_ssd_intra_chunk(*ops)
    exact = ssd.reference_ssd_intra_chunk(*ops, dtype=torch.float64)
    for name, err_k, limit in cs._ssd_witness(got, want, exact):
        failures += not err_k <= limit
        print(f"path shape, {name} against float64: kernel {err_k!r}, limit "
              f"{limit!r} (SSD_WITNESS times the plain version's own): "
              f"{err_k <= limit}")
    for name, lib in libs.items():
        if name != "kernel":
            vgot = _with(lib, lambda: ssd.ssd_intra_chunk(*ops))
            print(f"variant {name} at the path shape within {cs.SSD_TOL} of "
                  f"the plain version: {_within(vgot, want)}; max |y - plain| "
                  f"{float((vgot[0] - want[0]).abs().max())!r}")

    order = [n for n in libs if n != "kernel"]
    turns = order + ["kernel", "kernel"] + order[::-1] if order else \
        ["kernel", "kernel"]
    times: dict = {}
    for name in turns:
        ms = _with(libs[name], lambda: _ms(
            lambda: ssd.ssd_intra_chunk(*ops)))
        times.setdefault(name, []).append(ms)
    bound, by, n_ops, n_bytes = cs._ssd_bound(PATH_KEY)
    fp32_ms, _ = cs._ssd_fp32_bound(PATH_KEY)
    for name, ms in times.items():
        best = min(ms)
        print(f"{name}: {ms!r} ms per launch at {PATH}; "
              f"{n_ops / (best * 1e-3) / 1e12!r} TFLOP/s, "
              f"{n_bytes / (best * 1e-3) / 1e12!r} TB/s, {bound / best!r} of "
              f"the {bound!r} ms bound ({by}; the same work at the fp32 rate "
              f"{fp32_ms!r} ms)")
    plain = _ms(lambda: ssd.reference_ssd_intra_chunk(*ops), n=5)
    print(f"plain version {plain!r} ms")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
