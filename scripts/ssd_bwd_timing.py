#!/usr/bin/env python3
"""The SSD backward kernel on the card, quickly: its build report and the
instructions of each of its kernels (``cuobjdump -sass``: tensor-core
``HGMMA`` against fp32 ``FFMA``, and the ``WARPGROUP.DEPBAR`` waits between
products), a check against autograd through its
plain version at chip_smoke.py's SSD_GENERIC shapes, the card-only tests'
shapes and mamba2-370m's path shape (each gradient within SSD_BWD_TOL of
its largest magnitude, two launches the same bits), the float64 witness at
the path shape, then its time per launch there on a held stream, with each
kernel's share from the profiler, beside the plain version and the bound.

    PYTHONPATH=src python3 scripts/ssd_bwd_timing.py      # needs one CUDA card
    PYTHONPATH=src python3 scripts/ssd_bwd_timing.py --variant g2=build/g2.cu

Each ``--variant NAME=FILE.cu`` builds another version of the kernel with
the same C entries (a copy of ``csrc/ssd_bwd.cu`` changed for an ablation,
kept in a gitignored directory such as ``build/``; the variants build in
parallel) and times it beside the kernel, in turns (variant, kernel,
kernel, variant), after holding it to SSD_BWD_TOL and the float64 witness
at the path shape (an ablation that leaves work out fails that check and
is timed all the same).  The path is path 4's mamba2-370m SSD: B 2, nc 8
chunks of Q 256, H 32 heads of P 64, state N 128.  The tolerances, witness
and bounds are chip_smoke.py's.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from _kernel_timing import sass_counts, variant_library, with_library  # noqa: E402
from repro_torch.kernels import ssd  # noqa: E402

PATH = (2, 2048, 32, 64, 128, 256)  # (B, S, H, P, N, Q)
PATH_KEY = (2, 8, 32, 256, 64, 128)  # chip_smoke's key: (B, nc, H, Q, P, N)
# (B, S, H, P, N, Q): chip_smoke.py's generic shapes, the card-only tests'
# new ones (5 and 33 heads across the group of 4, Q either side of a
# 64-position tile, N 10 padded for TMA and N 124 off a multiple of 16, the
# path's widths at nc 2), the path
CHECKS = [*cs.SSD_GENERIC,
          (1, 256, 5, 64, 128, 256), (1, 256, 33, 32, 64, 128),
          (1, 128, 4, 64, 128, 64), (1, 130, 4, 64, 128, 65),
          (2, 128, 4, 32, 10, 64), (1, 256, 4, 64, 124, 128),
          (2, 512, 32, 64, 128, 256), PATH]
CALLS = 20  # launches a held-queue timing takes


def _with(lib, fn):
    return with_library(ssd, "BWD_LIBRARY", lib, fn)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--variant", action="append", default=[],
                        metavar="NAME=FILE.cu")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("ssd_bwd_timing: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(cs._card_line())
    t0 = time.perf_counter()
    path = ssd.BWD_LIBRARY.build()
    print(f"build {time.perf_counter() - t0!r} s")
    print(ssd.BWD_LIBRARY.build_info["log"])
    for fn, n in sass_counts(path).items():
        print(f"sass {fn}: {dict(n)}")
    libs = {"kernel": ssd.BWD_LIBRARY}
    with concurrent.futures.ThreadPoolExecutor() as pool:
        built = [(name, pool.submit(variant_library, ssd.BWD_LIBRARY,
                                          name, source))
                 for name, source in (v.split("=", 1) for v in args.variant)]
        for name, job in built:
            libs[name] = job.result()

    gen = torch.Generator().manual_seed(0)
    failures = 0
    for shape in CHECKS:
        try:
            cs._ssd_bwd_check(ssd, [cs._ssd_bwd_operands(gen, shape, "cuda")],
                              f"at {shape}")
        except AssertionError as e:
            failures += 1
            print(f"FAILED: {e}")
    case = cs._ssd_bwd_operands(gen, PATH, "cuda")
    for name, lib in libs.items():
        try:
            _with(lib, lambda: cs._ssd_bwd_check(
                ssd, [case], f"{name}, the float64 witness at the path shape "
                "(random operands)", witness=True))
        except AssertionError as e:
            failures += 1
            print(f"FAILED: {e}")

    order = [n for n in libs if n != "kernel"]
    turns = order + ["kernel", "kernel"] + order[::-1] if order else \
        ["kernel", "kernel"]
    times: dict = {}
    for name in turns:
        ms = _with(libs[name], lambda: cs._held_queue_ms(
            lambda: ssd.ssd_intra_chunk_bwd(*case), CALLS))
        times.setdefault(name, []).append(ms)
    for name, lib in libs.items():
        _, by_name, count = _with(lib, lambda: cs._device_events(
            lambda: [ssd.ssd_intra_chunk_bwd(*case) for _ in range(CALLS)]))
        total = sum(us for k, us in by_name.items() if "ssd_bwd_" in k)
        print(f"{name}, device time per launch by kernel (profiler): " +
              ", ".join(f"{k} {us / CALLS / 1e3!r} ms ({count[k]} events, "
                        f"{us / total!r} of the ssd_bwd_ kernels)"
                        for k, us in by_name.items()))
    bound, by, n_ops, n_bytes = cs._ssd_bwd_bound(PATH_KEY)
    fp32_bound, _ = cs._ssd_bwd_fp32_bound(PATH_KEY)
    print(f"timed on {cs._card_line()}")
    for name, ms in times.items():
        best = min(ms)
        print(f"{name}: {ms!r} ms per launch at {PATH}; "
              f"{n_ops / (best * 1e-3) / 1e12!r} TFLOP/s of the least work, "
              f"{bound / best!r} of the {bound!r} ms bound ({by}; fp32 rate "
              f"{fp32_bound!r} ms)")
    plain = cs._held_queue_ms(
        lambda: ssd.reference_ssd_intra_chunk_bwd(*case), 3)
    print(f"plain version {plain!r} ms per call")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
