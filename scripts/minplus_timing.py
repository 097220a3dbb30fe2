#!/usr/bin/env python3
"""The fused min-plus scan kernel on the card, quickly: its build report, a
check ``==`` against its plain version at the paths' shapes and at
chip_smoke.py's SCAN_GENERIC, two launches compared bit for bit, then its
device time per launch at each path shape.

    PYTHONPATH=src python3 scripts/minplus_timing.py    # needs one CUDA card
    PYTHONPATH=src python3 scripts/minplus_timing.py --variant direct=v.cu

Each ``--variant NAME=FILE.cu`` builds another version of
``csrc/minplus.cu`` with the same C entries (a copy changed for an
ablation, or another commit's) and checks and times it beside the kernel,
in turns (variant, kernel, kernel, variant).  The path shapes are (N, K, S)
of chip_smoke.py's path 1 (``bcd_torch``'s batch-1 tours, the lockstep
waves' groups) and path 2's plans.  A time is the device time per launch by
CUDA events on a held stream (chip_smoke's ``_held_queue_ms``: the card's
own gaps between launches counted, the host's time not), the median of 5
readings of 200 launches; ``torch.profiler`` device times come from
chip_smoke.py.
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
from repro_torch.kernels import minplus  # noqa: E402

# (N, K, S): bcd_torch's tours, the lockstep waves' groups, path 2's plans
PATH_SHAPES = [(1, 5, 4), (1, 3, 8), (1, 8, 8), (1, 4, 8), (1, 2, 1),
               (8, 5, 4), (64, 3, 8), (512, 3, 8), (512, 5, 4)]


def _with(lib, fn):
    return with_library(minplus, "LIBRARY", lib, fn)


def _held_ms(fn) -> float:
    return statistics.median(cs._held_queue_ms(fn, 200) for _ in range(5))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--variant", action="append", default=[],
                        metavar="NAME=FILE.cu")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("minplus_timing: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    t0 = time.perf_counter()
    minplus.build()
    print(f"build {time.perf_counter() - t0!r} s")
    print(minplus.LIBRARY.build_info["log"])
    libs = {"kernel": minplus.LIBRARY}
    for v in args.variant:
        name, source = v.split("=", 1)
        libs[name] = variant_library(minplus.LIBRARY, name, source)

    gen = torch.Generator().manual_seed(0)
    cases = [ops for s in PATH_SHAPES + cs.SCAN_GENERIC
             for ops in cs._scan_cases(gen, s, "cuda")]
    failures = 0
    for name, lib in libs.items():
        n, mismatches, _ = _with(lib, lambda: cs._compare_scan(
            minplus, cases))
        failures += mismatches
        print(f"{name}: {n - mismatches} of {n} cases == the plain version "
              f"(the paths' shapes and SCAN_GENERIC, random and ties)")
    ops = cs._scan_cases(gen, (512, 5, 4), "cuda")[1]
    first, again = minplus.minplus_scan(*ops), minplus.minplus_scan(*ops)
    same = all(torch.equal(a, b) for a, b in zip(first, again))
    failures += not same
    print(f"(512, 5, 4), two launches bit for bit equal: {same}")

    order = [n for n in libs if n != "kernel"]
    turns = order + ["kernel", "kernel"] + order[::-1]
    for s in PATH_SHAPES:
        ops = cs._scan_cases(gen, s, "cuda")[0]
        times: dict = {}
        for name in turns:
            times.setdefault(name, []).append(_with(
                libs[name], lambda: _held_ms(
                    lambda: minplus.minplus_scan(*ops))))
        bound, by, _, n_bytes = cs._scan_bound(s)
        print(f"{s} (N, K, S): " + "; ".join(
            f"{name} {ms!r} ms" for name, ms in times.items()) +
            f" per launch; bound {bound!r} ms by {by} ({n_bytes} B)")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
