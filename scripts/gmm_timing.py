#!/usr/bin/env python3
"""The expert-matmul kernel on the card, quickly: its build report, a check
against its plain version at a few shapes (one 64 x 64 tile, ragged and
padded shapes, the MoE path's two), then its time per launch at the path's
three launches beside ``torch.bmm`` (with the activation) on the same
operands, by CUDA events, three ways: back-to-back launches, a held stream
(``chip_smoke._held_queue_ms``: the host's enqueueing kept out) and the
profiler's device time (``chip_smoke._kernel_device_ms``, the way
chip_smoke.py times its ``library_ms``), with the device kernels each
``torch.bmm`` call launches, as the profiler counts them in three windows.

    PYTHONPATH=src python3 scripts/gmm_timing.py      # needs one CUDA card

The path is qwen3-moe-30b-a3b's MoE FFN: E 128 experts, C 320 buffer rows
(4 token groups x capacity 80), D 2048 and F 768 for the gate (silu) and up
products, D 768 and F 2048 for the down product.  Each time is the median
over 5 repetitions of the mean of 20 back-to-back launches, after 3 launches
of warm-up; chip_smoke.py gives the profiler's device times.
"""
from __future__ import annotations

import statistics
import subprocess
import sys
import time

from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

from repro_torch.kernels import moe_gmm  # noqa: E402

TOL = 2.0 ** -7  # chip_smoke.py's GMM_TOL
BOUND_MS = 0.1891  # 633.3 MB at 3.35 TB/s (chip_smoke.py's _gmm_bound)
CALLS = 20  # calls of a held-stream or profiler timing
CHECKS = [(1, 64, 64, 64), (1, 128, 64, 256), (2, 128, 256, 256),
          (1, 1, 8, 8), (3, 70, 50, 33), (3, 320, 40, 264),
          (128, 320, 2048, 768), (128, 320, 768, 2048)]
PATH = [(2048, 768, "none"), (2048, 768, "silu"), (768, 2048, "none")]
ACT = {"none": lambda t: t, "silu": F.silu}


def _operands(gen, E, C, D, F_):
    x = torch.randn((E, C, D), generator=gen, device="cuda").to(torch.bfloat16)
    w = (torch.randn((E, D, F_), generator=gen, device="cuda")
         * D ** -0.5).to(torch.bfloat16)
    return x, w


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


def main() -> int:
    if not torch.cuda.is_available():
        print("gmm_timing: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    t0 = time.perf_counter()
    moe_gmm.build()
    print(f"build {time.perf_counter() - t0!r} s")
    print(moe_gmm.LIBRARY.build_info["log"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    failures = 0
    for E, C, D, F_ in CHECKS:
        x, w = _operands(gen, E, C, D, F_)
        got = moe_gmm.expert_matmul(x, w).float()
        want = moe_gmm.reference_expert_matmul(x, w).float()
        top = float(want.abs().max())
        d = (got - want).abs()
        ok = bool((d <= TOL * (want.abs() + top)).all())
        failures += not ok
        print(f"{(E, C, D, F_)}: max error {float(d.max()) / top!r} of the "
              f"largest |want|, within {TOL}: {ok}")
    for D, F_, act in PATH:
        x, w = _operands(gen, 128, 320, D, F_)
        kernel = _ms(lambda: moe_gmm.expert_matmul(x, w, act))
        library = _ms(lambda: ACT[act](torch.bmm(x, w)))
        print(f"(128, 320, {D}) x (128, {D}, {F_}), {act}: kernel {kernel!r} "
              f"ms, torch.bmm {library!r} ms, kernel / library "
              f"{kernel / library!r}, share of the {BOUND_MS} ms bound "
              f"{BOUND_MS / kernel!r}")
        for what, fn, name in (
                ("kernel", lambda: moe_gmm.expert_matmul(x, w, act),
                 "expert_matmul_kernel"),
                ("torch.bmm", lambda: ACT[act](torch.bmm(x, w)), None)):
            held = cs._held_queue_ms(fn, CALLS)
            prof = cs._kernel_device_ms(fn, CALLS, name)
            windows = [cs._device_events(lambda: [fn() for _ in range(CALLS)])
                       for _ in range(3)]
            print(f"  {what}: held stream {held!r} ms, profiler "
                  f"{prof!r} ms a call; device kernels of {CALLS} calls in "
                  f"three profiler windows: "
                  f"{[dict(count) for _, _, count in windows]}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
