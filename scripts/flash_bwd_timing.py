#!/usr/bin/env python3
"""The flash-attention backward kernel on the card, quickly: its build
report and the instructions of each of its kernels (``cuobjdump -sass``:
tensor-core ``HGMMA`` against fp32 ``FFMA``), a check against autograd
through its plain version at chip_smoke.py's FLASH_GENERIC shapes, the
card-only tests' shapes and qwen2-1.5b's path shape (each gradient within
FLASH_BWD_TOL, two launches the same bits), the float64 witness at the path
shape, then its time per launch there on a held stream, beside
``scaled_dot_product_attention``'s backward, the plain version and the
bound.

    PYTHONPATH=src python3 scripts/flash_bwd_timing.py      # needs one CUDA card
    PYTHONPATH=src python3 scripts/flash_bwd_timing.py --variant hilo=build/hilo.cu

Each ``--variant NAME=FILE.cu`` builds another version of the kernel with
the same C entry (a copy of ``csrc/flash_attention_bwd.cu`` changed for an
ablation, kept in a gitignored directory such as ``build/``) and times it
beside the kernel, in turns (variant, kernel, kernel, variant), after
holding it to FLASH_BWD_TOL at the path shape.  The path is path 4's
qwen2-1.5b attention: B 2, S 2048, 12 query heads on 2 kv heads of width
128, causal.  The tolerances, bound and library call are chip_smoke.py's.
"""
from __future__ import annotations

import argparse
import importlib
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from _kernel_timing import sass_counts, variant_library, with_library  # noqa: E402

fa = importlib.import_module("repro_torch.kernels.flash_attention")

# (B, Sq, Skv, Hq, Hkv, hd, causal, window, softcap), FLASH_GENERIC's order
PATH = (2, 2048, 2048, 12, 2, 128, True, None, None)
PATH_KEY = (2, 2048, 12, 2048, 2, 128, True, None, None)  # chip_smoke's key
# chip_smoke.py's generic shapes, the card-only tests' new ones (tile
# edges, blind rows, G 6 and 8, softcaps at hd 32 and 256, Sq != Skv both
# ways), the path
CHECKS = [*cs.FLASH_GENERIC,
          (1, 63, 65, 2, 1, 64, True, None, None),
          (1, 129, 127, 4, 2, 128, False, None, None),
          (2, 200, 100, 6, 1, 64, True, 24, None),
          (1, 160, 160, 12, 2, 128, True, None, None),
          (1, 192, 192, 8, 1, 64, True, 80, None),
          (1, 130, 130, 4, 2, 32, True, None, 20.0),
          (1, 150, 150, 2, 1, 256, True, None, 50.0),
          (1, 100, 300, 4, 2, 64, False, 50, None),
          PATH]
CALLS = 20  # launches a held-queue timing takes


def _with(lib, fn):
    return with_library(fa, "BWD_LIBRARY", lib, fn)


def _case(gen, shape):
    kw = cs._flash_kw(shape)
    return cs._flash_bwd_operands(fa, gen, shape, kw, "cuda"), kw


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--variant", action="append", default=[],
                        metavar="NAME=FILE.cu")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("flash_bwd_timing: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs._card_line())
    t0 = time.perf_counter()
    fa.build()
    path = fa.BWD_LIBRARY.build()
    print(f"build {time.perf_counter() - t0!r} s")
    print(fa.BWD_LIBRARY.build_info["log"])
    for fn, n in sass_counts(path).items():
        print(f"sass {fn}: {dict(n)}")
    libs = {"kernel": fa.BWD_LIBRARY}
    for v in args.variant:
        name, source = v.split("=", 1)
        libs[name] = variant_library(fa.BWD_LIBRARY, name, source)

    gen = torch.Generator().manual_seed(0)
    failures = 0
    for shape in CHECKS:
        try:
            cs._flash_bwd_check(fa, [_case(gen, shape)], f"at {shape}")
        except AssertionError as e:
            failures += 1
            print(f"FAILED: {e}")
    case = _case(gen, PATH)
    cs._flash_bwd_check(fa, [case], "at the path shape (random operands)",
                        witness=True)
    for name, lib in libs.items():
        if name != "kernel":
            try:
                _with(lib, lambda: cs._flash_bwd_check(
                    fa, [case], f"variant {name} at the path shape",
                    witness=True))
            except AssertionError as e:
                failures += 1
                print(f"FAILED: {e}")

    order = [n for n in libs if n != "kernel"]
    turns = order + ["kernel", "kernel"] + order[::-1] if order else \
        ["kernel", "kernel"]
    times: dict = {}
    for name in turns:
        ms = _with(libs[name], lambda: cs._held_queue_ms(
            lambda: fa.flash_attention_bwd(*case[0], **case[1]), CALLS))
        times.setdefault(name, []).append(ms)
    for name, lib in libs.items():
        _, by_name, count = _with(lib, lambda: cs._device_events(
            lambda: [fa.flash_attention_bwd(*case[0], **case[1])
                     for _ in range(CALLS)]))
        print(f"{name}, device time per launch by kernel (profiler): " +
              ", ".join(f"{k} {us / CALLS / 1e3!r} ms ({count[k]} events)"
                        for k, us in by_name.items()))
    bound, by, n_ops, n_bytes = cs._flash_bwd_bound(PATH_KEY)
    print(f"timed on {cs._card_line()}")
    for name, ms in times.items():
        best = min(ms)
        print(f"{name}: {ms!r} ms per launch at {PATH}; "
              f"{n_ops / (best * 1e-3) / 1e12!r} TFLOP/s of the five "
              f"products, {bound / best!r} of the {bound!r} ms bound ({by})")
    library = cs._held_queue_ms(cs._flash_bwd_library(*case), CALLS)
    plain = cs._held_queue_ms(
        lambda: fa.reference_attention_bwd(*case[0], **case[1]), 3)
    print(f"scaled_dot_product_attention's backward {library!r} ms, plain "
          f"version {plain!r} ms per call")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
