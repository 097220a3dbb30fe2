#!/usr/bin/env python3
"""The RG-LRU scan (``csrc/rglru.cu``) on the card: its build report and
instructions (``cuobjdump -sass``), a check against its plain version at
chip_smoke.py's RGLRU_GENERIC shapes and at the path shape (two launches
the same bits, the float64 witness, the three wrong outputs rejected),
then its time per launch at the path shape, on a held stream (CUDA events)
and by the profiler, beside ``torch.add(a, b, out=h)``, which moves the
same 12 bytes an element without the recurrence, and the plain version.

    PYTHONPATH=src python3 scripts/rglru_timing.py        # needs one CUDA card
    PYTHONPATH=src python3 scripts/rglru_timing.py --config 16,64,8 --config 64,128,3,1
    PYTHONPATH=src python3 scripts/rglru_timing.py --variant old=build/rglru_old.cu

Each ``--config WB,SB,NS[,NO]`` writes a copy of ``csrc/rglru.cu`` with
that slab width, stage length, stage count (and output stages) into the
gitignored ``build/kernels/variants/``; each ``--variant NAME=FILE.cu``
takes another source with the same C entry (an ablation, or another
commit's).  Each is built, checked against the plain version at the path
shape and timed in turns with this tree's kernel (variant, tree, tree,
variant).  The path is recurrentgemma-9b's RG-LRU: B 1, S 4096, W 4096,
float32.
"""
from __future__ import annotations

import argparse
import os
import re
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from _kernel_timing import sass_counts, variant_library, with_library  # noqa: E402

from repro_torch.kernels import build, rglru  # noqa: E402

PATH = (1, 4096, 4096)
CALLS = 20  # calls of a held-stream or profiler timing
FIRST_LAUNCH_S = 30.0  # a first launch still running after this has hung


def _finishes(fn) -> None:
    """Run ``fn`` once and wait for the card, at most FIRST_LAUNCH_S; a
    launch still running then has hung, and the process ends at once."""
    fn()
    done = torch.cuda.Event()
    done.record()
    t0 = time.perf_counter()
    while not done.query():
        if time.perf_counter() - t0 > FIRST_LAUNCH_S:
            print(f"rglru_timing: the first launch did not finish within "
                  f"{FIRST_LAUNCH_S} s", flush=True)
            os._exit(3)
        time.sleep(0.01)


def _config_source(spec: str) -> tuple[str, str]:
    """(name, path) of a copy of csrc/rglru.cu with WB, SB, NS and, where
    given, NO set."""
    values = dict(zip(("WB", "SB", "NS", "NO"),
                      (int(v) for v in spec.split(","))))
    src = rglru.LIBRARY.source.read_text()
    for const, value in values.items():
        src, n = re.subn(rf"constexpr int {const} = \d+;",
                         f"constexpr int {const} = {value};", src)
        if n != 1:
            raise ValueError(f"no single constant {const} in the source")
    name = "_".join(f"{k.lower()}{v}" for k, v in values.items())
    out = build.BUILD_DIR / "variants" / f"rglru_{name}_src.cu"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(src)
    return name, str(out)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", action="append", default=[],
                        metavar="WB,SB,NS[,NO]")
    parser.add_argument("--variant", action="append", default=[],
                        metavar="NAME=FILE.cu")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("rglru_timing: no CUDA device", file=sys.stderr)
        return 2
    print(cs._card_line())
    t0 = time.perf_counter()
    path = rglru.LIBRARY.build()
    print(f"build {time.perf_counter() - t0!r} s")
    print(rglru.LIBRARY.build_info["log"].strip())
    for fn, n in sass_counts(path).items():
        print(f"sass {fn}: {dict(n)}")
    sources = [_config_source(c) for c in args.config] + [
        tuple(v.split("=", 1)) for v in args.variant]
    libs = {name: variant_library(rglru.LIBRARY, name, source)
            for name, source in sources}

    gen = torch.Generator().manual_seed(0)
    a, b = cs._rglru_operands(gen, PATH, "cuda")
    _finishes(lambda: rglru.rglru_scan(a, b))
    cases = [cs._rglru_operands(gen, s, "cuda") for s in cs.RGLRU_GENERIC]
    for (ca, cb), s in zip(cases, cs.RGLRU_GENERIC):
        print(f"{s}: the {'TMA' if rglru.tma_route(ca, cb) else 'cp.async'} "
              f"route")
    failures = 0
    try:
        cs._rglru_check(rglru, cases, "generic")
        cs._rglru_check_witness(rglru, [(a, b)], "at the path shape")
        cs._rglru_rejects_wrong_outputs(rglru, (a, b))
    except AssertionError as e:
        print(f"rglru_timing: {e}")
        failures += 1
    want = rglru.reference_rglru_scan(a, b)
    for name, lib in libs.items():
        got = with_library(rglru, "LIBRARY", lib,
                           lambda: rglru.rglru_scan(a, b))
        rel = float((got - want).abs().max() / want.abs().max())
        print(f"variant {name} at the path shape: {rel!r} of the largest |h| "
              f"from the plain version (limit {cs.RGLRU_TOL})")
        failures += not rel <= cs.RGLRU_TOL

    def tree():
        return rglru.rglru_scan(a, b)

    h = torch.empty_like(a)
    bound, by, _, n_bytes = cs._rglru_bound(PATH)
    profiled = cs._kernel_device_ms(tree, CALLS, cs.KERNELS["rglru"].profiled)
    held = cs._held_queue_ms(tree, CALLS)
    add_prof = cs._kernel_device_ms(lambda: torch.add(a, b, out=h), CALLS,
                                    None)
    add_held = cs._held_queue_ms(lambda: torch.add(a, b, out=h), CALLS)
    plain = cs._kernel_device_ms(lambda: rglru.reference_rglru_scan(a, b), 5,
                                 None)
    print(f"{PATH}: kernel {profiled!r} ms by the profiler, {held!r} ms on a "
          f"held stream: {bound / profiled!r} / {bound / held!r} of the "
          f"{bound!r} ms bound ({by}, {n_bytes} B, "
          f"{n_bytes / (held * 1e-3) / 1e12!r} TB/s held)")
    print(f"{PATH}: torch.add(a, b, out=h), the same bytes without the "
          f"recurrence, {add_prof!r} ms by the profiler, {add_held!r} ms on "
          f"a held stream: {bound / add_held!r} of the bound; the kernel "
          f"{held / add_held!r} x its time; plain version {plain!r} ms")
    turns: dict = {}
    for name, lib in libs.items():
        for which in (name, "tree", "tree", name):
            run = tree if which == "tree" else (
                lambda lib=lib: with_library(rglru, "LIBRARY", lib, tree))
            turns.setdefault(which, []).append(cs._held_queue_ms(run, CALLS))
        prof = cs._kernel_device_ms(
            lambda lib=lib: with_library(rglru, "LIBRARY", lib, tree), CALLS,
            cs.KERNELS["rglru"].profiled)
        print(f"variant {name}: held stream in turns {turns[name]!r} ms "
              f"(tree {turns['tree'][-2:]!r}); by the profiler {prof!r} ms, "
              f"{bound / min(turns[name])!r} of the bound")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
