#!/usr/bin/env python3
"""The expert matmul's backward (``csrc/moe_gmm_bwd.cu``) on the card: the
instructions of each of its kernels (``cuobjdump -sass``) and, at the MoE
path's three launches, the device kernels of one backward call by the
profiler (the dZ pass where there is an activation and the two GEMMs; no
product that recomputes Z).  chip_smoke.py checks the kernel and times it
beside its bound, the two ``torch.bmm`` and the plain version; this script
prints what it does not.

    PYTHONPATH=src python3 scripts/gmm_bwd_timing.py          # needs one CUDA card
    PYTHONPATH=src python3 scripts/gmm_bwd_timing.py --variant ns4=build/ns4.cu

Each ``--variant NAME=FILE.cu`` builds a changed copy of
``csrc/moe_gmm_bwd.cu`` (the same C entry; an ablation, kept in the
gitignored ``build/``), holds it to chip_smoke.py's GMM_BWD_TOL at the
path's shapes, prints its device kernels of one call and times it in turns
with this tree's on a held stream (variant, tree, tree, variant).  The path
is qwen3-moe-30b-a3b's MoE FFN: E 128 experts, C 320 buffer rows, D 2048
and F 768 for the gate (silu) and up products, D 768 and F 2048 for the
down product.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from _kernel_timing import sass_counts, variant_library, with_library  # noqa: E402

from repro_torch.kernels import moe_gmm  # noqa: E402

PATH = [(128, 320, 2048, 768, "none"), (128, 320, 2048, 768, "silu"),
        (128, 320, 768, 2048, "none")]
CALLS = 20  # calls of a held-stream timing


def _kernel_list(fn) -> list:
    """The device kernels of one call of ``fn`` by the profiler: (name,
    launches, us), a window that agrees with the one before it."""
    before = None
    for _ in range(cs.PROFILE_WINDOWS):
        _, by_name, count = cs._device_events(fn)
        rows = sorted((name, count[name], by_name[name]) for name in by_name)
        if before is not None and [r[:2] for r in rows] == [
                r[:2] for r in before]:
            return rows
        before = rows
    return before


def _listed(rows) -> str:
    return "; ".join(f"{name} x{n} {us!r} us" for name, n, us in rows)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--variant", action="append", default=[],
                        metavar="NAME=FILE.cu")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("gmm_bwd_timing: no CUDA device", file=sys.stderr)
        return 2
    print(cs._card_line())
    moe_gmm.build()
    for fn, n in sass_counts(moe_gmm.BWD_LIBRARY.build()).items():
        print(f"sass {fn}: {dict(n)}")
    variants = {}
    for spec in args.variant:
        name, source = spec.split("=", 1)
        variants[name] = variant_library(moe_gmm.BWD_LIBRARY, name, source)

    gen = torch.Generator().manual_seed(0)
    run = cs._gmm_bwd_run(moe_gmm)
    for shape in PATH:
        case = cs._gmm_bwd_operands(gen, shape, "cuda")
        (x, w, dy), kw = case

        def tree():
            return moe_gmm.expert_matmul_bwd(x, w, dy, **kw)

        print(f"{shape}: device kernels of one backward call: "
              f"{_listed(_kernel_list(tree))}")
        want = run(case, torch.float32)
        for name, lib in variants.items():
            def variant(lib=lib):
                return with_library(moe_gmm, "BWD_LIBRARY", lib, tree)

            rel = [cs._rel(g.float(), v.float())
                   for g, v in zip(variant(), want)]
            print(f"{shape}: {name} against the plain version {rel!r} "
                  f"(limit {cs.GMM_BWD_TOL}); device kernels of one call: "
                  f"{_listed(_kernel_list(variant))}")
            if max(rel) > cs.GMM_BWD_TOL:
                return 1
            turns = [(which, cs._held_queue_ms(
                tree if which == "tree" else variant, CALLS))
                for which in (name, "tree", "tree", name)]
            print(f"{shape}: held stream in turns {turns!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
