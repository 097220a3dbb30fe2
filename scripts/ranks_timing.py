"""Where path 10's time goes: ``chip_smoke.run_ranks_path`` on the card,
each rank's pipeline phases timed (a synchronise on either side of each
call of ``msl.pipeline``'s forward, backward, hand-offs, gradient
reductions and all-reduces), printed as ``[rank R] <phase> <s> s``.

    PYTHONPATH=src python3 scripts/ranks_timing.py [--runs N]

It builds the kernels first, as ``chip_smoke.py`` does.
"""
from __future__ import annotations

import argparse
import importlib
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(ROOT / "scripts")]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

PHASES = ("_ranks_run", "_ranks_value_and_grad", "_reduce_grads",
          "_all_reduce", "_send", "_recv", "_stage_apply", "_loss",
          "_finish")


def timed_phases() -> None:
    """A rank's setup: every function of PHASES in ``msl.pipeline``
    wrapped to print its wall between two synchronisations."""
    import torch.distributed as dist

    from repro_torch.msl import pipeline as MP

    def wrap(name):
        fn = getattr(MP, name)

        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            print(f"[rank {dist.get_rank()}] {name} "
                  f"{time.perf_counter() - t0:.3f} s", flush=True)
            return out

        setattr(MP, name, timed)

    for name in PHASES:
        wrap(name)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=1)
    args = ap.parse_args()
    import ranks_timing

    torch.backends.cuda.matmul.allow_tf32 = False
    card = cs._card_line()
    mods = {m: importlib.import_module(f"repro_torch.kernels.{m}")
            for m in dict.fromkeys(map(cs._module, cs.KERNELS))}
    cs.build_kernels(mods)
    for _ in range(args.runs):
        t0 = time.perf_counter()
        cs.run_ranks_path(mods, torch.device("cuda"), card,
                          rank_setup=ranks_timing.timed_phases)
        print(f"path 10 in {time.perf_counter() - t0!r} s on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
