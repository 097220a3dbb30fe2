#!/usr/bin/env python3
"""The planner's host-bound solves, timed against another tree of the repo:
``bcd_torch`` over chip_smoke.py's 96 distinct instances, with a host split
of each pass, and ``plan_pipeline`` (``bcd_torch`` again) for path 2's four
models.

    PYTHONPATH=src python3 scripts/bcd_timing.py                  # this tree
    PYTHONPATH=src python3 scripts/bcd_timing.py --other DIR --pairs 10

Each reading runs in a process of its own (one tree's modules at a time),
with ``--other``'s readings and this tree's in turns (other, this, this,
other, ...), so that the host's drift falls on both alike.  A process runs
``dfts_torch`` over the 96 instances once (as chip_smoke.py's path 1 does
before ``bcd_torch``), then ``--passes`` passes of ``bcd_torch`` over them
(the first as chip_smoke.py's, the rest with the plan memos warm), then
``plan_pipeline`` for each model of chip_smoke.MODELS.  The host split
sums the seconds spent in each function of ``core/torch_solvers.py`` that
the tree has (``_run_tours`` holds the capped-tour build, the scans and the
decodes beneath it, so its share is not added to theirs).  On the card by
default; ``--device cpu`` runs the plain versions.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the functions a pass is split over, where the tree has them: this tree's
# names, then those of the tree before the lockstep waves
SPLIT = ("_run_tours", "_encode_seq", "_tour_operands", "_capped_tour_torch",
         "_capped_tour_torch_tr", "_run_dfts_scan", "_decode_eval_seq",
         "_kseq_torch")


def worker(device: str, passes: int) -> dict:
    """One process's readings of the tree on ``sys.path``."""
    import dataclasses

    import chip_smoke as cs
    import repro_torch.core as C
    import repro_torch.core.torch_solvers as TS
    from repro_torch.configs import ARCHS
    from repro_torch.msl import plan_pipeline

    problems = cs.build_population(C)
    C.solve_batch(problems, "dfts_torch", dedup=False, device=device)
    names = [n for n in SPLIT if hasattr(TS, n)]
    out = {"bcd_s": [], "split_s": []}
    for _ in range(passes):
        spent = dict.fromkeys(names, 0.0)
        originals = {n: getattr(TS, n) for n in names}

        def timed(name, fn):
            def call(*args, **kw):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kw)
                finally:
                    spent[name] += time.perf_counter() - t0
            return call

        for n in names:
            setattr(TS, n, timed(n, originals[n]))
        try:
            t0 = time.perf_counter()
            C.solve_batch(problems, "bcd_torch", dedup=False, device=device)
            out["bcd_s"].append(time.perf_counter() - t0)
        finally:
            for n, fn in originals.items():
                setattr(TS, n, fn)
        out["split_s"].append(spent)
    out["plan_pipeline_s"] = {}
    for name, spec in cs.MODELS.items():
        cfg = dataclasses.replace(ARCHS[name], **spec.overrides)
        t0 = time.perf_counter()
        plan_pipeline(cfg, seq_len=spec.seq, microbatch=spec.batch,
                      mode="IF", device=device)
        out["plan_pipeline_s"][name] = time.perf_counter() - t0
    return out


def reading(root: Path, device: str, passes: int) -> dict:
    """A worker's readings of the tree at ``root``, in a process of its
    own."""
    env = dict(os.environ, PYTHONPATH=f"{root / 'src'}{os.pathsep}{root}")
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--worker",
         "--device", device, "--passes", str(passes)],
        cwd=root, env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"the reading of {root} failed:\n{proc.stdout}"
                           f"{proc.stderr}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path, help="another tree of the repo")
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--passes", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.device, args.passes)))
        return 0
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("bcd_timing: no CUDA device", file=sys.stderr)
            return 1
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip())
    trees = {"this": ROOT}
    if args.other is not None:
        trees = {"other": args.other.resolve(), "this": ROOT}
    order = list(trees)
    got: dict[str, list] = {t: [] for t in trees}
    for i in range(args.pairs):
        for t in (order if i % 2 == 0 else order[::-1]):
            r = reading(trees[t], args.device, args.passes)
            got[t].append(r)
            split = ", ".join(f"{n} {s!r}" for n, s in r["split_s"][0].items())
            print(f"pair {i} {t}: bcd_torch 96 distinct {r['bcd_s']} s; "
                  f"host split of the first pass: {split}; plan_pipeline "
                  f"{r['plan_pipeline_s']} s", flush=True)
    for t, rs in got.items():
        for p in range(args.passes):
            print(f"{t}: bcd_torch pass {p} median "
                  f"{statistics.median(r['bcd_s'][p] for r in rs)!r} s over "
                  f"{len(rs)} readings")
        models = rs[0]["plan_pipeline_s"]
        print(f"{t}: plan_pipeline median " + ", ".join(
            f"{m} {statistics.median(r['plan_pipeline_s'][m] for r in rs)!r} s"
            for m in models))
    if args.other is not None:
        ratios = [b["bcd_s"][0] / a["bcd_s"][0]
                  for a, b in zip(got["other"], got["this"])]
        print(f"this / other, bcd_torch first pass, pair by pair: {ratios}; "
              f"median {statistics.median(ratios)!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
