"""Pipeline-vs-sequential equivalence check, the JAX package's
``repro.msl.pipeline_check``:

    PYTHONPATH=src python -m repro_torch.msl.pipeline_check qwen3-14b \\
        [--device cpu] [--backend gloo|nccl]

The JAX package's reduced config (``cfg.reduced()``) at B 4 x S 16
through K 2 stages and M 2 microbatches on the reference's ``(2, 2)``
mesh: 4 ranks (``launch.ranks.spawn``), one a (stage, replica), each
drawing the seed-0 weights and keeping its stage.  Each last-stage rank's
rows of the pipelined hidden state within 5e-2 of the sequential
forward's (bf16 residual accumulation); then one pipelined train step on
every rank, with a finite loss, that moves the rank's parameters.  It
runs on the card unless ``--device cpu`` is given (every rank on the one
card over gloo, or one card a rank over ``--backend nccl``); without a
card it exits 2.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

B, S, M = 4, 16, 2
K, N_DATA = 2, 2


def _rank(rank: int, arch: str, device: str) -> None:
    from ..configs import ARCHS
    from ..models import transformer as T
    from ..models.layers import Ctx
    from ..optim import make_optimizer
    from .pipeline import (
        local_shards,
        make_pipeline_mesh,
        make_pipeline_train_step,
        pipeline_forward,
        stage_params,
    )
    from .planner import PipelinePlan

    cfg = ARCHS[arch].reduced()
    if cfg.n_layers % len(cfg.pattern):
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not whole "
                         f"repetitions of the pattern")
    R = cfg.n_layers // len(cfg.pattern)
    mesh = make_pipeline_mesh(K, N_DATA, device=device)
    dev = mesh.device
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                           device=dev)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                                 ).to(dev)
             for k in ("tokens", "targets")}
    plan = PipelinePlan(K=K, segments=[(1, R // 2), (R // 2 + 1, R)],
                        placement=["p0g0", "p0g1"], n_groups=R,
                        predicted_latency_s=0.0, breakdown={})
    with torch.no_grad():
        hidden_pp, _ = pipeline_forward(params, batch, cfg, mesh, plan, M)
        if hidden_pp is not None:
            from .pipeline import replica_rows

            pos = torch.arange(S, device=dev).expand(B, S)
            hidden_ref, _, _ = T.forward(params, cfg, batch["tokens"],
                                         Ctx(mode="train", positions=pos))
            rows = replica_rows(B, M, N_DATA, mesh.replica).to(dev)
            err = float((hidden_pp.float() - hidden_ref[rows].float()
                         ).abs().max())
            print(f"rank {rank} (stage {mesh.stage}, replica "
                  f"{mesh.replica}, {mesh.route}): pipeline-vs-sequential "
                  f"max_err={err:.6f}", flush=True)
            assert err < 5e-2, err  # bf16 residual accumulation tolerance

    sp = stage_params(params, cfg, plan, mesh.stage)
    before = [p.detach().clone() for p in T.tree_leaves(sp)]
    opt = make_optimizer(cfg.optimizer, total=10)
    step = make_pipeline_train_step(cfg, mesh, plan, M, opt)
    sp, _, metrics = step(sp, opt.init(local_shards(sp), cfg), batch)
    loss = float(metrics["loss"])
    if rank == 0:
        print(f"pipelined train step loss={loss:.4f}", flush=True)
    assert np.isfinite(loss)
    delta = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(before, T.tree_leaves(sp)))
    assert delta > 0.0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.msl.pipeline_check")
    ap.add_argument("arch", nargs="?", default="qwen3-14b")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"))
    args = ap.parse_args(argv)

    from ..core.torch_solvers import resolve_device
    from ..launch.ranks import spawn

    try:
        resolve_device(args.device)
    except RuntimeError as exc:
        ap.error(f"{exc} (--device cpu)")
    spawn(_rank, K * N_DATA, (args.arch, args.device), backend=args.backend,
          timeout_s=600.0)
    print(f"{K} x {N_DATA} ranks over {args.backend} on {args.device}")
    print("PIPELINE CHECK OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
