"""Pipeline-vs-sequential equivalence check, the JAX package's
``repro.msl.pipeline_check``:

    PYTHONPATH=src python -m repro_torch.msl.pipeline_check qwen3-14b \\
        [--device cpu]

The JAX package's reduced config (``cfg.reduced()``) at B 4 x S 16
through K 2 stages and M 2 microbatches:
the pipelined hidden state within 5e-2 of the sequential forward's (bf16
residual accumulation), then one pipelined train step with a finite loss
that moves the parameters.  It runs on the card unless ``--device cpu``
is given; without a card it exits 2.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.msl.pipeline_check")
    ap.add_argument("arch", nargs="?", default="qwen3-14b")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    from ..configs import ARCHS
    from ..core.torch_solvers import resolve_device
    from ..models import transformer as T
    from ..models.layers import Ctx
    from ..optim import make_optimizer
    from .pipeline import (
        make_pipeline_mesh,
        make_pipeline_train_step,
        pipeline_forward,
    )
    from .planner import PipelinePlan

    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        ap.error(f"{exc} (--device cpu)")
    cfg = ARCHS[args.arch].reduced()
    if cfg.n_layers % len(cfg.pattern):
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not whole "
                         f"repetitions of the pattern")
    R = cfg.n_layers // len(cfg.pattern)
    params = T.init_params(torch.Generator(device=device).manual_seed(0), cfg,
                           device=device)
    B, S, M = 4, 16, 2
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                                 ).to(device)
             for k in ("tokens", "targets")}
    mesh = make_pipeline_mesh(2, device=device)
    plan = PipelinePlan(K=2, segments=[(1, R // 2), (R // 2 + 1, R)],
                        placement=["p0g0", "p0g1"], n_groups=R,
                        predicted_latency_s=0.0, breakdown={})

    with torch.no_grad():
        hidden_pp, _ = pipeline_forward(params, batch, cfg, mesh, plan, M)
        pos = torch.arange(S, device=device).expand(B, S)
        hidden_ref, _, _ = T.forward(params, cfg, batch["tokens"],
                                     Ctx(mode="train", positions=pos))
    err = float((hidden_pp.float() - hidden_ref.float()).abs().max())
    print(f"pipeline-vs-sequential max_err={err:.6f}")
    assert err < 5e-2, err  # bf16 residual accumulation tolerance

    before = [p.detach().clone() for p in T.tree_leaves(params)]
    opt = make_optimizer(cfg.optimizer, total=10)
    step = make_pipeline_train_step(cfg, mesh, plan, M, opt)
    params, _, metrics = step(params, opt.init(params, cfg), batch)
    loss = float(metrics["loss"])
    print(f"pipelined train step loss={loss:.4f}")
    assert np.isfinite(loss)
    delta = max(float((a.float() - b.float()).abs().max())
                for a, b in zip(before, T.tree_leaves(params)))
    assert delta > 0.0
    print("PIPELINE CHECK OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
