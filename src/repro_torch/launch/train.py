"""Training launcher: --arch <id> on one device, data-parallel mode or the
planner's pipeline over K 2 stages, with checkpointing and the synthetic
data pipeline, as the JAX package's ``repro.launch.train``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --steps 50 [--mode dp|msl-pp] [--reduced|--full] [--ckpt-dir DIR] \\
      [--resume] [--device cuda|cpu]

It runs on the card unless ``--device cpu`` is given; without a card it
exits 2.  ``dp`` is ``train.make_train_step``; ``msl-pp`` is
``msl.make_pipeline_train_step`` over the reference's split of the R
pattern groups, ``[(1, R // 2), (R // 2 + 1, R)]``: both stages on the one
device, or, in a started process group of W ranks (torchrun's W processes
start one), on the
reference's ``(2, W // 2)`` mesh, a rank a (stage, replica), each
updating its stage's leaves; rank 0 then prints and writes the
checkpoints, of the whole tree gathered from the stages
(``msl.pipeline.whole_state``).  Checkpoints are the JAX package's format (``repro_torch.ckpt``),
so ``--resume`` takes one written by either package for the same config.
``--reduced`` is the JAX package's reduced config (``cfg.reduced()``, head
width 16), so either package's checkpoint restores into the other's run.
A config with cross-attention trains on ``SyntheticLM``'s memory of
``memory_len`` frames or patches in ``dp`` mode; ``msl-pp`` carries no
memory, as the JAX package's pipeline carries none, and raises.
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--mode", choices=("dp", "msl-pp"), default="dp")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--n-micro", type=int, default=2)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    import tempfile

    import torch

    from ..ckpt import CheckpointManager
    from ..configs import get_config
    from ..core.torch_solvers import resolve_device
    from ..data import BatchSpec, Prefetcher, SyntheticLM, shard_batch
    from ..models import transformer as T
    from ..models.convert import (
        opt_state_from_jax,
        opt_state_to_jax_layout,
        params_from_jax,
        params_to_jax_layout,
    )
    from ..optim import make_optimizer
    from ..train import make_train_step

    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        ap.error(f"{exc} (--device cpu)")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    mesh = plan = None
    started = False  # this launcher started the process group
    if args.mode == "msl-pp":
        import torch.distributed as dist

        from ..msl import PipelinePlan, StageMesh, make_pipeline_mesh

        R = -(-cfg.n_layers // len(cfg.pattern))
        plan = PipelinePlan(K=2, segments=[(1, R // 2), (R // 2 + 1, R)],
                            placement=["s0", "s1"], n_groups=R,
                            predicted_latency_s=0.0, breakdown={})
        if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE",
                                                            "1")) > 1:
            # torchrun's ranks: its env:// rendezvous, nccl for cards
            dist.init_process_group("nccl" if device.type == "cuda"
                                    else "gloo")
            started = True
        n_data = dist.get_world_size() // 2 if dist.is_initialized() else 1
        mesh = make_pipeline_mesh(2, n_data, device=device)
    ranks = args.mode == "msl-pp" and isinstance(mesh, StageMesh)
    if ranks:
        device = mesh.device
    lead = not ranks or dist.get_rank() == 0
    params = T.init_params(torch.Generator(device=device).manual_seed(0), cfg,
                           device=device)
    opt = make_optimizer(cfg.optimizer, lr=args.lr, warmup=5,
                         total=args.steps)

    if args.mode == "msl-pp":
        from ..msl import make_pipeline_train_step

        step_fn = make_pipeline_train_step(cfg, mesh, plan, args.n_micro, opt)
    else:
        step_fn = make_train_step(cfg, opt)

    ckpt = CheckpointManager(args.ckpt_dir or (
        f"{tempfile.gettempdir()}/repro_torch_{args.arch}_ckpt"))
    start = 0
    opt_state = opt.init(params, cfg)
    if args.resume:
        s, state = ckpt.restore()
        if s is not None:
            params = params_from_jax(state["params"], cfg, device)
            opt_state = opt_state_from_jax(state["opt"], params, cfg, device)
            start = s + 1
            if lead:
                print(f"[resume] from step {s}")
    if ranks:
        from ..msl.pipeline import stage_params, whole_state

        # the rank's stage: its leaves and their moments, out of the whole
        whole = opt_state
        opt_state = opt.init(stage_params(params, cfg, plan, mesh.stage), cfg)
        for k in ("m", "v"):
            for dst, src in zip(T.tree_leaves(opt_state[k]), T.tree_leaves(
                    stage_params(whole[k], cfg, plan, mesh.stage))):
                dst.copy_(src)
        opt_state["step"] = whole["step"]
        del whole

    def jax_state():
        p, st = params, opt_state
        if ranks:
            p, st = whole_state(params, opt_state, cfg, mesh, plan, opt)
        return {"params": params_to_jax_layout(p, cfg),
                "opt": opt_state_to_jax_layout(st, p, cfg)}

    spec = BatchSpec(args.batch, args.seq, cfg.vocab_size,
                     memory_len=cfg.memory_len, d_model=cfg.d_model)
    prefetch = Prefetcher(SyntheticLM(spec, seed=0), start_step=start)
    t0 = time.time()
    try:
        for step in range(start, args.steps):
            _, host_batch = prefetch.next()
            batch = shard_batch(host_batch, device)
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            if lead and (step % 10 == 0 or step == args.steps - 1):
                dt = (time.time() - t0) / max(1, step - start + 1)
                print(f"step {step:5d} loss={float(metrics['loss']):.4f} "
                      f"{dt*1e3:.0f} ms/step")
            if args.ckpt_every and step and step % args.ckpt_every == 0:
                state = jax_state()  # every rank: the stages' gather
                if lead:
                    ckpt.save(step, state, blocking=False)
    finally:
        prefetch.close()
    state = jax_state()
    if lead:
        ckpt.save(args.steps - 1, state)
        print(f"done: {args.steps - start} steps; checkpoint at step "
              f"{ckpt.latest_step()}")
    if started:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
