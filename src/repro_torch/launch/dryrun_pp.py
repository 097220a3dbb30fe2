"""MSL pipeline dry run on the production mesh, the JAX package's
``launch/dryrun_pp.py``: the planner picks K and each stage's group range
on the pod-level topology, and the pipelined train step runs once a stage
on a ``("stage", "data")`` mesh of 512 H100s, each stage's program counted
per device, without allocating anything or touching a device.

For each K of (4, 8) (or the one given), M = max(1, 256 K / 512)
microbatches of 512 / K rows: ``plan_pipeline(cfg, seq_len=4096,
microbatch=512 // K, candidate_K=(K,))`` on the host, its chain latency
adjusted by the GPipe bubble (M + K - 1) / M; the best K's segments are
then rebalanced to ``even_split`` (homogeneous groups make the chain
objective flat, and the solver's first-found tie inflates a stage).
n_data = 512 / K replicas a stage.

Each stage's program differs (stage 0 embeds, stage K - 1 holds the final
norm, the head and the loss), so each runs once, as rank (s, 0) of a fake
process group of 512 ranks, under ``roofline.op_cost.OpCost``: its leaves
and AdamW state laid out as the reference's ``shard_of`` (each leaf split
over ``"data"`` along its first dim n_data divides:
``msl.pipeline.shard_stage``), the global batch's tokens and targets as
arguments.  The counts include the gathers of the leaves, their gradients'
reduce-scatter, the tied table's sum between stage 0 and stage K - 1, and
each hand-off's bytes, forward and backward of every active tick, as the
reference's collective-permute.  The artifact has the reference's keys
(``fits_80gb`` for ``fits_16gb``, mesh ``pp{K}x{n_data}``), the roofline
of the slowest stage, and a ``stages`` list with every stage's terms.

Usage: PYTHONPATH=src python -m repro_torch.launch.dryrun_pp ARCH OUT.json [K]
(the fake group is process-global: one run a process; write OUT.json under
the gitignored ``artifacts/dryrun_torch/``).
"""
from __future__ import annotations

import json
import sys
import time

N_CARDS = 512


def pick_plan(cfg, ks, *, n_cards: int = N_CARDS, batch: int = 256,
              seq: int = 4096, device: str = "cpu"):
    """(plan, M): the bubble-adjusted best K of ``ks``, its segments
    rebalanced to ``even_split``; prints each K's chain latency."""
    from ..core import even_split
    from ..msl import plan_pipeline

    best = None
    for K in ks:
        M = max(1, batch * K // n_cards)
        plan_k = plan_pipeline(cfg, seq_len=seq, microbatch=n_cards // K,
                               candidate_K=(K,), device=device)
        eff = plan_k.predicted_latency_s * (M + K - 1) / M
        print(f"K={K}: chain={plan_k.predicted_latency_s * 1e3:.1f}ms "
              f"bubble-adj={eff * 1e3:.1f}ms segments={plan_k.segments}")
        if best is None or eff < best[0]:
            best = (eff, plan_k, M)
    _, plan, M = best
    plan.segments = even_split(plan.n_groups, plan.K)
    return plan, M


def handoff_bytes(cfg, K: int, M: int, n_data: int, batch: int, seq: int,
                  stage: int) -> int:
    """The closed form of a stage's hand-off bytes a step: each of its M
    active ticks sends (h, aux) on to stage s + 1 (but the last stage) and
    their cotangents back to stage s - 1 (but the first), h the replica's
    rows of the microbatch in the compute type, aux a float32 scalar."""
    import torch

    from ..models.layers import cdt

    rows = batch // M // n_data
    per = rows * seq * cfg.d_model * torch.empty((), dtype=cdt(cfg)
                                                 ).element_size() + 4
    return M * per * ((stage < K - 1) + (stage > 0))


def run_stage(cfg, plan, M: int, n_data: int, stage: int, *, batch: int,
              seq: int) -> dict:
    """Stage ``stage``'s train step counted as rank (stage, 0) of a fake
    group of K x n_data ranks (started and destroyed here)."""
    import torch
    import torch.distributed as dist
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..models import transformer as T
    from ..msl import make_pipeline_mesh, make_pipeline_train_step
    from ..msl.pipeline import local_shards, shard_stage, stage_params
    from ..optim import make_optimizer
    from ..roofline.op_cost import OpCost
    from .dryrun import _local_tensors, _storages
    from .mesh import HBM_PER_CARD, start_fake_group

    K = plan.K
    start_fake_group(K * n_data, rank=stage * n_data)
    try:
        mesh = make_pipeline_mesh(K, n_data, device="cpu")
        t0 = time.perf_counter()
        with FakeTensorMode():
            params = T.init_params(torch.Generator().manual_seed(0), cfg,
                                   device="cpu")
            sp = shard_stage(stage_params(params, cfg, plan, stage), mesh)
            del params
            opt = make_optimizer(cfg.optimizer)
            state = opt.init(local_shards(sp), cfg)
            toks = {k: torch.zeros((batch, seq), dtype=torch.int64)
                    for k in ("tokens", "targets")}
            args = (sp, state, toks)
            arg_bytes = sum(_storages(args).values())
            step = make_pipeline_train_step(cfg, mesh, plan, M, opt)
            with OpCost(mesh.mesh) as oc:
                oc.track(_local_tensors(args))
                step(*args)
                peak = oc.peak
        seconds = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    mc = oc.cost
    lo, hi = plan.segments[stage]
    kernels = {k: v for k, v in oc.flops_by_op.items()
               if k in ("flash_attention", "flash_attention_bwd", "ssd",
                        "ssd_bwd", "moe_gmm", "moe_gmm_bwd", "rglru",
                        "rglru_bwd")}
    return {"stage": stage, "groups": [lo, hi], "t_run_s": seconds,
            "flops_per_device": mc.flops,
            "hbm_bytes_per_device": mc.bytes,
            "coll_bytes_per_device": mc.total_coll_bytes,
            "net_bytes_per_device": mc.net_coll_bytes,
            "collectives": {"bytes_per_device": mc.coll_bytes,
                            "counts": mc.coll_counts},
            "handoff_bytes": mc.coll_bytes["collective-permute"],
            "kernel_flops": kernels,
            "memory": {"argument_bytes": arg_bytes,
                       "per_device_bytes": peak,
                       "fits_80gb": bool(peak <= HBM_PER_CARD)}}


def run_pp(cfg, ks, *, n_cards: int = N_CARDS, batch: int = 256,
           seq: int = 4096) -> dict:
    """The artifact of ``cfg``'s pipelined train step on ``n_cards``
    (every stage counted; the fake group is started here, once a stage)."""
    from ..models.profiles import active_params
    from ..roofline.analysis import Roofline

    plan, M = pick_plan(cfg, ks, n_cards=n_cards, batch=batch, seq=seq)
    K = plan.K
    n_data = n_cards // K
    mesh_name = f"pp{K}x{n_data}"
    model_flops = 6.0 * active_params(cfg) * batch * seq
    stages = []
    for s in range(K):
        st = run_stage(cfg, plan, M, n_data, s, batch=batch, seq=seq)
        rf = Roofline(arch=cfg.name, shape="train_4k", mesh=mesh_name,
                      chips=n_cards, flops_per_device=st["flops_per_device"],
                      hbm_bytes_per_device=st["hbm_bytes_per_device"],
                      coll_bytes_per_device=st["coll_bytes_per_device"],
                      net_bytes_per_device=st["net_bytes_per_device"],
                      model_flops_global=model_flops)
        st["handoff_closed_form"] = handoff_bytes(cfg, K, M, n_data, batch,
                                                  seq, s)
        st["roofline"] = rf.to_dict()
        stages.append(st)
        print(f"stage {s} (groups {st['groups']}): "
              f"{st['flops_per_device']:.3g} FLOP, "
              f"{st['hbm_bytes_per_device']:.3g} B, "
              f"{st['coll_bytes_per_device']:.3g} B of collectives "
              f"({st['handoff_bytes']:.3g} B hand-offs), peak "
              f"{st['memory']['per_device_bytes'] / 1e9:.1f} GB, "
              f"{rf.bottleneck}-bound, {st['t_run_s']:.1f} s", flush=True)

    def t_bound(st):
        r = st["roofline"]
        return max(r["t_compute"], r["t_memory"], r["t_collective"])

    slowest = max(stages, key=t_bound)
    return {
        "status": "ok", "arch": cfg.name, "shape": "train_4k",
        "mesh": mesh_name, "devices": n_cards, "n_micro": M,
        "t_compile_s": sum(st["t_run_s"] for st in stages),
        "plan": {"K": K, "segments": [list(x) for x in plan.segments],
                 "placement": plan.placement,
                 "predicted_latency_s": plan.predicted_latency_s,
                 "breakdown": plan.breakdown},
        "memory": {"per_device_bytes": max(
            st["memory"]["per_device_bytes"] for st in stages),
            "fits_80gb": all(st["memory"]["fits_80gb"] for st in stages)},
        "collectives": dict(slowest["collectives"], stage=slowest["stage"]),
        "roofline": dict(slowest["roofline"], stage=slowest["stage"]),
        "stages": stages,
    }


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) not in (2, 3):
        print(__doc__, file=sys.stderr)
        return 2
    from ..configs import get_config

    arch, out_path = argv[0], argv[1]
    ks = [int(argv[2])] if len(argv) > 2 else [4, 8]
    result = run_pp(get_config(arch), ks)
    with open(out_path, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result["roofline"], indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
