"""Dry run of the production H100 meshes: for every (arch x shape x mesh)
cell, whether it fits a card's HBM and its roofline, without allocating
anything or touching a device, the JAX package's ``launch/dryrun.py``.

A cell starts a fake process group of the mesh's size in its process
(collectives return at once and move nothing), draws the full-size
parameters and the step's other arguments as fake DTensors laid out by the
mesh rules (``launch/specs.py``), and runs the step once under
``roofline.op_cost.OpCost``, which counts what one device runs: the local
ops' FLOPs and HBM bytes, the collectives DTensor issues, the hand-written
kernels' work (their stand-ins) and the storages alive.  It writes one
JSON artifact with the reference's keys (``fits_80gb`` for ``fits_16gb``).
The fake group is process-global, so ``--all`` runs each cell in a
subprocess of its own.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--force] [--quick]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --cell ARCH SHAPE MESH
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback
from pathlib import Path

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
MESHES = ("single", "multi")


def cell_path(arch: str, shape: str, mesh: str) -> Path:
    return ARTIFACTS / f"{arch}__{shape}__{mesh}.json"


def _local_tensors(tree) -> list:
    """Every tensor of ``tree``, a DTensor as its local shard."""
    from torch.distributed.tensor import DTensor

    from ..roofline.op_cost import tensors

    return [t.to_local() if isinstance(t, DTensor) else t
            for t in tensors(tree)]


def _storages(tree) -> dict:
    """{storage: bytes} of the local shards of every tensor in ``tree``
    (a storage shared by several leaves counted once)."""
    return {t.untyped_storage(): t.untyped_storage().nbytes()
            for t in _local_tensors(tree)}


def _mesh_of(mesh_name: str):
    from .mesh import (MULTI_SHAPE, SINGLE_SHAPE, make_production_mesh,
                       start_fake_group)

    multi = mesh_name == "multi"
    n = 1
    for d in (MULTI_SHAPE if multi else SINGLE_SHAPE):
        n *= d
    start_fake_group(n)
    return make_production_mesh(multi_pod=multi)


def run_cell(arch, shape, mesh) -> dict:
    """One cell's artifact.  ``arch`` is a name of ``ARCHS`` or a
    ``ModelConfig``, ``shape`` a name of ``SHAPES`` or a ``ShapeConfig``,
    ``mesh`` "single" or "multi" (this process then starts the fake group
    of its size) or a ``DeviceMesh`` over a group the caller started (a
    small or one-rank mesh: a test, the smoke's one-card cells)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    from ..configs import SHAPES, get_config, shape_applicable
    from ..models.profiles import active_params, total_params
    from ..models.sharding import make_rules, mesh_rules
    from ..roofline.analysis import Roofline
    from ..roofline.op_cost import OpCost
    from .mesh import HBM_PER_CARD
    from .specs import input_specs

    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    mesh_name = mesh if isinstance(mesh, str) else "x".join(
        map(str, tuple(mesh.shape)))
    head = {"arch": cfg.name, "shape": shape.name, "mesh": mesh_name}
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return dict(head, status="skipped", reason=why)
    if isinstance(mesh, str):
        mesh = _mesh_of(mesh)
    n_dev = mesh.size()
    # fsdp (batch over every axis) pays only when the batch covers the
    # mesh; below that it duplicates non-weight compute on idle axes
    strategy = (cfg.sharding_strategy if shape.global_batch >= n_dev
                else "2d")
    rules = make_rules(mesh, strategy)

    t0 = time.perf_counter()
    # serving runs under inference mode: its arguments are made there too
    with FakeTensorMode(), torch.inference_mode(shape.kind != "train"):
        spec = input_specs(cfg, shape, rules)
        args = spec["args"]
        arg_storages = _storages(args)
        t_specs = time.perf_counter() - t0
        t0 = time.perf_counter()
        with implicit_replication(), mesh_rules(rules), OpCost(mesh) as oc:
            oc.track(_local_tensors(args))
            out = spec["fn"](*args)
            peak = oc.peak
        t_run = time.perf_counter() - t0
        out_storages = _storages(out)
    arg_bytes = sum(arg_storages.values())
    alias = sum(n for st, n in out_storages.items() if st in arg_storages)
    out_bytes = sum(out_storages.values()) - alias
    mc = oc.cost

    n_active = active_params(cfg)
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    factor = 6.0 if shape.kind == "train" else 2.0
    model_flops = factor * n_active * tokens
    rf = Roofline(arch=cfg.name, shape=shape.name, mesh=mesh_name,
                  chips=n_dev, flops_per_device=mc.flops,
                  hbm_bytes_per_device=mc.bytes,
                  coll_bytes_per_device=mc.total_coll_bytes,
                  net_bytes_per_device=mc.net_coll_bytes,
                  model_flops_global=model_flops)
    products = sum(v for k, v in oc.flops_by_op.items()
                   if k in ("mm", "addmm", "bmm", "baddbmm", "matmul",
                            "einsum"))
    kernels = {k: v for k, v in oc.flops_by_op.items()
               if k in ("flash_attention", "flash_attention_bwd", "ssd",
                        "ssd_bwd", "moe_gmm", "moe_gmm_bwd", "rglru",
                        "rglru_bwd")}
    return dict(
        head, status="ok", devices=n_dev, strategy=strategy,
        # nothing is lowered or compiled: the time to draw the arguments
        # and the time of the counted run
        t_lower_s=t_specs, t_compile_s=t_run,
        memory={
            "argument_bytes": arg_bytes,
            "output_bytes": out_bytes,
            "temp_bytes": peak - arg_bytes,
            "alias_bytes": alias,
            "per_device_bytes": peak,
            "fits_80gb": bool(peak <= HBM_PER_CARD),
        },
        cost={"flops_per_device": mc.flops,
              "hbm_bytes_per_device": mc.bytes,
              # what torch.utils.flop_counter alone counts (products) and
              # the hand-written kernels' share
              "builtin_flops": products + sum(kernels.values()),
              "builtin_bytes": mc.bytes,
              "kernel_flops": kernels},
        collectives={"bytes_per_device": mc.coll_bytes,
                     "counts": mc.coll_counts,
                     "total_bytes_per_device": mc.total_coll_bytes,
                     "net_bytes_per_device": mc.net_coll_bytes,
                     "unknown_trip_counts": mc.unknown_trip_counts},
        params={"total": total_params(cfg), "active": n_active},
        tokens=tokens,
        roofline=rf.to_dict(),
        hlo_bytes=0,  # no HLO: the ops counted are named in top_ops
        # the ops with the most bytes, the reference's top_ops view
        top_ops=[[name, oc.bytes_by_op[name], oc.flops_by_op[name]]
                 for name, _ in oc.bytes_by_op.most_common(12)],
    )


def enumerate_cells(quick: bool = False):
    from ..configs import ARCHS, SHAPES

    archs = sorted(ARCHS)
    shapes = list(SHAPES)
    if quick:
        archs, shapes = archs[:2], ["train_4k"]
    for arch in archs:
        for shape in shapes:
            for mesh in MESHES:
                yield arch, shape, mesh


def run_all(force: bool = False, quick: bool = False,
            timeout_s: float = 1800.0) -> int:
    """Every cell in a subprocess of its own (the fake group is
    process-global); returns the number of cells in error."""
    ARTIFACTS.mkdir(parents=True, exist_ok=True)
    failures = 0
    cells = list(enumerate_cells(quick))
    env = dict(os.environ)
    src = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    for i, (arch, shape, mesh) in enumerate(cells):
        out = cell_path(arch, shape, mesh)
        if out.exists() and not force:
            prev = json.loads(out.read_text())
            print(f"[{i + 1}/{len(cells)}] {arch} {shape} {mesh}: cached "
                  f"({prev.get('status')})")
            failures += prev.get("status") == "error"
            continue
        t0 = time.time()
        try:
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--cell", arch, shape, mesh],
                capture_output=True, text=True, timeout=timeout_s, env=env)
            rc, stdout, stderr = proc.returncode, proc.stdout, proc.stderr
        except subprocess.TimeoutExpired as e:
            rc, stdout = -1, e.stdout or ""
            stderr = f"timed out after {timeout_s} s"
        if rc != 0:
            failures += 1
            out.write_text(json.dumps({
                "arch": arch, "shape": shape, "mesh": mesh,
                "status": "error", "stderr": str(stderr)[-4000:],
                "stdout": str(stdout)[-2000:]}, indent=2))
        info = json.loads(out.read_text())
        mem = info.get("memory", {})
        print(f"[{i + 1}/{len(cells)}] {arch} {shape} {mesh}: "
              f"{info.get('status')} in {time.time() - t0:.0f} s"
              + (f" fits={mem.get('fits_80gb')} bottleneck="
                 f"{info['roofline']['bottleneck']}"
                 if info.get("status") == "ok" else ""), flush=True)
    return failures


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", nargs=3, metavar=("ARCH", "SHAPE", "MESH"))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--timeout", type=float, default=1800.0)
    args = ap.parse_args()
    if args.cell:
        arch, shape, mesh = args.cell
        ARTIFACTS.mkdir(parents=True, exist_ok=True)
        path = cell_path(arch, shape, mesh)
        try:
            result = run_cell(arch, shape, mesh)
        except Exception:
            path.write_text(json.dumps({
                "arch": arch, "shape": shape, "mesh": mesh, "status": "error",
                "stderr": traceback.format_exc()[-4000:]}, indent=2))
            raise
        path.write_text(json.dumps(result, indent=2))
        print(json.dumps(result, indent=2, default=str))
    elif args.all:
        sys.exit(1 if run_all(args.force, args.quick, args.timeout) else 0)
    else:
        ap.error("give --cell ARCH SHAPE MESH or --all")


if __name__ == "__main__":
    main()
