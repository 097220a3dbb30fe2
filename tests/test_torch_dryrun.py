"""The port's dry run (``repro_torch.launch.dryrun``) end to end on the CPU,
and its constraint sites.

The cell is the reference test's own (``tests/test_roofline.py``:
mamba2-370m at long_500k on the single mesh), run in a subprocess (the
fake process group is process-global) that writes its artifact to a
temporary directory, never to the repo.  The constraint sites the port's
models carry are no-ops without mesh rules, so the port's CPU parity tests
run the same code as before.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from repro_torch.models import sharding as S

SRC = str(Path(__file__).resolve().parents[1] / "src")

# the keys of the JAX package's artifact (src/repro/launch/dryrun.py), with
# fits_80gb for fits_16gb
KEYS = {"arch", "shape", "mesh", "status", "devices", "t_lower_s",
        "t_compile_s", "memory", "cost", "collectives", "params", "tokens",
        "roofline", "hlo_bytes"}
MEMORY = {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
          "per_device_bytes", "fits_80gb"}
COST = {"flops_per_device", "hbm_bytes_per_device", "builtin_flops",
        "builtin_bytes"}
COLLECTIVES = {"bytes_per_device", "counts", "total_bytes_per_device",
               "unknown_trip_counts"}
ROOFLINE = {"arch", "shape", "mesh", "chips", "flops_per_device",
            "hbm_bytes_per_device", "coll_bytes_per_device",
            "model_flops_global", "peak_flops", "hbm_bw", "t_compute",
            "t_memory", "t_collective", "bottleneck", "useful_flops_ratio",
            "roofline_fraction"}

CELL = r"""
import json, sys
from repro_torch.launch.dryrun import run_cell
out = run_cell("mamba2-370m", "long_500k", "single")
open(sys.argv[1], "w").write(json.dumps(out))
"""


def test_dryrun_single_cell_end_to_end(tmp_path):
    art = tmp_path / "mamba2-370m__long_500k__single.json"
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", CELL, str(art)],
                          capture_output=True, text=True, timeout=60,
                          env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    j = json.loads(art.read_text())
    assert j["status"] == "ok" and j["devices"] == 256
    assert j["memory"]["fits_80gb"]
    assert j["roofline"]["bottleneck"] in ("compute", "memory", "collective")
    assert j["cost"]["flops_per_device"] > 0
    assert KEYS <= set(j) and MEMORY <= set(j["memory"])
    assert COST <= set(j["cost"]) and COLLECTIVES <= set(j["collectives"])
    assert ROOFLINE <= set(j["roofline"])
    # a decode step runs no kernel: the SSD decode is plain PyTorch
    assert j["cost"]["kernel_flops"] == {}
    assert j["tokens"] == 1


# recurrentgemma-9b's train_4k multi at reduced size: a (pod, data, model)
# mesh of 16 ranks and a batch of 8 below it (the 2d strategy), so the rows
# are split over (pod, data), 2 a rank, and the residual's sequence over
# model; the RG-LRU gates' weight gradients then multiply a strided shard
# of the flattened (B, S) under DTensor's own rule
POD_CELL = r"""
import json, sys
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import make_mesh, start_fake_group
start_fake_group(16)
mesh = make_mesh((2, 2, 4), ("pod", "data", "model"))
cfg = get_config("recurrentgemma-9b").reduced(n_layers=3)
out = run_cell(cfg, ShapeConfig("train_pod", 64, 8, "train"), mesh)
open(sys.argv[1], "w").write(json.dumps(out))
"""


def test_dryrun_rglru_train_with_rows_over_two_mesh_dims(tmp_path):
    """The RG-LRU block's train step on that mesh gives counts: its gate
    products run on each device's shards (``layers._gate_product``), and
    the counted FLOPs hold the model's share within the smoke's train band
    (a train step recomputes its forward)."""
    art = tmp_path / "pod.json"
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", POD_CELL, str(art)],
                          capture_output=True, text=True, timeout=180,
                          env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    j = json.loads(art.read_text())
    assert j["status"] == "ok" and j["devices"] == 16
    assert j["strategy"] == "2d"
    assert j["cost"]["kernel_flops"]["rglru"] > 0
    assert j["cost"]["kernel_flops"]["rglru_bwd"] > 0
    assert 0.5 <= j["roofline"]["useful_flops_ratio"] <= 1.0


# the shard sites on real values: four gloo ranks on the CPU, a (2, 2)
# ('data', 'model') mesh, float64; each case's output and the gradients of
# both arguments against the plain computation
SITES = r"""
import json, os, sys
import torch
import torch.distributed as dist


def run(rank, port, out):
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port))
    dist.init_process_group("gloo", rank=rank, world_size=4)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.models import layers as L, sharding as S

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    g = torch.Generator().manual_seed(0)
    u = torch.randn(4, 6, 8, generator=g, dtype=torch.float64)
    w = torch.randn(8, 8, generator=g, dtype=torch.float64)
    table = torch.randn(12, 8, generator=g, dtype=torch.float64)
    tokens = torch.randint(0, 12, (4, 6), generator=g)
    cot = torch.randn(4, 6, 8, generator=g, dtype=torch.float64)
    R, S0, S1, S2 = Replicate(), Shard(0), Shard(1), Shard(2)
    cases = [("gate", [S0, S2], [R, S0]), ("gate", [S2, R], [R, S0]),
             ("gate", [R, R], [R, S0]), ("gate", [S1, S0], [R, S0]),
             ("gate", [R, S2], [R, R]), ("lookup", [R, S0], [S0, R])]
    errs = []
    with S.mesh_rules(S.make_rules(mesh, "2d")):
        for site, pa, pb in cases:
            if site == "gate":
                fn, a, b = L._gate_product, u, w
            else:
                fn, a, b = S.lookup, table, tokens
            ad = distribute_tensor(a, mesh, pa).requires_grad_()
            bd = distribute_tensor(b, mesh, pb)
            leaves = [ad]
            if b.is_floating_point():
                bd.requires_grad_()
                leaves.append(bd)
            y = fn(ad, bd)
            got = [y, *torch.autograd.grad(
                (y * distribute_tensor(cot, mesh, [R, R])).sum(), leaves)]
            ap = a.clone().requires_grad_()
            plain = [ap]
            bp = b.clone().requires_grad_() if b.is_floating_point() else b
            if b.is_floating_point():
                plain.append(bp)
            yp = ap @ bp if site == "gate" else ap[bp]
            want = [yp, *torch.autograd.grad((yp * cot).sum(), plain)]
            errs.append(max(float((x.full_tensor() - y_).abs().max())
                            for x, y_ in zip(got, want)))
    if rank == 0:
        open(out, "w").write(json.dumps(errs))
    dist.destroy_process_group()


if __name__ == "__main__":
    torch.multiprocessing.spawn(run, args=(int(sys.argv[1]), sys.argv[2]),
                                nprocs=4)
"""


def test_shard_sites_on_a_gloo_mesh_give_the_plain_values(tmp_path):
    """``layers._gate_product`` (each way it lays out the product) and the
    vocab-parallel ``sharding.lookup`` on four gloo ranks: the output and
    the arguments' gradients equal the plain computation's.  A replicated
    argument's gradient is a partial sum where the output is split
    (``sharding.local_call``)."""
    import socket

    script = tmp_path / "sites.py"
    script.write_text(SITES)
    out = tmp_path / "errs.txt"
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, str(script), str(port), str(out)],
                          capture_output=True, text=True, timeout=180,
                          env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    errs = json.loads(out.read_text())
    assert len(errs) == 6 and max(errs) < 1e-12, errs


def test_constraint_sites_are_identity_without_rules():
    x = torch.randn(2, 8, 4, 16)
    assert S.constrain(x, ("batch", "seq", None, None)) is x
    assert S.constrain_first(x, [("batch", None, "tp", None)]) is x
    assert S.positions(x, 8).shape == (2, 8)
    table, tokens = torch.randn(10, 3), torch.tensor([[1, 9]])
    assert torch.equal(S.lookup(table, tokens), table[tokens])
    assert S.laid_out_as(x, x) is x
    assert S.splittable(x, -1, 4) is x
    # rules active, but no DTensor: the sites leave a plain tensor alone
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"), shape=(2, 2))
    with S.mesh_rules(S.make_rules(mesh, "2d")):
        assert S.constrain(x, ("batch", None, None, None)) is x
        assert not S.sharded(x)


@pytest.mark.parametrize("strategy, batch, want", [
    ("fsdp", 256, (("data", "model"), None)),
    ("2d", 128, ("data", "model")),
    ("2d", 1, (None, "model")),
])
def test_production_rules_on_the_h100_mesh(strategy, batch, want):
    """The single mesh's rules on a (batch, heads) tensor: batch over
    (data, model) under fsdp at a batch that covers the 256 cards (heads
    then unsharded), over data under 2d with the heads over the NVLink
    node, the batch unsharded at 1."""
    from repro_torch.launch.mesh import SINGLE_AXES, SINGLE_SHAPE

    mesh = SimpleNamespace(mesh_dim_names=SINGLE_AXES, shape=SINGLE_SHAPE)
    rules = S.make_rules(mesh, strategy)
    assert rules.resolve(("batch", "tp"), (batch, 32)) == want
