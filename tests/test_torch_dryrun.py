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
