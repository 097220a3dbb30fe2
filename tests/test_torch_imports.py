"""The port's rules: ``repro_torch`` and ``chip_smoke.py`` import neither JAX
nor anything of the JAX package, importing the port initialises no CUDA,
and the torch solvers never fall back to the CPU unasked."""
from __future__ import annotations

import ast
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch.core as T

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def _forbidden(tree: ast.AST) -> list[str]:
    """Absolute imports of ``jax`` or ``repro`` (``repro_torch`` passes)."""
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [n for n in names if n.split(".")[0] in ("jax", "repro")]
    return found


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_repro(path):
    assert _forbidden(ast.parse(path.read_text())) == []


def test_scan_catches_forbidden_imports():
    src = ("import jax.numpy as jnp\nfrom repro.core import solve\n"
           "import repro\nfrom repro_torch.core import solve\n"
           "from . import engine\n")
    assert _forbidden(ast.parse(src)) == ["jax.numpy", "repro.core", "repro"]


def test_import_initialises_no_cuda():
    code = ("import sys, torch, repro_torch, repro_torch.core, "
            "repro_torch.core.torch_solvers, repro_torch.kernels.minplus, "
            "repro_torch.kernels.flash_attention, repro_torch.kernels.ssd, "
            "repro_torch.kernels.ops, repro_torch.configs, "
            "repro_torch.models, repro_torch.msl, repro_torch.serving, "
            "repro_torch.optim, repro_torch.data, repro_torch.train, "
            "repro_torch.serve, repro_torch.serve.__main__, "
            "repro_torch.sweep, repro_torch.sweep.__main__, "
            "repro_torch.sweep.artifacts, repro_torch.ft\n"
            "assert not torch.cuda.is_initialized()\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'repro.'))\n"
            "               or m == 'repro' for m in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env={"PYTHONPATH": str(REPO / "src"),
                                          "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("solver", ["dfts_torch", "bcd_torch"])
def test_no_gpu_and_no_device_raises(monkeypatch, solver):
    """Without a card the torch solvers raise unless asked for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cands = T.candidate_sets(3, 0, T.NSFNET_NODES, T.SOURCE, T.DEST)
    p = T.ProblemInstance(T.nsfnet(source=T.SOURCE), T.resnet101_profile(),
                          T.ServiceChainRequest("resnet101", T.SOURCE, T.DEST,
                                                batch_size=2, mode=T.IF),
                          3, cands)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.solve(p, solver)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.solve_batch([p] * 4, solver, dedup=False, min_batch=1)
    assert T.solve(p, solver, device="cpu").feasible


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """Without a card, or without the repository around it, chip_smoke.py
    exits non-zero and prints no result line."""
    script = REPO / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, cwd=script.parent,
                          env={"PATH": "/usr/bin:/bin",
                               "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
