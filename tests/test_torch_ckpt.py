"""The port's checkpoints against the JAX package's, on the CPU.

The JAX package's parameters and its AdamW or Adafactor state (every
moment drawn at random, the step 1)
are saved by the reference's ``CheckpointManager``; the same trees, carried
over to the port (``convert.params_from_jax``, ``opt_state_from_jax``) and
back to the JAX layout (``params_to_jax_layout``,
``opt_state_to_jax_layout``), are saved by the port's.  The two step
directories hold the same manifest and the same bytes in every leaf file,
bf16 leaves included (written as the reference writes an ``ml_dtypes``
bf16 array), and each package restores the other's checkpoint ``==``.
Then retention, ``latest_step``, and a non-blocking save that the caller
updates in place right after.
"""
from __future__ import annotations

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.ckpt import CheckpointManager as JaxCheckpointManager
from repro.configs import ARCHS as JAX_ARCHS
from repro.models import transformer as JT
from repro_torch.ckpt import CheckpointManager, flatten_with_path
from repro_torch.configs import ARCHS
from repro_torch.models import convert
from repro_torch.models import transformer as T

# bf16 leaves; remainder layers (14 layers of a 3-block pattern); stacked
# vectors and a tied head
CONFIGS = [("qwen2-1.5b", {"param_dtype": "bfloat16"}),
           ("recurrentgemma-9b", {"n_layers": 7}),
           ("mamba2-370m", {})]
IDS = [a for a, _ in CONFIGS]


@functools.lru_cache(maxsize=None)
def _jax_params(arch, over):
    jcfg = JAX_ARCHS[arch].reduced(**dict(over))
    return jcfg, JT.init_params(jax.random.PRNGKey(0), jcfg)


def _jax_state(arch, over, opt_name):
    """The JAX package's config, parameters and optimizer state, every
    moment drawn at random and the step 1 (as after one update)."""
    jcfg, jp = _jax_params(arch, tuple(sorted(over.items())))
    rng = np.random.default_rng(1)
    state = jopt.make_optimizer(opt_name).init(jp)
    state = jax.tree.map(lambda z: np.abs(rng.standard_normal(
        z.shape)).astype(z.dtype), state)
    state["step"] = np.asarray(1, np.int32)
    return jcfg, jp, state


def _port_state(arch, over, jp, state):
    cfg = ARCHS[arch].reduced(**over)
    params = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    opt = convert.opt_state_from_jax(jax.tree.map(np.asarray, state), params,
                                     cfg, "cpu")
    return cfg, params, opt


def _step_dir(d, step):
    return d / f"step_{step:010d}"


def _bits(a) -> np.ndarray:
    """A leaf's raw bytes as a flat uint8 array (a restored bf16 leaf is a
    void array in the reference, a bf16 tensor in the port)."""
    if isinstance(a, torch.Tensor):
        a = (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    return np.ascontiguousarray(np.asarray(a)).view(np.uint8).ravel()


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch, over", CONFIGS, ids=IDS)
def test_same_files_as_the_reference(arch, over, opt_name, tmp_path):
    jcfg, jp, state = _jax_state(arch, over, opt_name)
    cfg, params, opt = _port_state(arch, over, jp, state)
    assert opt["step"] == 1
    JaxCheckpointManager(tmp_path / "jax").save(
        7, {"params": jp, "opt": state})
    CheckpointManager(tmp_path / "port").save(
        7, {"params": convert.params_to_jax_layout(params, cfg),
            "opt": convert.opt_state_to_jax_layout(opt, params, cfg)})
    a, b = _step_dir(tmp_path / "jax", 7), _step_dir(tmp_path / "port", 7)
    assert sorted(p.name for p in a.iterdir()) == sorted(
        p.name for p in b.iterdir())
    manifest = json.loads((a / "manifest.json").read_text())
    assert (a / "manifest.json").read_bytes() == (
        b / "manifest.json").read_bytes()
    dtypes = {leaf["dtype"] for leaf in manifest["leaves"]}
    assert ("bfloat16" in dtypes) == (over.get("param_dtype") == "bfloat16")
    assert "int32" in dtypes  # the step
    if over.get("n_layers") == 7:
        assert any("/rem/0/" in leaf["path"] for leaf in manifest["leaves"])
    for leaf in manifest["leaves"]:
        assert (a / leaf["file"]).read_bytes() == (
            b / leaf["file"]).read_bytes(), leaf


@pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch, over", CONFIGS, ids=IDS)
def test_each_package_restores_the_others(arch, over, opt_name, tmp_path):
    jcfg, jp, state = _jax_state(arch, over, opt_name)
    cfg, params, opt = _port_state(arch, over, jp, state)
    JaxCheckpointManager(tmp_path / "jax").save(
        3, {"params": jp, "opt": state})
    CheckpointManager(tmp_path / "port").save(
        3, {"params": convert.params_to_jax_layout(params, cfg),
            "opt": convert.opt_state_to_jax_layout(opt, params, cfg)})
    # the reference reads the port's checkpoint: every leaf's bytes
    step, tree = JaxCheckpointManager(tmp_path / "port").restore()
    want = flatten_with_path({"params": jp, "opt": state})
    got = flatten_with_path(tree)
    assert step == 3 and [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape, path
        assert np.array_equal(_bits(g), _bits(np.asarray(w))), path
    # the port reads the reference's: the same parameters and state
    step, tree = CheckpointManager(tmp_path / "jax").restore()
    assert step == 3
    p2 = convert.params_from_jax(tree["params"], cfg, "cpu")
    o2 = convert.opt_state_from_jax(tree["opt"], p2, cfg, "cpu")
    for a, b in zip(T.tree_leaves(p2), T.tree_leaves(params)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert o2["step"] == opt["step"] == 1 and o2["groups"] == opt["groups"]
    for k in ("m", "v", "f"):
        if k in opt:
            got, want = T.tree_leaves(o2[k]), T.tree_leaves(opt[k])
            assert len(got) == len(want)
            assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_restored_bf16_leaf_is_a_bf16_tensor(tmp_path):
    x = torch.randn(3, 5).to(torch.bfloat16)
    CheckpointManager(tmp_path).save(0, {"x": x, "n": [torch.tensor(2)],
                                         "s": torch.tensor(0.5).bfloat16()})
    _, tree = CheckpointManager(tmp_path).restore()
    assert tree["x"].dtype == torch.bfloat16 and torch.equal(tree["x"], x)
    n, s = tree["n"][0], tree["s"]
    assert n.dtype == torch.int64 and n.shape == () and int(n) == 2
    assert s.dtype == torch.bfloat16 and s.shape == () and float(s) == 0.5


def test_retention_and_latest_step(tmp_path):
    ck = CheckpointManager(tmp_path, keep=2)
    assert ck.latest_step() is None and ck.restore() == (None, None)
    for step in (1, 5, 12):
        ck.save(step, {"w": torch.full((2,), float(step))})
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_0000000005", "step_0000000012"]
    assert ck.latest_step() == 12
    step, tree = ck.restore(5)
    assert step == 5 and torch.equal(tree["w"], torch.full((2,), 5.0))
    assert JaxCheckpointManager(tmp_path).latest_step() == 12


def test_non_blocking_save_keeps_the_values_of_the_call(tmp_path):
    """The port's optimizers update in place: a save that returns before
    it has written must have copied every leaf, on whatever device."""
    w = torch.arange(1 << 16, dtype=torch.float32)
    b = torch.ones(4, dtype=torch.bfloat16)
    ck = CheckpointManager(tmp_path)
    ck.save(1, {"w": w, "b": b}, blocking=False)
    w.add_(1.0)
    b.mul_(3.0)
    ck.save(2, {"w": w, "b": b}, blocking=False)
    w.zero_()
    ck.wait()
    _, one = ck.restore(1)
    _, two = ck.restore(2)
    assert torch.equal(one["w"], torch.arange(1 << 16, dtype=torch.float32))
    assert torch.equal(one["b"], torch.ones(4, dtype=torch.bfloat16))
    assert torch.equal(two["w"], one["w"] + 1.0)
    assert torch.equal(two["b"], torch.full((4,), 3.0, dtype=torch.bfloat16))


def test_flatten_order_is_jax_tree_order():
    tree = {"b": [jnp.zeros(1), {"z": jnp.ones(2), "a": jnp.ones(3)}],
            "a": None, "c": (jnp.zeros(()),)}
    want = [tuple(getattr(e, "key", getattr(e, "idx", None)) for e in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert [p for p, _ in flatten_with_path(tree)] == want
