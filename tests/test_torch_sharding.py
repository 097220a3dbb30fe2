"""The port's sharding rules (``repro_torch.models.sharding``,
``repro_torch.launch.shardings``) against the JAX package's, on the CPU.

The JAX side resolves on an ``AbstractMesh`` (a mesh of axis sizes only);
the port on anything with ``mesh_dim_names`` and a ``shape``.  The JAX
package stacks each pattern slot's leaves over the full repetitions, the
port keeps one leaf per layer, so the reference's stacked specs are
compared without their leading (stacked) ``None``, layer by layer.  The
port's full-size parameters are fake tensors (no memory).
"""
from __future__ import annotations

import dataclasses
import itertools
from functools import partial
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import ARCHS as JAX_ARCHS
from repro.launch import shardings as JSH
from repro.models import sharding as JS
from repro.models import transformer as JT
from repro.optim import make_optimizer as jax_optimizer
from repro_torch.configs import ARCHS
from repro_torch.launch import shardings as SH
from repro_torch.models import sharding as S
from repro_torch.models import transformer as T
from repro_torch.optim import make_optimizer

MESHES = {
    "v5e pod": ((16, 16), ("data", "model")),
    "v5e pods": ((2, 16, 16), ("pod", "data", "model")),
    "H100 single": ((32, 8), ("data", "model")),
    "H100 multi": ((2, 32, 8), ("pod", "data", "model")),
}
LOGICAL = [(None,), ("batch",), ("fsdp", "tp"), ("tp", "fsdp"),
           ("batch", "seq", None), ("batch", None, "tp"),
           ("batch", None, "tp", None), ("batch", "tp", None, None),
           ("expert", "fsdp", None), ("expert", None, "fsdp"),
           ("batch", None, "expert", None), ("batch", "expert", None, None),
           ("seq", "tp"), ("tp", None), ("fsdp", None)]
SIZES = (1, 2, 7, 8, 12, 16, 32, 40, 64, 128, 256, 512, 4096)
FEW_SIZES = (1, 8, 12, 32, 256)  # for specs of 3 and 4 dims


def _rules(mesh_name: str, strategy: str):
    sizes, axes = MESHES[mesh_name]
    ref = JS.make_rules(AbstractMesh(sizes, axes), strategy)
    port = S.make_rules(SimpleNamespace(mesh_dim_names=axes, shape=sizes),
                        strategy)
    return ref, port


@pytest.mark.parametrize("strategy", ["fsdp", "2d"])
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_resolve_matches_the_reference(mesh_name, strategy):
    ref, port = _rules(mesh_name, strategy)
    for logical in LOGICAL:
        assert port.resolve(logical) == tuple(ref.resolve(logical))
        sizes = SIZES if len(logical) <= 2 else FEW_SIZES
        for shape in itertools.product(sizes, repeat=len(logical)):
            assert port.resolve(logical, shape) == tuple(
                ref.resolve(logical, shape)), (logical, shape)


def test_placements_split_a_dim_over_two_axes():
    from torch.distributed.tensor import Replicate, Shard

    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"),
                           shape=(2, 32, 8))
    assert S.placements((("pod", "data"), None, "model"), mesh) == [
        Shard(0), Shard(0), Shard(2)]
    assert S.placements((None, None), mesh) == [Replicate()] * 3


def _ref_params(cfg):
    return jax.eval_shape(partial(JT.init_params, cfg=cfg),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))


def _fake_params(cfg):
    with FakeTensorMode():
        return T.init_params(torch.Generator(), cfg, device="cpu")


def _unstacked(tree, cfg, leaf=lambda spec: spec[1:]):
    """The reference's tree of specs in the port's layout: each stacked
    group's spec (its leading None dropped by ``leaf``) once per layer,
    then the remainder layers as they are."""

    def named(fn, t):
        return ({k: named(fn, v) for k, v in t.items()}
                if isinstance(t, dict) else fn(t))

    def stack(st, pattern, n):
        plen = len(pattern)
        layers = [named(leaf, st["groups"][i])
                  for _ in range(n // plen) for i in range(plen)]
        return {"layers": layers + [named(lambda s: s, r)
                                    for r in st.get("rem", [])]}

    out = {k: v for k, v in tree.items() if k not in ("stack", "encoder")}
    out["stack"] = stack(tree["stack"], cfg.pattern, cfg.n_layers)
    if "encoder" in tree:
        out["encoder"] = stack(tree["encoder"], ("attn",), cfg.enc_layers)
    return out


def _specs(tree):
    """A tree of NamedShardings or PartitionSpecs as tuples."""
    return jax.tree.map(lambda s: tuple(getattr(s, "spec", s)), tree,
                        is_leaf=lambda s: hasattr(s, "spec") or isinstance(
                            s, jax.sharding.PartitionSpec))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_logical_tree_matches_the_reference(arch):
    ref = JS.param_logical_tree(_ref_params(JAX_ARCHS[arch]))
    want = _unstacked(ref, ARCHS[arch])
    got = S.param_logical_tree(_fake_params(ARCHS[arch]))
    assert dict(T.tree_paths(got)) == dict(T.tree_paths(want))


@pytest.mark.parametrize("mesh_name", ["H100 single", "v5e pods"])
@pytest.mark.parametrize("batch", [1, 32, 128, 256])
def test_batch_sharding_matches_the_reference(mesh_name, batch):
    for strategy in ("fsdp", "2d"):
        ref, port = _rules(mesh_name, strategy)
        for ndim in (1, 2, 3):
            assert SH.batch_sharding(port, ndim, batch) == tuple(
                JSH.batch_sharding(ref, ndim, batch).spec)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "mamba2-370m",
                                  "recurrentgemma-9b", "whisper-small",
                                  "gemma2-27b"])
@pytest.mark.parametrize("batch", [128, 1])
def test_cache_shardings_match_the_reference(arch, batch):
    cfg = ARCHS[arch]
    ref_rules, rules = _rules("H100 single", "2d")
    ref_cache = jax.eval_shape(lambda: JT.init_cache(JAX_ARCHS[arch], batch,
                                                     64))
    want = _unstacked({"stack": _specs(JSH.cache_shardings(
        ref_cache, ref_rules, batch))}, cfg)
    with FakeTensorMode():
        cache = T.init_cache(cfg, batch, 64, device="cpu")
    got = SH.cache_shardings(cache, rules, batch)
    assert dict(T.tree_paths(got)) == dict(T.tree_paths(want["stack"]))


def _ref_leaf(tree, path, cfg):
    """The reference's leaf of the port's parameter path: a layer of a
    full repetition is its slot's stacked leaf, a remainder layer its own."""
    if path[0] in ("stack", "encoder"):
        plen = len(cfg.pattern) if path[0] == "stack" else 1
        n = cfg.n_layers if path[0] == "stack" else cfg.enc_layers
        full = n // plen * plen
        i = path[2]
        node = (tree[path[0]]["groups"][i % plen] if i < full
                else tree[path[0]]["rem"][i - full])
        path = path[3:]
    else:
        node = tree
    for k in path:
        node = node[k]
    return node


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-moe-30b-a3b",
                                  "recurrentgemma-9b", "whisper-small"])
def test_opt_state_shardings_match_the_reference(arch, name):
    cfg = dataclasses.replace(ARCHS[arch].reduced(), optimizer=name)
    jcfg = dataclasses.replace(JAX_ARCHS[arch].reduced(), optimizer=name)
    ref_rules, rules = _rules("H100 single", "2d")
    shapes = _ref_params(jcfg)
    ref_state = jax.eval_shape(jax_optimizer(name).init, shapes)
    ref = _specs(JSH.opt_state_shardings(ref_state, shapes, ref_rules))
    with FakeTensorMode():
        params = T.init_params(torch.Generator(), cfg, device="cpu")
        state = make_optimizer(name).init(params, cfg)
    got = SH.opt_state_shardings(state, params, rules)
    paths = [p for p, _ in T.tree_paths(params)]
    if name == "adamw":
        for key in ("m", "v"):
            assert dict(T.tree_paths(got[key])) == dict(T.tree_paths(
                _unstacked(ref[key], cfg)))
        return
    assert len(got["f"]) == len(state["groups"])
    for (idx, stacked), spec in zip(state["groups"], got["f"]):
        assert spec == _ref_leaf(ref["f"], paths[idx[0]], cfg), \
            (paths[idx[0]], stacked)
