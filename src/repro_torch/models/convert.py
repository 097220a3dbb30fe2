"""Carry the JAX package's model parameters and serving caches over to the
port, and the port's caches back.

The JAX parameter pytree, with its leaves as numpy arrays, becomes the
port's dict of tensors: the same names, and the stack unstacked.  The JAX
stack keeps each pattern slot's parameters stacked over the pattern's full
repetitions (``groups[i]`` holds slot ``i`` of every repetition, leading
axis = repetition) plus an unrolled remainder (``rem``); the port keeps one
dict per layer in layer order, so layer ``r * len(pattern) + i`` is
repetition ``r`` of slot ``i``.  A serving cache (``{"stack": {"groups",
"rem"}}`` in the JAX package, ``{"stack": {"layers"}}`` in the port) is
laid out the same way; its ``pos`` leaves are int32 there and int64 here.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from .transformer import tree_map


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16, which torch cannot read
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def params_from_jax(tree, cfg: ModelConfig, device) -> dict:
    """The port's parameters from a JAX parameter pytree (numpy leaves)."""
    if cfg.enc_layers:
        raise NotImplementedError("encoder stacks are not ported yet")
    plen = len(cfg.pattern)
    full_reps = cfg.n_layers // plen
    stack = tree["stack"]
    layers = []
    for r in range(full_reps):
        for i in range(plen):
            layers.append(tree_map(lambda a: _tensor(np.asarray(a)[r], device),
                               stack["groups"][i]))
    for rem in stack["rem"]:
        layers.append(tree_map(lambda a: _tensor(a, device), rem))
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} layers in the tree, {cfg.n_layers} "
                         f"in the config")
    out = {"embed": _tensor(tree["embed"], device),
           "final_norm": _tensor(tree["final_norm"], device),
           "stack": {"layers": layers}}
    if "head" in tree:
        out["head"] = _tensor(tree["head"], device)
    return out


def _unstack(stack, cfg: ModelConfig, leaf) -> list:
    """The layers of a JAX stack (``groups`` stacked over the pattern's full
    repetitions, then ``rem``) in layer order, each leaf through
    ``leaf(name, array)``."""
    plen = len(cfg.pattern)
    layers = [{k: leaf(k, np.asarray(a)[r])
               for k, a in stack["groups"][i].items()}
              for r in range(cfg.n_layers // plen) for i in range(plen)]
    layers += [{k: leaf(k, a) for k, a in rem.items()}
               for rem in stack["rem"]]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} layers in the tree, {cfg.n_layers} "
                         f"in the config")
    return layers


def cache_from_jax(tree, cfg: ModelConfig, device) -> dict:
    """The port's serving cache from the JAX package's (numpy leaves): one
    block cache per layer, ``pos`` as int64."""
    if set(tree) != {"stack"}:
        raise NotImplementedError(f"cache entries {sorted(set(tree))}: only "
                                  f"the stack's caches are ported")

    def leaf(name, a):
        t = _tensor(a, device)
        return t.long() if name == "pos" else t

    return {"stack": {"layers": _unstack(tree["stack"], cfg, leaf)}}


def cache_to_jax_layout(cache, cfg: ModelConfig) -> dict:
    """The inverse of :func:`cache_from_jax`, for comparing a port's cache
    leaf by leaf with the JAX package's: numpy leaves stacked over the
    pattern's full repetitions (``groups``, empty without one) plus
    ``rem``, ``pos`` as int32 and bf16 widened to float32 (numpy has no
    bf16)."""
    layers = cache["stack"]["layers"]
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} layers of caches, {cfg.n_layers} in "
                         f"the config")

    def leaf(name, t):
        t = t.detach().cpu()
        if name == "pos":
            return t.to(torch.int32).numpy()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    plen = len(cfg.pattern)
    full = cfg.n_layers // plen * plen
    groups = [{k: np.stack([leaf(k, layers[j][k])
                            for j in range(i, full, plen)])
               for k in layers[i]} for i in range(plen)] if full else []
    rem = [{k: leaf(k, t) for k, t in c.items()} for c in layers[full:]]
    return {"stack": {"groups": groups, "rem": rem}}
