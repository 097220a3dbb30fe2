"""Carry the JAX package's model parameters over to the port.

The JAX parameter pytree, with its leaves as numpy arrays, becomes the
port's dict of tensors: the same names, and the stack unstacked.  The JAX
stack keeps each pattern slot's parameters stacked over the pattern's full
repetitions (``groups[i]`` holds slot ``i`` of every repetition, leading
axis = repetition) plus an unrolled remainder (``rem``); the port keeps one
dict per layer in layer order, so layer ``r * len(pattern) + i`` is
repetition ``r`` of slot ``i``.
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
