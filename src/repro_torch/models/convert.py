"""Carry the JAX package's model parameters, optimizer state and serving
caches over to the port, and the port's back.

The JAX parameter pytree, with its leaves as numpy arrays, becomes the
port's dict of tensors: the same names, and the stack unstacked.  The JAX
stack keeps each pattern slot's parameters stacked over the pattern's full
repetitions (``groups[i]`` holds slot ``i`` of every repetition, leading
axis = repetition) plus an unrolled remainder (``rem``); the port keeps one
dict per layer in layer order, so layer ``r * len(pattern) + i`` is
repetition ``r`` of slot ``i``.  A serving cache (``{"stack": {"groups",
"rem"}}`` in the JAX package, ``{"stack": {"layers"}}`` in the port) is
laid out the same way; its ``pos`` leaves are int32 there and int64 here.

The optimizer states cross likewise: AdamW's ``m`` and ``v`` mirror the
parameters in either layout; Adafactor's ``f`` mirrors the JAX parameter
tree (a ``{"vr", "vc"}`` or ``{"v"}`` entry per stacked leaf) where the
port keeps one entry per group of ``optim.stacked_groups``, in the same
stacked layout; ``step`` is a 0-d int32 there and an int here.  The port's
``groups`` entry is rebuilt from the config and never crosses.  The JAX
layout the port writes (``params_to_jax_layout``, ``opt_state_to_jax_layout``)
is what ``repro_torch.ckpt`` saves: CPU tensors of the leaves' own dtypes.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from .transformer import tree_map, tree_paths


def _tensor(a, device) -> torch.Tensor:
    """A leaf of a JAX-layout tree (numpy, or a tensor restored from a
    checkpoint) as a tensor of its own on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device, copy=True)
    a = np.array(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16, which torch cannot read
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _row(a, r):
    """Repetition ``r`` of a stacked leaf."""
    return a[r] if isinstance(a, torch.Tensor) else np.asarray(a)[r]


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
            layers.append(tree_map(lambda a: _tensor(_row(a, r), device),
                               stack["groups"][i]))
    # a restored checkpoint has no "rem" where it held no leaf
    for rem in stack.get("rem", []):
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


# ------------------------------------------------- the port's, to the JAX --
def _jax_path(path: tuple, cfg: ModelConfig) -> tuple:
    """The key path in the JAX layout of the port's parameter leaf at
    ``path``: layer ``j`` of the stack is repetition ``j // len(pattern)``
    of ``groups[j % len(pattern)]`` while the repetitions are whole, then
    ``rem[j - full]``."""
    if path[:2] != ("stack", "layers"):
        return path
    plen = len(cfg.pattern)
    full = cfg.n_layers // plen * plen
    j = path[2]
    if j < full:
        return ("stack", "groups", j % plen) + path[3:]
    return ("stack", "rem", j - full) + path[3:]


def _assemble(items, cfg: ModelConfig) -> dict:
    """Nested dicts and lists from (key path, value) pairs, with the JAX
    stack's ``groups`` (None per pattern slot without a full repetition,
    as ``init_stack`` leaves them) and ``rem``."""
    plen = len(cfg.pattern)
    root: dict = {"stack": {"groups": [] if cfg.n_layers >= plen
                            else [None] * plen, "rem": []}}
    for path, value in items:
        cur = root
        for key, nxt in zip(path[:-1], path[1:]):
            if isinstance(cur, list):
                while len(cur) <= key:
                    cur.append(None)
                if cur[key] is None:
                    cur[key] = [] if isinstance(nxt, int) else {}
            elif key not in cur:
                cur[key] = [] if isinstance(nxt, int) else {}
            cur = cur[key]
        if isinstance(cur, list):
            while len(cur) <= path[-1]:
                cur.append(None)
        cur[path[-1]] = value
    return root


def params_to_jax_layout(params, cfg: ModelConfig) -> dict:
    """The inverse of :func:`params_from_jax`: the JAX parameter tree, each
    pattern slot's leaves stacked over the full repetitions (``groups``)
    and the remainder layers unrolled (``rem``), its leaves detached CPU
    tensors of the parameters' own dtypes (a leaf that is not stacked and
    already lives on the CPU is the parameter itself)."""
    if len(params["stack"]["layers"]) != cfg.n_layers:
        raise ValueError(f"{len(params['stack']['layers'])} layers of "
                         f"parameters, {cfg.n_layers} in the config")
    by: dict = {}
    for path, t in tree_paths(params):
        by.setdefault(_jax_path(path, cfg), []).append(t.detach())
    return _assemble([(jp, (torch.stack(ts) if jp[:2] == ("stack", "groups")
                            else ts[0]).cpu()) for jp, ts in by.items()],
                     cfg)


def _get(tree, path: tuple):
    for key in path:
        tree = tree[key]
    return tree


def opt_state_to_jax_layout(state, params, cfg: ModelConfig) -> dict:
    """The JAX package's optimizer state from the port's, for the
    parameters ``params`` laid out by ``cfg``: AdamW's ``{"m", "v",
    "step"}`` or Adafactor's ``{"f", "step"}``, ``step`` a 0-d int32."""
    step = torch.tensor(state["step"], dtype=torch.int32)
    if "m" in state:
        return {"m": params_to_jax_layout(state["m"], cfg),
                "v": params_to_jax_layout(state["v"], cfg), "step": step}
    paths = [p for p, _ in tree_paths(params)]
    f = [(_jax_path(paths[idx[0]], cfg),
          {k: v.detach().cpu() for k, v in entry.items()})
         for (idx, _), entry in zip(state["groups"], state["f"])]
    return {"f": _assemble(f, cfg), "step": step}


def opt_state_from_jax(tree, params, cfg: ModelConfig, device) -> dict:
    """The port's optimizer state for ``params`` (laid out by ``cfg``) from
    the JAX package's: the inverse of :func:`opt_state_to_jax_layout`, with
    the port's ``groups`` rebuilt by ``optim.stacked_groups``."""
    from ..optim import stacked_groups  # optim imports models

    groups = stacked_groups(params, cfg)
    step = int(tree["step"])
    if "m" in tree:
        return {"m": params_from_jax(tree["m"], cfg, device),
                "v": params_from_jax(tree["v"], cfg, device), "step": step,
                "groups": groups}
    paths = [p for p, _ in tree_paths(params)]
    f = [{k: _tensor(v, device)
          for k, v in _get(tree["f"], _jax_path(paths[idx[0]], cfg)).items()}
         for idx, _ in groups]
    return {"f": f, "step": step, "groups": groups}
