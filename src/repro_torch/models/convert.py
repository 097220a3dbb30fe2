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
laid out the same way; its ``pos`` leaves are int32 there and int64 here,
an MoE layer's cache is the KV ring of ``attn`` in both, and a
``dec_block``'s cache nests ``{"self", "cross"}`` in both.  An
encoder (``params["encoder"]``, one ``attn`` slot stacked over
``cfg.enc_layers``) crosses as the decoder's stack does, and a cache's
``enc_memory`` as it is.

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
from .transformer import ENC_PATTERN, tree_paths


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


def _named_map(fn, tree, name=None):
    """``fn(key, leaf)`` over nested dicts, ``key`` the leaf's own name."""
    if isinstance(tree, dict):
        return {k: _named_map(fn, v, k) for k, v in tree.items()}
    return fn(name, tree)


def _stacks(cfg: ModelConfig) -> dict:
    """Each stack of the model: its name in the tree -> (pattern, layers)."""
    out = {"stack": (cfg.pattern, cfg.n_layers)}
    if cfg.enc_layers:
        out["encoder"] = (ENC_PATTERN, cfg.enc_layers)
    return out


def _unstack(stack, pattern, n_layers: int, leaf) -> list:
    """The layers of a JAX stack (``groups`` stacked over the pattern's full
    repetitions, then ``rem``) in layer order, each leaf through
    ``leaf(name, array)``; a restored checkpoint has no ``rem`` where it
    held no leaf."""
    plen = len(pattern)
    layers = [_named_map(lambda k, a: leaf(k, _row(a, r)), stack["groups"][i])
              for r in range(n_layers // plen) for i in range(plen)]
    layers += [_named_map(leaf, rem) for rem in stack.get("rem", [])]
    if len(layers) != n_layers:
        raise ValueError(f"{len(layers)} layers in the tree, {n_layers} in "
                         f"the config")
    return layers


def params_from_jax(tree, cfg: ModelConfig, device) -> dict:
    """The port's parameters from a JAX parameter pytree (numpy leaves)."""
    def stack(name):
        pattern, n = _stacks(cfg)[name]
        return {"layers": _unstack(tree[name], pattern, n,
                                   lambda _, a: _tensor(a, device))}

    # the keys in ``transformer.init_params``'s order
    out = {"embed": _tensor(tree["embed"], device),
           "final_norm": _tensor(tree["final_norm"], device),
           "stack": stack("stack")}
    if "head" in tree:
        out["head"] = _tensor(tree["head"], device)
    if cfg.enc_layers:
        out["encoder"] = stack("encoder")
        out["enc_norm"] = _tensor(tree["enc_norm"], device)
    return out


def cache_from_jax(tree, cfg: ModelConfig, device) -> dict:
    """The port's serving cache from the JAX package's (numpy leaves): one
    block cache per layer, ``pos`` as int64, and ``enc_memory`` where the
    prefill kept one."""
    if not set(tree) <= {"stack", "enc_memory"}:
        raise ValueError(f"cache entries {sorted(set(tree))}: a serving "
                         f"cache holds the stack's and the encoded memory")

    def leaf(name, a):
        t = _tensor(a, device)
        return t.long() if name == "pos" else t

    out = {"stack": {"layers": _unstack(tree["stack"], cfg.pattern,
                                        cfg.n_layers, leaf)}}
    if "enc_memory" in tree:
        out["enc_memory"] = _tensor(tree["enc_memory"], device)
    return out


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

    def stacked(ts, name=None):
        if isinstance(ts[0], dict):
            return {k: stacked([t[k] for t in ts], k) for k in ts[0]}
        return np.stack([leaf(name, t) for t in ts])

    plen = len(cfg.pattern)
    full = cfg.n_layers // plen * plen
    groups = [stacked(layers[i:full:plen]) for i in range(plen)] \
        if full else []
    rem = [_named_map(leaf, c) for c in layers[full:]]
    out = {"stack": {"groups": groups, "rem": rem}}
    if "enc_memory" in cache:
        out["enc_memory"] = leaf("enc_memory", cache["enc_memory"])
    return out


# ------------------------------------------------- the port's, to the JAX --
def _jax_path(path: tuple, cfg: ModelConfig) -> tuple:
    """The key path in the JAX layout of the port's parameter leaf at
    ``path``: layer ``j`` of a stack (the decoder's or the encoder's) is
    repetition ``j // len(pattern)`` of ``groups[j % len(pattern)]`` while
    the repetitions are whole, then ``rem[j - full]``."""
    stacks = _stacks(cfg)
    if path[0] not in stacks or path[1:2] != ("layers",):
        return path
    pattern, n_layers = stacks[path[0]]
    plen = len(pattern)
    full = n_layers // plen * plen
    j = path[2]
    if j < full:
        return (path[0], "groups", j % plen) + path[3:]
    return (path[0], "rem", j - full) + path[3:]


def _assemble(items, cfg: ModelConfig) -> dict:
    """Nested dicts and lists from (key path, value) pairs, with the JAX
    stack's ``groups`` (None per pattern slot without a full repetition,
    as ``init_stack`` leaves them) and ``rem``."""
    root: dict = {name: {"groups": [] if n >= len(pattern)
                         else [None] * len(pattern), "rem": []}
                  for name, (pattern, n) in _stacks(cfg).items()}
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
    for name, (_, n) in _stacks(cfg).items():
        if len(params[name]["layers"]) != n:
            raise ValueError(f"{len(params[name]['layers'])} layers of "
                             f"parameters in {name}, {n} in the config")
    by: dict = {}
    for path, t in tree_paths(params):
        by.setdefault(_jax_path(path, cfg), []).append(t.detach())
    return _assemble([(jp, (torch.stack(ts) if jp[1:2] == ("groups",)
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
