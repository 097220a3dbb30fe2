"""Sharding assembly of the dry run: parameter, optimizer-state, batch and
cache specs from the logical rules of ``models/sharding.py``, and fake
DTensors laid out by them (:func:`to_structs`), the JAX package's
``launch/shardings.py``.  A spec is a resolved ``PartitionSpec``-like tuple
(``MeshRules.resolve``); nothing here allocates.
"""
from __future__ import annotations

from ..models.sharding import MeshRules, param_specs, placements


def replicated(rules: MeshRules) -> tuple:
    """The spec of a replicated value (any rank)."""
    del rules
    return ()


def batch_sharding(rules: MeshRules, ndim: int, global_batch: int) -> tuple:
    """dim 0 (batch) over the DP axes, dropping axes from the right where
    the batch does not divide the whole DP group (decode's 128 over 256
    cards)."""
    return rules.resolve(("batch",) + (None,) * (ndim - 1),
                         (global_batch,) + (1,) * (ndim - 1))


def _pad(spec, nd: int) -> tuple:
    spec = list(spec)[-nd:] if nd else []
    return tuple([None] * (nd - len(spec)) + spec)


def opt_state_shardings(opt_state, params, rules: MeshRules) -> dict:
    """The specs of the port's optimizer state (``optim.optimizers``):
    AdamW's ``m`` and ``v`` mirror the parameters' specs leaf for leaf;
    Adafactor's entries are one per group of ``stacked_groups``, stacked
    over a leading (unsharded) dim where the group is a stack, ``vr`` the
    parameter's spec without its last dim, ``vc`` without its second to
    last, ``v`` the parameter's.  The step count and the groups are no
    tensors."""
    from ..models.transformer import tree_leaves

    pspecs = param_specs(params, rules)
    out = {}
    for key, sub in opt_state.items():
        if key in ("m", "v"):
            out[key] = pspecs
        elif key == "f":
            leaf_specs = tree_leaves(pspecs)
            res = []
            for (idx, stacked), entry in zip(opt_state["groups"], sub):
                spec = list(leaf_specs[idx[0]])
                if stacked:
                    spec = [None] + spec
                one = {}
                for name, leaf in entry.items():
                    nd = len(leaf.shape)
                    if name == "vr":  # the parameter's shape less its last dim
                        one[name] = _pad(spec[:-1], nd)
                    elif name == "vc":  # less its second to last
                        one[name] = _pad(spec[:-2] + spec[-1:], nd)
                    else:  # "v": the parameter's
                        one[name] = _pad(spec, nd)
                res.append(one)
            out[key] = res
    return out


def cache_shardings(cache, rules: MeshRules, global_batch: int):
    """Per-leaf cache specs: the first dim equal to the global batch over
    the DP axes (dropping axes from the right: an unsharded 32k KV cache is
    100+ GB a card on the 100-layer archs); the last dim at least the TP
    size (and not taken by the batch) over TP."""
    from ..models.transformer import tree_map

    def leaf(s):
        logical = [None] * len(s.shape)
        for i, d in enumerate(s.shape):
            if d == global_batch and global_batch > 1:
                logical[i] = "batch"
                break
        for i in range(len(s.shape) - 1, -1, -1):
            if logical[i] is None and s.shape[i] >= rules.axes_size(rules.tp):
                logical[i] = "tp"
                break
        return rules.resolve(tuple(logical), tuple(s.shape))

    return tree_map(leaf, cache)


def to_structs(tree, specs, mesh):
    """Fake DTensors of ``tree``'s (fake, global) tensors laid out by
    ``specs`` on ``mesh``; a leaf that is no tensor is kept.  Run inside
    the ``FakeTensorMode`` that made ``tree``."""
    import torch
    from torch.distributed.tensor import distribute_tensor

    def walk(t, s):
        if s is None:  # no spec: no tensor (a step count, the groups)
            return t
        if isinstance(t, dict):
            return {k: walk(v, s.get(k)) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v, sv) for v, sv in zip(t, s)]
        if not isinstance(t, torch.Tensor):
            return t
        d = distribute_tensor(t.detach(), mesh, placements(s, mesh))
        return d.requires_grad_(t.requires_grad)

    return walk(tree, specs)
