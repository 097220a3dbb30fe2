"""Logical-axis sharding rules and activation constraints, the JAX
package's ``models/sharding.py`` over ``DeviceMesh`` and DTensor.

Logical axes:
  batch   -> data-parallel mesh axes (('pod','data') multi-pod, ('data',) single)
  fsdp    -> weight / optimizer-state sharding axes (ZeRO-3)
  tp      -> tensor-parallel axis ('model')
  seq     -> sequence-parallel axis of the residual stream between blocks
  expert  -> expert-parallel axis of the MoE weights and activations

A resolved spec is a tuple with one entry per tensor dim: None, a mesh axis,
or a tuple of mesh axes, as a ``PartitionSpec`` holds them.  It becomes
DTensor placements by :func:`placements`: a tensor dim sharded over two
mesh axes is one ``Shard(d)`` on each of them.

``constrain(x, logical)`` returns ``x`` itself unless a :class:`MeshRules`
context is active and ``x`` is a DTensor, so the model code runs unchanged
on one device.  Dims that do not divide evenly by their mesh axes fall back
to replication.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass

import torch


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (or of anything with
    ``mesh_dim_names`` and a ``shape`` tuple)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


@dataclass(frozen=True)
class MeshRules:
    mesh: object
    batch: tuple[str, ...] = ("data",)
    fsdp: tuple[str, ...] = ("data",)
    tp: tuple[str, ...] = ("model",)
    seq: tuple[str, ...] = ("model",)
    expert: tuple[str, ...] = ("model",)

    def axes_size(self, axes: tuple[str, ...]) -> int:
        sizes = axis_sizes(self.mesh)
        return math.prod(sizes[a] for a in axes) if axes else 1

    def resolve(self, logical: tuple, shape: tuple[int, ...] | None = None
                ) -> tuple:
        """logical entries: None | 'batch' | 'fsdp' | 'tp' | 'seq' |
        'expert'.

        'batch' degrades to prefixes of its axes (batch 128 on a
        ('data','model') = 256-way group shards over ('data',) = 32)."""
        parts = []
        used: set[str] = set()
        for i, name in enumerate(logical):
            if name is None:
                parts.append(None)
                continue
            # a mesh axis may appear at most once per spec: under the fsdp
            # strategy 'batch' already consumes 'model', so tp / seq
            # constraints on the same tensor degrade to replication
            axes = tuple(a for a in getattr(self, name) if a not in used)
            if shape is not None:
                while axes and shape[i] % self.axes_size(axes) != 0:
                    axes = axes[:-1] if name == "batch" else ()
            if not axes:
                parts.append(None)
            else:
                used.update(axes)
                parts.append(axes if len(axes) > 1 else axes[0])
        return tuple(parts)

    def placements(self, logical: tuple, shape=None) -> list:
        return placements(self.resolve(logical, shape), self.mesh)


def placements(spec: tuple, mesh) -> list:
    """DTensor placements of a resolved spec on ``mesh``: ``Shard(d)`` on
    each mesh dim that shards tensor dim d, ``Replicate()`` on the rest."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in mesh.mesh_dim_names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for a in ((entry,) if isinstance(entry, str) else entry):
            out[mesh.mesh_dim_names.index(a)] = Shard(d)
    return out


_ACTIVE: contextvars.ContextVar[MeshRules | None] = contextvars.ContextVar(
    "mesh_rules", default=None)


@contextlib.contextmanager
def mesh_rules(rules: MeshRules | None):
    tok = _ACTIVE.set(rules)
    try:
        yield
    finally:
        _ACTIVE.reset(tok)


def active_rules() -> MeshRules | None:
    return _ACTIVE.get()


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _redistribute(x, rules: MeshRules, spec: tuple):
    """``x`` laid out as ``spec``, its gradient too (a sharding constraint
    holds for the cotangent, as the reference's does)."""
    want = placements(spec, rules.mesh)
    if list(x.placements) != want:
        x = x.redistribute(rules.mesh, want)
    if x.requires_grad and torch.is_grad_enabled():
        x = _GradLaidOut.apply(x, want)
    return x


class _GradLaidOut(torch.autograd.Function):
    """The identity, its gradient redistributed to ``want``."""

    @staticmethod
    def forward(ctx, x, want):
        ctx.want = want
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if list(g.placements) != ctx.want:
            g = g.redistribute(g.device_mesh, ctx.want)
        return g, None


def constrain(x, logical: tuple):
    """``x`` laid out as ``logical`` resolves on its shape under the active
    rules; ``x`` itself without rules or when it is no DTensor."""
    rules = _ACTIVE.get()
    if rules is None or not is_dtensor(x):
        return x
    return _redistribute(x, rules, rules.resolve(logical, tuple(x.shape)))


def constrain_grad(x, logical: tuple):
    """``x`` itself, its gradient laid out as ``logical`` resolves (under
    the active rules, on a DTensor that requires grad)."""
    rules = _ACTIVE.get()
    if rules is None or not is_dtensor(x) or not (
            x.requires_grad and torch.is_grad_enabled()):
        return x
    return _GradLaidOut.apply(x, placements(
        rules.resolve(logical, tuple(x.shape)), rules.mesh))


def constrain_first(x, candidates: list[tuple]):
    """The first candidate spec whose sharded dims ALL divide evenly
    (whole-spec fallback: a per-dim fallback would replicate silently, as
    40 heads over 16 TP ranks replicated the O(S^2) attention scores in
    the reference)."""
    rules = _ACTIVE.get()
    if rules is None or not is_dtensor(x):
        return x
    for logical in candidates:
        if all(name is None
               or x.shape[i] % rules.axes_size(getattr(rules, name)) == 0
               for i, name in enumerate(logical)):
            return _redistribute(x, rules,
                                 rules.resolve(logical, tuple(x.shape)))
    return x


# ------------------------------------------------------------ parameter rules
# base logical spec per leaf name, applied to the trailing dims (leading
# dims get None)
_PARAM_RULES: dict[str, tuple] = {
    "embed": ("tp", "fsdp"),
    "head": ("fsdp", "tp"),
    "wq": ("fsdp", "tp"), "wk": ("fsdp", "tp"), "wv": ("fsdp", "tp"),
    "wo": ("tp", "fsdp"),
    "bq": ("tp",), "bk": ("tp",), "bv": ("tp",),
    "q_norm": (None,), "k_norm": (None,), "xgate": (),
    "router": ("fsdp", None),
    "b_up": ("tp",), "b_down": (None,),
    "w_x": ("fsdp", "tp"), "w_gate_branch": ("fsdp", "tp"),
    "conv_w": (None, None),
    "w_input_gate": ("tp", None), "w_rec_gate": ("tp", None),
    "lam": (None,), "w_out": ("tp", "fsdp"),
    "w_in": ("fsdp", "tp"),
    "A_log": (None,), "D_skip": (None,), "dt_bias": (None,), "norm": (None,),
    "ln1": (None,), "ln2": (None,), "ln3": (None,), "final_norm": (None,),
}


def _leaf_logical(name: str, ndim: int, is_moe: bool) -> tuple:
    if name in ("w_gate", "w_up"):
        base = ("expert", "fsdp", None) if is_moe else ("fsdp", "tp")
    elif name == "w_down":
        base = ("expert", None, "fsdp") if is_moe else ("tp", "fsdp")
    elif name in _PARAM_RULES:
        base = _PARAM_RULES[name]
    else:
        base = ()
    pad = ndim - len(base)
    return (None,) * max(0, pad) + tuple(base[-ndim:] if ndim < len(base)
                                         else base)


def param_logical(path: tuple, ndim: int) -> tuple:
    """The logical spec of the leaf at ``path`` (keys and layer indices,
    as ``transformer.tree_paths`` gives them) of ``ndim`` dims."""
    names = [str(e) for e in path]
    name = next((n for n in reversed(names) if n and not n.isdigit()), "")
    return _leaf_logical(name, ndim, "moe" in names)


def param_logical_tree(params):
    """The tree of logical specs mirroring ``params`` (one per layer's
    leaf, ``stack.layers.i.attn.wq``; any tensors, fake ones too)."""

    def walk(tree, prefix):
        if isinstance(tree, dict):
            return {k: walk(v, prefix + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, prefix + (i,)) for i, v in enumerate(tree)]
        return param_logical(prefix, len(tree.shape))

    return walk(params, ())


def param_specs(params, rules: MeshRules):
    """The resolved spec of every leaf of ``params``."""
    from .transformer import tree_map

    logical = param_logical_tree(params)
    it = iter(_leaves(logical))
    return tree_map(lambda leaf: rules.resolve(next(it), tuple(leaf.shape)),
                    params)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def make_rules(mesh, strategy: str = "fsdp") -> MeshRules:
    """Rules for the meshes ('data','model') / ('pod','data','model').

    fsdp (dense archs): activations batch-sharded over every axis, weights
    ZeRO-3 sharded over the DP axes and gathered per layer; 'pod' adds
    another ZeRO / DP dimension.

    2d (MoE archs): batch over the DP axes only; TP and EP on 'model'
    (experts stay sharded); sequence parallelism keeps the residual small.
    """
    multi = "pod" in mesh.mesh_dim_names
    if strategy == "fsdp":
        if multi:
            # batch drops axes from the right: global batch 256 on 512
            # cards shards over ('pod','data') = 64
            return MeshRules(mesh, batch=("pod", "data", "model"),
                             fsdp=("pod", "data"), tp=("model",),
                             seq=("model",))
        return MeshRules(mesh, batch=("data", "model"), fsdp=("data",),
                         tp=("model",), seq=("model",))
    if multi:
        return MeshRules(mesh, batch=("pod", "data"), fsdp=("data",))
    return MeshRules(mesh, batch=("data",), fsdp=("data",))


# ------------------------------------------------------- local kernel calls
def sharded(*xs) -> bool:
    """Rules are active and one of ``xs`` is a DTensor: the call sites then
    run their kernels on each device's shards (:func:`local_call`)."""
    return _ACTIVE.get() is not None and any(is_dtensor(x) for x in xs)


def kept(x, dims) -> list:
    """``x``'s placements with a shard kept only on tensor ``dims`` (the
    dims a kernel can split its work over); any other shard, and a partial
    sum, replicated."""
    from torch.distributed.tensor import Replicate, Shard

    return [p if isinstance(p, Shard) and p.dim % x.ndim in dims
            else Replicate() for p in x.placements]


def like(placements_, mapping: dict) -> list:
    """Placements that shard tensor dim ``mapping[d]`` wherever
    ``placements_`` shard dim d (dims not in ``mapping`` replicated)."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(mapping[p.dim]) if isinstance(p, Shard)
            and p.dim in mapping else Replicate() for p in placements_]


def split_of(placements_, dim: int, mesh) -> tuple[int, int]:
    """(ranks, this rank's index) over which ``placements_`` split tensor
    ``dim`` on ``mesh``."""
    from torch.distributed.tensor import Shard

    n, idx = 1, 0
    coord = mesh.get_coordinate() or [0] * mesh.ndim
    for i, p in enumerate(placements_):
        if isinstance(p, Shard) and p.dim == dim:
            idx = idx * mesh.size(i) + coord[i]
            n *= mesh.size(i)
    return n, idx


def local_call(fn, args: tuple, in_placements: tuple, out_placements):
    """``fn`` on each device's shards of ``args`` (``local_map``): every
    DTensor argument redistributed to its ``in_placements`` entry (None
    for an argument that is no tensor), the outputs laid out by
    ``out_placements``.  For the ops DTensor has no rule for, and the
    kernels, which take plain tensors."""
    from torch.distributed.tensor.experimental import local_map

    return local_map(fn, out_placements=out_placements,
                     in_placements=in_placements,
                     device_mesh=_ACTIVE.get().mesh,
                     redistribute_inputs=True)(*args)


def positions(rows, S: int):
    """(B, S) positions 0 .. S-1 of every row of ``rows`` (a (B, ...)
    tensor), on its device; under mesh rules on a DTensor laid out as
    ``rows``' dim 0 is, each device making only its rows."""
    B = rows.shape[0]
    if not sharded(rows):
        return torch.arange(S, device=rows.device).expand(B, S)
    from torch.distributed.tensor import DTensor

    pl = like(rows.placements, {0: 0})
    local = rows.to_local()
    pos = torch.arange(S, device=local.device).expand(local.shape[0], S)
    return DTensor.from_local(pos, rows.device_mesh, pl, run_check=False,
                              shape=torch.Size((B, S)), stride=(0, 1))


def lookup(table, tokens):
    """``table[tokens]`` (an embedding); under mesh rules on DTensors the
    vocab-parallel lookup: each device looks its rows' tokens up in its
    vocab shard of the table (its other dims gathered), the rows of other
    shards 0, a partial sum over the vocab's ranks."""
    if not sharded(table, tokens):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = _ACTIVE.get().mesh
    tp = [Shard(0) if p.is_shard(0) else Replicate()
          for p in table.placements]
    _, v_idx = split_of(tp, 0, mesh)
    kp = [Replicate() if t.is_shard() else p
          for t, p in zip(tp, like(tokens.placements, {0: 0, 1: 1}))]
    out = [Partial() if t.is_shard() else p for t, p in zip(tp, kp)]

    def local(tab, tok):
        t = tok - v_idx * tab.shape[0]
        mine = (t >= 0) & (t < tab.shape[0])
        return tab[torch.where(mine, t, 0)] * mine[..., None]

    return local_call(local, (table, tokens), (tp, kp), out)


def laid_out_as(x, ref):
    """``x`` redistributed to ``ref``'s placements (a gradient to its
    parameter's: a partial sum reduced once); ``x`` itself where either is
    no DTensor or they agree."""
    if not (is_dtensor(x) and is_dtensor(ref)) or \
            list(x.placements) == list(ref.placements):
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


def splittable(x, dim: int, outer: int):
    """``x`` whose ``dim`` can be split into (``outer``, rest): where ranks
    shard ``dim`` in a count that does not divide ``outer``, that dim is
    gathered first (DTensor refuses such a split)."""
    if not sharded(x):
        return x
    from torch.distributed.tensor import Replicate

    d = dim % x.ndim
    n, _ = split_of(x.placements, d, x.device_mesh)
    if outer % n == 0:
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_shard(d) else p for p in x.placements])
