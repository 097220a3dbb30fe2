"""Per-device cost of a step from the ops it runs, the counterpart of the
JAX package's ``roofline/hlo_cost.py``.

Eager PyTorch has no HLO: every op runs, and loops come unrolled, so there
are no trip counts to recover.  :class:`OpCost` is a dispatch mode that
sees each op a device runs.  A DTensor op it hands back to DTensor
(``NotImplemented``), which then dispatches the local ops on the device's
shards, and the functional collectives that move them; those it counts:

  * FLOPs: products by ``torch.utils.flop_counter``'s registry, 1 an
    element for elementwise math and an element of the operand for a
    reduction (the reference's rule), and the hand-written kernels' work as
    ``roofline/kernel_work.py`` gives it (their stand-ins record it);
  * HBM bytes: operand + output bytes of each op (the reference's
    approximation), views free; a gather or a scatter charges the rows it
    moves, not the whole table it indexes;
  * collectives by type: the group's size, the ring volume of
    ``analysis.ring_volume``, and whether the group spans a mesh axis off
    NVLink; a pipeline's point-to-point hand-offs, which reach no dispatch
    mode, as collective-permutes (:func:`record_permute`);
  * memory: the bytes of the storages alive, argument storages included,
    and their peak.

The runs DTensor makes at global shapes to learn an op's output shape are
not counted: they are no device's work.
"""
from __future__ import annotations

import sys
import weakref
from collections import Counter

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..launch.mesh import NVLINK_AXES
from . import kernel_work
from .analysis import ModuleCost, ring_volume

_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}
_REDUCTIONS = {
    "sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp",
    "var_mean", "var", "std", "norm", "linalg_vector_norm", "argmax",
    "argmin", "cumsum", "cumprod", "_softmax", "_log_softmax",
    "_softmax_backward_data", "_log_softmax_backward_data", "sort", "topk",
}
# ops that read rows of their first operand by index: charged the rows
_GATHERS = {"index", "index_select", "gather", "embedding", "take"}
# ops that write rows of their first operand by index, in place or into a
# copy: charged the rows written
_SCATTERS = {"index_put", "index_put_", "_index_put_impl_", "scatter",
             "scatter_", "scatter_add", "scatter_add_", "index_copy",
             "index_copy_", "index_add", "index_add_", "masked_scatter_",
             "embedding_dense_backward"}
# products that reach the mode undecomposed (under inference mode, DTensor
# dispatches them whole): 2 a multiply-add
def _matmul_flops(args, outs) -> int:
    return 2 * outs[0].numel() * args[0].shape[-1]


def _einsum_flops(args, outs) -> int:
    """2 x the product of every index's size: the multiply-adds of the
    contraction as written."""
    eq, operands = args[0].replace(" ", ""), args[1]
    sizes = {}
    for term, t in zip(eq.split("->")[0].split(","), operands):
        sizes.update(zip(term, t.shape))
    n = 2
    for v in sizes.values():
        n *= v
    return n


_PRODUCTS = {"matmul": _matmul_flops, "einsum": _einsum_flops}
_SHARDING_PROP = "_sharding_prop.py"
# DTensor's all-to-all of a shard to another dim; on a CPU mesh it runs as
# an all-gather and a concatenation
_ALLTOALL = "shard_dim_alltoall"


def _context() -> str | None:
    """"prop" where the op runs inside DTensor's sharding propagation (at
    global shapes, to learn the output's shape: no device's work),
    "alltoall" inside DTensor's all-to-all, else None."""
    f = sys._getframe(3)
    for _ in range(24):
        if f is None:
            return None
        if f.f_code.co_filename.endswith(_SHARDING_PROP):
            return "prop"
        if f.f_code.co_name == _ALLTOALL:
            return "alltoall"
        f = f.f_back
    return None


def tensors(tree) -> list:
    """The tensors of ``tree`` (nested lists, tuples and dicts)."""
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)

    walk(tree)
    return out


def nbytes(t) -> int:
    return t.numel() * t.element_size()


_ACTIVE: list = []  # the OpCost modes entered, innermost last


def record_permute(n_bytes: int) -> None:
    """A point-to-point send of ``n_bytes`` (a pipeline hand-off, which
    reaches no dispatch mode) into the innermost :class:`OpCost` entered,
    as the reference's collective-permute; nothing outside one."""
    if _ACTIVE:
        _ACTIVE[-1].add_permute(n_bytes)


def _group_of(mesh) -> dict:
    """{process group name: (size, mesh axis)} of every mesh dim."""
    if mesh is None:
        return {}
    return {mesh.get_group(i).group_name: (mesh.size(i), name)
            for i, name in enumerate(mesh.mesh_dim_names)}


class OpCost(TorchDispatchMode):
    """Counts the local ops run inside it, per device (rank 0 of the
    mesh): ``cost`` (a :class:`ModuleCost`), ``flops_by_op`` and
    ``bytes_by_op`` by op name, and the live and peak bytes of the storages
    made inside it plus those ``track``-ed."""

    def __init__(self, mesh=None):
        super().__init__()
        self.cost = ModuleCost()
        self.flops_by_op: Counter = Counter()
        self.bytes_by_op: Counter = Counter()
        self.groups = _group_of(mesh)
        self.live = 0
        self.peak = 0
        self._storages = weakref.WeakKeyDictionary()

    # ------------------------------------------------------------ memory --
    def track(self, tensors) -> int:
        """Counts the storages of ``tensors`` alive from now until they
        die; returns the bytes newly counted."""
        added = 0
        for t in tensors:
            st = t.untyped_storage()
            if st in self._storages:
                continue
            n = st.nbytes()
            self._storages[st] = n
            weakref.finalize(st, self._free, n)
            added += n
        self.live += added
        self.peak = max(self.peak, self.live)
        return added

    def _free(self, n: int) -> None:
        self.live -= n

    # ------------------------------------------------------------- work --
    def add_kernel(self, kernel: str, key, n_ops: int, n_bytes: int) -> None:
        """The sink of ``kernel_work.recording``: a stand-in's work."""
        self.cost.flops += n_ops
        self.cost.bytes += n_bytes
        self.flops_by_op[kernel] += n_ops
        self.bytes_by_op[kernel] += n_bytes

    def add_permute(self, n_bytes: int) -> None:
        """A hand-off to the next or the previous stage: its bytes sent,
        across the network (the stage axis spans nodes)."""
        op = "collective-permute"
        self.cost.coll_bytes[op] += ring_volume(op, n_bytes, 2)
        self.cost.coll_counts[op] += 1
        self.cost.net_coll_bytes += n_bytes
        self.cost.bytes += n_bytes
        self.bytes_by_op[op] += n_bytes

    def _collective(self, name: str, args, out, alltoall: bool = False
                    ) -> None:
        op = _COLLECTIVES[name]
        group = args[-1]
        gname = group if isinstance(group, str) else group.group_name
        if gname in self.groups:
            n, axis = self.groups[gname]
        else:
            from torch.distributed.distributed_c10d import (
                _resolve_process_group)
            n, axis = _resolve_process_group(gname).size(), None
        out_bytes = nbytes(out)
        if alltoall:  # counted as the all-to-all it stands for
            op, out_bytes = "all-to-all", nbytes(args[0])
        vol = ring_volume(op, out_bytes, n)
        self.cost.coll_bytes[op] += vol
        self.cost.coll_counts[op] += 1
        if axis not in NVLINK_AXES:
            self.cost.net_coll_bytes += vol
        self.cost.bytes += out_bytes
        self.bytes_by_op[op] += out_bytes

    def _count(self, func, args, kwargs, out, where=None) -> None:
        name = func._schema.name.split("::")[-1]
        if func.namespace == "_c10d_functional":
            if name in _COLLECTIVES:
                self._collective(name, args, out, where == "alltoall")
            return
        if where == "alltoall":  # the fallback's concatenation: the
            self.track(tensors(out))  # all-to-all wrote its output
            return
        if func.namespace == "prim" or func.is_view:
            return
        ins = tensors((args, kwargs))
        outs = tensors(out)
        in_ids = {id(t.untyped_storage()) for t in ins}
        if outs and not func._schema.is_mutable and all(
                id(t.untyped_storage()) in in_ids for t in outs):
            return  # a view by another name (_unsafe_view, alias, ...)
        flops = 0
        packet = func._overloadpacket
        if packet in flop_registry:
            flops = flop_registry[packet](*args, **kwargs, out_val=out)
        elif name in _PRODUCTS:
            flops = _PRODUCTS[name](args, outs)
        elif torch.Tag.pointwise in func.tags:
            flops = sum(t.numel() for t in outs)
        elif name in _REDUCTIONS and ins:
            flops = ins[0].numel()
        if name.startswith(("empty", "new_empty")):
            moved = 0  # an allocation
        elif name in _GATHERS:
            moved = 2 * sum(map(nbytes, outs)) + sum(map(nbytes, ins[1:]))
        elif name in _SCATTERS:
            # the rows written: read and written once; the target's other
            # rows stay where they are (in place) or are copied (not)
            rows = sum(map(nbytes, ins[1:]))
            moved = 2 * rows if name.endswith("_") else rows + sum(
                map(nbytes, outs))
        else:
            moved = sum(map(nbytes, ins)) + sum(
                nbytes(t) for t in outs
                if id(t.untyped_storage()) not in in_ids)
        self.cost.flops += flops
        self.cost.bytes += moved
        self.flops_by_op[name] += flops
        self.bytes_by_op[name] += moved
        if outs:
            self.track(outs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        where = _context()
        if where != "prop":
            self._count(func, args, kwargs, out, where)
        return out

    def __enter__(self):
        self._rec = kernel_work.recording(self.add_kernel)
        self._rec.__enter__()
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _ACTIVE.remove(self)
            self._rec.__exit__(*exc)
