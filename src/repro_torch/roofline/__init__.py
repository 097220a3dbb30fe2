"""Roofline of the dry run: per-device counts of a step's local ops
(``op_cost``), the hand-written kernels' work (``kernel_work``) and the
terms on H100 clusters (``analysis``)."""
from .analysis import DTYPE_BYTES, ModuleCost, Roofline, ring_volume

__all__ = ["DTYPE_BYTES", "ModuleCost", "Roofline", "ring_volume"]
