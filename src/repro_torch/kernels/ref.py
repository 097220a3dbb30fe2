"""The plain PyTorch versions of the port's kernels under the names of the
JAX package's ``kernels/ref.py``: each is the function that sits beside
its kernel's wrapper and that the wrapper computes on CPU tensors."""
from __future__ import annotations

from .flash_attention import reference_attention
from .minplus import minplus_reference as reference_minplus
from .moe_gmm import reference_expert_matmul
from .rglru import reference_rglru_scan
from .ssd import reference_ssd_intra_chunk

__all__ = ["reference_attention", "reference_expert_matmul",
           "reference_rglru_scan", "reference_minplus",
           "reference_ssd_intra_chunk"]
