"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version: ``minplus`` (the tropical product, and the planner's fused DFTS
scan ``minplus.minplus_scan``),
``flash_attention`` (GQA attention of the attention family), ``ssd``
(Mamba-2's intra-chunk terms), ``moe_gmm`` (the per-expert matmul of the
MoE FFN) and ``rglru`` (the RG-LRU linear recurrence); ``ops`` exports their
entry points and ``ops.ssd_forward`` composes the SSD kernel with the
inter-chunk recurrence, ``ref`` holds the plain versions under the JAX
package's names, and ``build`` compiles and loads the kernels.

As in the JAX package, the package's ``flash_attention`` is the wrapper:
reach the module itself with
``importlib.import_module("repro_torch.kernels.flash_attention")``.
Nothing here touches CUDA at import."""
from . import ops, ref
from .flash_attention import flash_attention
from .minplus import minplus_matmul
from .moe_gmm import expert_matmul
from .rglru import rglru_scan
from .ssd import ssd_intra_chunk

__all__ = ["ops", "ref", "flash_attention", "expert_matmul", "minplus_matmul",
           "rglru_scan", "ssd_intra_chunk"]
