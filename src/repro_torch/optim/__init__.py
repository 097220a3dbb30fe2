"""Optimizers and gradient compression, as the JAX package's ``optim``."""
from .compress import (
    compress_with_feedback,
    dequantize_int8,
    init_error_feedback,
    quantize_int8,
    topk_densify,
    topk_sparsify,
)
from .optimizers import (
    Optimizer,
    adafactor,
    adamw,
    clip_by_global_norm,
    cosine_schedule,
    make_optimizer,
    stacked_groups,
)

__all__ = [
    "Optimizer", "adamw", "adafactor", "make_optimizer", "cosine_schedule",
    "clip_by_global_norm", "stacked_groups", "quantize_int8",
    "dequantize_int8", "compress_with_feedback", "init_error_feedback",
    "topk_sparsify", "topk_densify",
]
