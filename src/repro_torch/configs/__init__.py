from .base import (
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES,
    TRAIN_4K,
    ModelConfig,
    ShapeConfig,
    shape_applicable,
)
from .registry import ARCHS, get_config, list_archs

__all__ = [
    "ModelConfig", "ShapeConfig", "ARCHS", "get_config", "list_archs",
    "SHAPES", "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
    "shape_applicable",
]
