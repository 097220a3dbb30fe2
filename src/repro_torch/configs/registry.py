"""--arch registry: the 10 assigned architectures (+ the paper's own ResNet101
profile for the planner examples)."""
from __future__ import annotations

from . import (
    arctic_480b,
    gemma2_27b,
    llama_3_2_vision_90b,
    mamba2_370m,
    qwen2_1_5b,
    qwen3_14b,
    qwen3_moe_30b_a3b,
    recurrentgemma_9b,
    starcoder2_7b,
    whisper_small,
)
from .base import ModelConfig

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        qwen3_moe_30b_a3b,
        arctic_480b,
        llama_3_2_vision_90b,
        qwen2_1_5b,
        starcoder2_7b,
        gemma2_27b,
        qwen3_14b,
        recurrentgemma_9b,
        whisper_small,
        mamba2_370m,
    )
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def list_archs() -> list[str]:
    return list(ARCHS)
