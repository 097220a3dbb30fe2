"""llama-3.2-vision-90b [vlm]: 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256; cross-attn image layers every 5th layer (20 of 100).
[hf:meta-llama/Llama-3.2-11B-Vision scaled per assignment]

The vision frontend is a STUB per the assignment: `input_specs()` provides
precomputed patch embeddings (memory_len x d_model); `xattn` layers attend to
them.  Adafactor keeps 90B optimizer state within 16 GB/chip.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28_672,
    vocab_size=128_256,
    head_dim=128,
    pattern=("attn", "attn", "attn", "attn", "xattn"),
    rope_theta=500_000.0,
    memory_len=4096,  # precomputed vision patch embeddings (stub frontend)
    param_dtype="bfloat16",
    optimizer="adafactor",
)
