"""qwen2-1.5b [dense]: 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936;
GQA with QKV bias, tied embeddings.  [arXiv:2407.10671]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151_936,
    head_dim=128,
    pattern=("attn",),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    optimizer="adamw",
)
