"""starcoder2-7b [dense]: 32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152;
GQA + RoPE, GELU MLP with bias.  [arXiv:2402.19173]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18_432,
    vocab_size=49_152,
    head_dim=128,
    pattern=("attn",),
    qkv_bias=True,
    mlp_variant="gelu",
    rope_theta=1_000_000.0,
    optimizer="adamw",
)
