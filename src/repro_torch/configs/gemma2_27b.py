"""gemma2-27b [dense]: 46L d_model=4608 32H (GQA kv=16) d_ff=36864 vocab=256000;
local+global alternating attention, attention & final logit softcaps, GeGLU.
[arXiv:2408.00118]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_ff=36_864,
    vocab_size=256_000,
    head_dim=128,
    pattern=("local_attn", "attn"),
    attn_softcap=50.0,
    final_softcap=30.0,
    window=4096,
    mlp_variant="geglu",
    embed_scale=True,
    tie_embeddings=True,
    optimizer="adamw",
)
