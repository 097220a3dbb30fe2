"""mamba2-370m [ssm]: 48L d_model=1024, attention-free, d_ff=0, vocab=50280,
ssm_state=128 — SSD (state-space duality).  [arXiv:2405.21060]

Sub-quadratic: O(1)-in-context recurrent state — runs the long_500k decode shape.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50_280,
    pattern=("ssd",),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=256,
    tie_embeddings=True,
    sub_quadratic=True,
    optimizer="adamw",
)
