"""recurrentgemma-9b [hybrid]: 38L d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000; RG-LRU + local attention, 2:1 pattern (Griffin).
[arXiv:2402.19427]

Sub-quadratic: RG-LRU state is O(1) in context; the local-attention cache is a
2048-token ring buffer — eligible for the long_500k decode shape.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12_288,
    vocab_size=256_000,
    head_dim=256,
    pattern=("rglru", "rglru", "local_attn"),
    window=2048,
    rnn_width=4096,
    conv_width=4,
    mlp_variant="geglu",
    embed_scale=True,
    tie_embeddings=True,
    sub_quadratic=True,
    optimizer="adamw",
)
