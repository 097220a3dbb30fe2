"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) d_ff=768 vocab=151936,
MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=768,
    vocab_size=151_936,
    head_dim=128,
    pattern=("moe",),
    qk_norm=True,
    rope_theta=1_000_000.0,
    n_experts=128,
    moe_top_k=8,
    moe_d_ff=768,
    sharding_strategy="2d",  # EP: experts on 'model'
    optimizer="adamw",
)
