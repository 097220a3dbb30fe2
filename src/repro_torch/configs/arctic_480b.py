"""arctic-480b [moe]: 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000,
MoE 128 experts top-2 + dense residual FFN.  [hf:Snowflake/snowflake-arctic-base]

bf16 params + Adafactor: 480B fp32 Adam state would not fit 256 x 16 GB HBM
(30 GB/chip); bf16 weights + factored second moments fit (~8 GB/chip).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab_size=32_000,
    head_dim=128,
    pattern=("moe_dense",),
    n_experts=128,
    moe_top_k=2,
    moe_d_ff=4864,
    param_dtype="bfloat16",
    sharding_strategy="2d",  # EP: experts on 'model'
    optimizer="adafactor",
)
