"""whisper-small [audio]: enc-dec 12L d_model=768 12H (kv=12) d_ff=3072
vocab=51865; conv audio frontend is a STUB (input_specs() provides precomputed
frame embeddings of length memory_len).  [arXiv:2212.04356]

Decoder: 12 `dec_block` layers (self-attn + cross-attn to the encoder output).
Encoder: 12 non-causal attn layers over the frame embeddings.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51_865,
    head_dim=64,
    pattern=("dec_block",),
    enc_layers=12,
    memory_len=1500,  # precomputed conv-frontend frame embeddings (stub)
    qkv_bias=True,
    mlp_variant="gelu",
    optimizer="adamw",
)
