"""Config system: every architecture is a `ModelConfig` selectable via --arch.

A model is an embedding + a repeated *pattern* of block kinds + head.  Kinds:

  attn        global causal self-attention (GQA) + MLP
  local_attn  sliding-window causal self-attention + MLP
  xattn       cross-attention to a modality memory (no self-attn) + MLP
  dec_block   decoder block: self-attn + cross-attn + MLP (enc-dec decoders)
  moe         mixture-of-experts FFN block (attention + MoE)
  moe_dense   MoE + parallel dense residual FFN (arctic)
  rglru       RG-LRU recurrent block (Griffin/RecurrentGemma)
  ssd         Mamba-2 state-space-duality block (attention-free)

`n_layers` layers follow `pattern` cyclically.  This is a copy of the JAX
package's config module: the port walks the layers one by one, so the
scan-related `q_chunk` is carried but unused; `remat` checkpoints each full
pattern repetition in train mode, as the JAX package's scan body.
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | vlm | hybrid | audio | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None  # default d_model // n_heads
    pattern: tuple[str, ...] = ("attn",)

    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_softcap: float | None = None
    final_softcap: float | None = None
    window: int | None = None  # local-attention window
    rope_theta: float = 10_000.0
    mlp_variant: str = "swiglu"  # swiglu | geglu | gelu

    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25

    # SSM / recurrent
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    rnn_width: int | None = None
    conv_width: int = 4

    # encoder-decoder (audio): encoder is `enc_layers` of non-causal attn;
    # decoder is `n_layers` of `pattern` (dec_block).
    enc_layers: int = 0

    # modality frontend stub: inputs carry precomputed embeddings of this length
    memory_len: int = 0  # cross-attention memory length (vision patches / audio frames)

    # numerics / training
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    param_dtype: str = "float32"  # optimizer master dtype
    compute_dtype: str = "bfloat16"
    optimizer: str = "adamw"  # adamw | adafactor
    remat: bool = True
    q_chunk: int = 512  # blocked-attention query chunk
    loss_chunk: int = 4096  # chunked cross-entropy block (tokens)
    embed_scale: bool = False  # gemma-style sqrt(d_model) embedding scale

    # planner applicability notes (DESIGN.md Sec. 3)
    sub_quadratic: bool = False  # eligible for long_500k decode

    # distribution strategy (launch/shardings.py):
    #   fsdp — batch over ALL mesh axes (4k tokens/chip at train_4k), weights
    #          ZeRO-3 sharded and gathered per layer (v5e-native for dense)
    #   2d   — batch over DP axes only + TP/EP on 'model' (MoE needs EP)
    sharding_strategy: str = "fsdp"

    def __post_init__(self):
        assert self.n_layers >= 1 and self.d_model % 2 == 0
        if self.n_heads:
            assert self.n_heads % max(1, self.n_kv_heads) == 0

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // max(1, self.n_heads)

    def layer_kinds(self) -> list[str]:
        return [self.pattern[i % len(self.pattern)] for i in range(self.n_layers)]

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests (one fwd/train step)."""
        small = dict(
            n_layers=min(self.n_layers, 2 * len(self.pattern)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=128,
            vocab_size=256,
            head_dim=16,
            n_experts=min(self.n_experts, 4),
            moe_d_ff=64 if self.n_experts else 0,
            moe_top_k=min(self.moe_top_k, 2),
            ssm_state=min(self.ssm_state, 16),
            ssm_head_dim=16,
            ssm_chunk=16,
            rnn_width=64 if self.rnn_width else None,
            window=min(self.window, 32) if self.window else None,
            enc_layers=min(self.enc_layers, 2),
            memory_len=min(self.memory_len, 8) if self.memory_len else 0,
            q_chunk=16,
            loss_chunk=128,
            name=self.name + "-smoke",
        )
        small.update(overrides)
        return replace(self, **small)


# shape suite (assignment): every LM arch is exercised on these
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")
SHAPES = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Assignment skip rules (recorded in DESIGN.md Sec. 3)."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k needs sub-quadratic attention; skipped for full-attention archs"
    return True, ""
