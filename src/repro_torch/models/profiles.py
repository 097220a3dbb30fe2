"""Bridge between the model substrate and the paper's planner: every arch
becomes a `ModelProfile` (per-layer rho^FW/BW, delta^FW/BW, r^mem/disk) the
splitting/placement/chaining optimizer can cut — the analogue of the paper's
Table I.  A copy of the JAX package's module, importing the port's cost model.

FLOPs are analytic per *sample* (batch=1) at a given sequence length, matmuls
counted as 2*MACs; rho^BW = 2 * rho^FW (the paper's convention).  delta at every
cut is the residual-stream activation (S * d_model * 2 bytes bf16); the whisper
encoder->decoder cut additionally ships the encoder output (cross-attn memory).
r^mem covers parameters (param_dtype bytes) times `state_multiplier` (optimizer
states: 1 for inference, ~9 for fp32 AdamW over bf16 compute, ~2.1 adafactor).
"""
from __future__ import annotations


from ..configs.base import ModelConfig
from ..core.costmodel import LayerProfile, ModelProfile

BF16 = 2


def _param_bytes(cfg: ModelConfig) -> int:
    return 2 if cfg.param_dtype == "bfloat16" else 4


def state_multiplier(cfg: ModelConfig) -> float:
    """bytes of (params + grads + optimizer state) per param byte."""
    if cfg.optimizer == "adafactor":
        return 2.1  # w + g (+ tiny factored stats)
    # fp32 master + m + v + bf16 grads on fp32 params
    return 3.5


def _attn_flops(cfg: ModelConfig, S: int, S_kv: int | None = None,
                causal: bool = True, window: int | None = None) -> float:
    D, hd = cfg.d_model, cfg.resolved_head_dim
    Hq, Hkv = cfg.n_heads, max(1, cfg.n_kv_heads)
    S_kv = S_kv if S_kv is not None else S
    proj = 2 * S * D * (Hq * hd + 2 * Hkv * hd) + 2 * S * Hq * hd * D
    eff_kv = min(S_kv, window) if window else S_kv
    pair = S * eff_kv * (0.5 if (causal and S > 1 and not window) else 1.0)
    attn = 2 * 2 * pair * Hq * hd  # scores + values
    return proj + attn


def _mlp_flops(cfg: ModelConfig, S: int, d_ff: int | None = None) -> float:
    F = d_ff if d_ff is not None else cfg.d_ff
    n_mats = 3 if cfg.mlp_variant in ("swiglu", "geglu") else 2
    return 2 * n_mats * S * cfg.d_model * F


def _attn_params(cfg: ModelConfig) -> int:
    D, hd = cfg.d_model, cfg.resolved_head_dim
    Hq, Hkv = cfg.n_heads, max(1, cfg.n_kv_heads)
    return D * (Hq * hd + 2 * Hkv * hd) + Hq * hd * D


def _mlp_params(cfg: ModelConfig, d_ff: int | None = None) -> int:
    F = d_ff if d_ff is not None else cfg.d_ff
    n_mats = 3 if cfg.mlp_variant in ("swiglu", "geglu") else 2
    return n_mats * cfg.d_model * F


def _block_cost(cfg: ModelConfig, kind: str, S: int, mode: str,
                cache_len: int) -> tuple[float, int]:
    """(fw_flops per sample, params) of one block."""
    D = cfg.d_model
    S_kv = cache_len if mode == "decode" else None
    fl, pr = 0.0, 0
    if kind in ("attn", "local_attn", "moe", "moe_dense"):
        window = cfg.window if kind == "local_attn" else None
        fl += _attn_flops(cfg, S, S_kv, True, window)
        pr += _attn_params(cfg)
        if kind in ("moe", "moe_dense"):
            fl += 2 * S * D * cfg.n_experts  # router
            fl += cfg.moe_top_k * _mlp_flops(cfg, S, cfg.moe_d_ff)
            pr += D * cfg.n_experts + cfg.n_experts * 3 * D * cfg.moe_d_ff
            if kind == "moe_dense":
                fl += _mlp_flops(cfg, S)
                pr += _mlp_params(cfg)
        else:
            fl += _mlp_flops(cfg, S)
            pr += _mlp_params(cfg)
    elif kind == "xattn":
        M = cfg.memory_len
        fl += 2 * S * D * cfg.n_heads * cfg.resolved_head_dim * 2  # q, o proj
        fl += 2 * M * D * 2 * max(1, cfg.n_kv_heads) * cfg.resolved_head_dim
        fl += 2 * 2 * S * M * cfg.n_heads * cfg.resolved_head_dim
        fl += _mlp_flops(cfg, S)
        pr += _attn_params(cfg) + _mlp_params(cfg)
    elif kind == "dec_block":
        M = cfg.memory_len
        fl += _attn_flops(cfg, S, S_kv)
        fl += 2 * 2 * S * M * cfg.n_heads * cfg.resolved_head_dim
        fl += 2 * S * D * cfg.n_heads * cfg.resolved_head_dim * 2
        fl += _mlp_flops(cfg, S)
        pr += 2 * _attn_params(cfg) + _mlp_params(cfg)
    elif kind == "rglru":
        W = cfg.rnn_width or D
        fl += 2 * S * D * W * 2  # two input branches
        fl += 2 * S * W * W * 2  # input/recurrence gates
        fl += 2 * S * W * cfg.conv_width + 10 * S * W  # conv + scan
        fl += 2 * S * W * D  # out proj
        fl += _mlp_flops(cfg, S)
        pr += 2 * D * W + 2 * W * W + cfg.conv_width * W + W * D + _mlp_params(cfg)
    elif kind == "ssd":
        Di = cfg.ssm_expand * D
        N = cfg.ssm_state
        H = Di // cfg.ssm_head_dim
        Q = min(cfg.ssm_chunk, S)
        fl += 2 * S * D * (2 * Di + 2 * N + H)  # in proj
        fl += 2 * S * Q * N  # intra-chunk scores (head-shared)
        fl += 2 * 2 * S * Q * Di  # intra-chunk weighted values (+decay apply)
        fl += 2 * 2 * S * N * Di  # chunk states + inter-chunk outputs
        fl += 2 * S * Di * D  # out proj
        pr += D * (2 * Di + 2 * N + H) + cfg.conv_width * (Di + 2 * N) + Di * D + 3 * H + Di
    else:
        raise ValueError(kind)
    pr += 2 * D  # norms
    return fl, pr


def model_profile(cfg: ModelConfig, seq_len: int, mode: str = "train",
                  cache_len: int = 0, training_state: bool | None = None,
                  ) -> ModelProfile:
    """Planner view: L = 1 (embed) + n_layers (+ enc_layers) + 1 (head)."""
    pb = _param_bytes(cfg)
    mult = (state_multiplier(cfg)
            if (training_state if training_state is not None else mode == "train")
            else 1.0)
    D, V = cfg.d_model, cfg.vocab_size
    S = 1 if mode == "decode" else seq_len
    resid = S * D * BF16
    layers: list[LayerProfile] = []

    def add(name, fw, act_bytes, params):
        layers.append(LayerProfile(name, fw, 2.0 * fw, act_bytes, act_bytes,
                                   params * pb * mult, params * pb))

    add("embed", 2 * S * D, resid, V * D)
    if cfg.enc_layers:  # whisper encoder before the decoder chain
        M = cfg.memory_len
        for i in range(cfg.enc_layers):
            fl = _attn_flops(cfg, M, M, causal=False) + _mlp_flops(cfg, M)
            # every cut after an encoder layer ships the (B, M, D) memory plus
            # the raw decoder tokens' embeddings
            add(f"enc{i}", fl, M * D * BF16 + resid,
                _attn_params(cfg) + _mlp_params(cfg) + 2 * D)
    kinds = cfg.layer_kinds()
    for i, kind in enumerate(kinds):
        fl, pr = _block_cost(cfg, kind, S, mode, cache_len)
        act = resid
        if cfg.enc_layers:  # decoder cuts also ship the cross-attn memory
            act += cfg.memory_len * D * BF16
        elif any(k in ("xattn",) for k in kinds[i + 1:]):
            act += cfg.memory_len * D * BF16  # vision memory still needed ahead
        add(f"{kind}{i}", fl, act, pr)
    head_params = 0 if cfg.tie_embeddings else D * V
    add("head", 2 * S * D * V, 0.0, head_params + D)
    return ModelProfile(cfg.name, layers)


def total_params(cfg: ModelConfig) -> int:
    prof = model_profile(cfg, seq_len=1, mode="decode", training_state=False)
    return int(sum(l.mem_bytes for l in prof.layers) / _param_bytes(cfg))


def active_params(cfg: ModelConfig) -> int:
    """Active params per token (MoE top-k counting) — for MODEL_FLOPS=6*N*D."""
    n = total_params(cfg)
    if cfg.n_experts:
        per_expert = 3 * cfg.d_model * cfg.moe_d_ff
        n -= cfg.n_layers * (cfg.n_experts - cfg.moe_top_k) * per_expert
    return int(n)
