"""PyTorch building blocks of the two model families the port runs so far:
attention (GQA with rope, QKV bias, qk-norm, softcap, sliding window) with
an MLP, and the Mamba-2 SSD block.

Conventions, those of the JAX package's ``models/layers.py``:
  * parameters are plain dicts of tensors, stored in ``cfg.param_dtype`` and
    cast to ``cfg.compute_dtype`` at use;
  * activations x: (B, S, D); positions: (B, S) int;
  * every block returns ``(y, new_cache)``; the port runs without a cache
    (training and prefill from nothing), so ``new_cache`` is None.

Attention runs through the flash-attention kernel and the SSD scan through
the SSD kernel (``repro_torch.kernels``); both take their plain versions on
the CPU.  Caches, decode, cross-attention, MoE and RG-LRU are not ported yet
and raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.flash_attention import flash_attention
from ..kernels.ops import ssd_forward

Params = dict

# ROADMAP items of what is not ported yet, named by the errors that say so.
CACHE_ITEM = "ROADMAP A, next 4: the serving engine (caches and decode)"
CROSS_ITEM = ("ROADMAP A, later 9: the encoder-decoder and vision families "
              "(cross-attention)")


@dataclasses.dataclass
class Ctx:
    """Per-call context threaded through blocks."""

    mode: str  # "train" | "prefill" ("decode" is not ported yet)
    positions: torch.Tensor  # (B, S) absolute positions
    causal: bool = True


def cdt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def pdt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _dense_init(gen: torch.Generator, shape, dtype, scale=None):
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(shape, generator=gen, device=gen.device) * scale
    return x.to(dtype)


def _zeros(gen: torch.Generator, shape, dtype):
    return torch.zeros(shape, dtype=dtype, device=gen.device)


def rmsnorm(x, scale, eps):
    """Scales by ``1 + scale`` (the JAX package's convention)."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rope(x, positions, theta):
    """x: (B, S, H, hd); positions: (B, S).  Rotates the two halves of the
    head (not interleaved pairs), as the JAX package does."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = torch.exp(-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device)
                      * (math.log(theta) / half))
    angles = positions[..., None].float() * freqs  # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x, cap):
    return cap * torch.tanh(x / cap) if cap else x


def gelu_tanh(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


# =============================================================== attention ====
def init_attention(gen: torch.Generator, cfg: ModelConfig) -> Params:
    D, hd = cfg.d_model, cfg.resolved_head_dim
    Hq, Hkv = cfg.n_heads, max(1, cfg.n_kv_heads)
    dt = pdt(cfg)
    p = {
        "wq": _dense_init(gen, (D, Hq * hd), dt),
        "wk": _dense_init(gen, (D, Hkv * hd), dt),
        "wv": _dense_init(gen, (D, Hkv * hd), dt),
        "wo": _dense_init(gen, (Hq * hd, D), dt),
    }
    if cfg.qkv_bias:
        p["bq"] = _zeros(gen, (Hq * hd,), dt)
        p["bk"] = _zeros(gen, (Hkv * hd,), dt)
        p["bv"] = _zeros(gen, (Hkv * hd,), dt)
    if cfg.qk_norm:
        p["q_norm"] = _zeros(gen, (hd,), dt)
        p["k_norm"] = _zeros(gen, (hd,), dt)
    return p


def _project_qkv(p, cfg: ModelConfig, xq, xkv, q_positions, kv_positions,
                 apply_rope: bool = True):
    hd = cfg.resolved_head_dim
    Hq, Hkv = cfg.n_heads, max(1, cfg.n_kv_heads)
    dt = cdt(cfg)

    def proj(x, w, b_name, H):
        y = x @ p[w].to(dt)
        if b_name in p:
            y = y + p[b_name].to(dt)
        return y.reshape(x.shape[0], x.shape[1], H, hd)

    q = proj(xq, "wq", "bq", Hq)
    k = proj(xkv, "wk", "bk", Hkv)
    v = proj(xkv, "wv", "bv", Hkv)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    if apply_rope:
        q = rope(q, q_positions, cfg.rope_theta)
        k = rope(k, kv_positions, cfg.rope_theta)
    return q, k, v


def attention_block(p, cfg: ModelConfig, x, ctx: Ctx, cache, window=None,
                    cross=False):
    """Self-attention sublayer without a cache (no residual or norm: the
    caller wraps it).  The kernel masks by index (query i sees key j <= i),
    which is the JAX package's mask by position for positions 0..S-1, the
    positions of a call without a cache."""
    if cross:
        raise NotImplementedError(f"cross-attention is not ported yet: "
                                  f"{CROSS_ITEM}")
    if cache is not None:
        raise NotImplementedError(f"attention with a KV cache is not ported "
                                  f"yet: {CACHE_ITEM}")
    q, k, v = _project_qkv(p, cfg, x, x, ctx.positions, ctx.positions)
    out = flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                          causal=ctx.causal, window=window,
                          softcap=cfg.attn_softcap)
    B, S = x.shape[:2]
    out = out.reshape(B, S, -1) @ p["wo"].to(cdt(cfg))
    return out, None


# ====================================================================== MLP ====
def init_mlp(gen: torch.Generator, cfg: ModelConfig, d_ff=None) -> Params:
    D = cfg.d_model
    F_ = d_ff or cfg.d_ff
    dt = pdt(cfg)
    if cfg.mlp_variant in ("swiglu", "geglu"):
        return {
            "w_gate": _dense_init(gen, (D, F_), dt),
            "w_up": _dense_init(gen, (D, F_), dt),
            "w_down": _dense_init(gen, (F_, D), dt),
        }
    return {  # plain gelu MLP (starcoder2 / whisper)
        "w_up": _dense_init(gen, (D, F_), dt),
        "b_up": _zeros(gen, (F_,), dt),
        "w_down": _dense_init(gen, (F_, D), dt),
        "b_down": _zeros(gen, (D,), dt),
    }


def mlp(p, cfg: ModelConfig, x):
    dt = cdt(cfg)
    if cfg.mlp_variant in ("swiglu", "geglu"):
        act = F.silu if cfg.mlp_variant == "swiglu" else gelu_tanh
        h = act(x @ p["w_gate"].to(dt)) * (x @ p["w_up"].to(dt))
        return h @ p["w_down"].to(dt)
    h = gelu_tanh(x @ p["w_up"].to(dt) + p["b_up"].to(dt))
    return h @ p["w_down"].to(dt) + p["b_down"].to(dt)


def _causal_depthwise_conv(x, w, state=None):
    """x: (B, S, W) causal depthwise conv, kernel (cw, W).

    state: (B, cw-1, W) trailing inputs from the previous call (decode).
    Returns (y, new_state)."""
    cw = w.shape[0]
    hist = state if state is not None else torch.zeros(
        (x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([hist, x], dim=1)
    y = sum(xp[:, i : i + x.shape[1]] * w[i][None, None, :] for i in range(cw))
    return y, xp[:, -(cw - 1):]


# ================================================================ Mamba-2 SSD ==
def init_ssd(gen: torch.Generator, cfg: ModelConfig) -> Params:
    D = cfg.d_model
    Di = cfg.ssm_expand * D
    H = Di // cfg.ssm_head_dim
    N = cfg.ssm_state
    dt = pdt(cfg)
    conv_dim = Di + 2 * N
    dev = gen.device
    return {
        # projects to [z (Di), x (Di), B (N), C (N), dt (H)]
        "w_in": _dense_init(gen, (D, 2 * Di + 2 * N + H), dt),
        "conv_w": _dense_init(gen, (cfg.conv_width, conv_dim), dt, scale=0.3),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=dev)),
        "D_skip": torch.ones((H,), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=dev),
        "norm": _zeros(gen, (Di,), dt),
        "w_out": _dense_init(gen, (Di, D), dt),
    }


def ssd_block(p, cfg: ModelConfig, x, ctx: Ctx, cache):
    if cache is not None:
        raise NotImplementedError(f"the SSD block with a state cache is not "
                                  f"ported yet: {CACHE_ITEM}")
    dt_ = cdt(cfg)
    B, S, D = x.shape
    Di = cfg.ssm_expand * D
    H = Di // cfg.ssm_head_dim
    P = cfg.ssm_head_dim
    N = cfg.ssm_state
    zxbcdt = x @ p["w_in"].to(dt_)
    z, xs, Bm, Cm, dtv = zxbcdt.split([Di, Di, N, N, H], dim=-1)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)
    conv_out, _ = _causal_depthwise_conv(conv_in, p["conv_w"].to(dt_))
    conv_out = F.silu(conv_out)
    xs, Bm, Cm = conv_out.split([Di, N, N], dim=-1)
    xh = xs.reshape(B, S, H, P).float()
    dtv = F.softplus(dtv.float() + p["dt_bias"])  # (B, S, H)
    A = torch.exp(p["A_log"])  # (H,) positive rates
    y, _ = ssd_forward(xh, dtv, A, Bm.float(), Cm.float(), None,
                       cfg.ssm_chunk)
    y = y + p["D_skip"][None, None, :, None] * xh
    y = y.reshape(B, S, Di).to(dt_)
    y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["w_out"].to(dt_), None
