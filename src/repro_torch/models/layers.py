"""PyTorch building blocks of the model families the port runs: attention
(GQA with rope, QKV bias, qk-norm, softcap, sliding window) with an MLP, the
capacity-routed MoE FFN, the Griffin RG-LRU block and the Mamba-2 SSD block,
with the per-family caches of serving.

Conventions, those of the JAX package's ``models/layers.py``:
  * parameters are plain dicts of tensors, stored in ``cfg.param_dtype`` and
    cast to ``cfg.compute_dtype`` at use (the MoE router and the RG-LRU's
    ``lam`` stay float32);
  * activations x: (B, S, D); positions: (B, S) int;
  * every block returns ``(y, new_cache)``, ``new_cache`` None where the
    block was called without a cache (training, or a forward from nothing).

Attention runs through the flash-attention kernel, the MoE FFN's expert
products through the expert-matmul kernel, the RG-LRU recurrence through
the RG-LRU kernel and the SSD scan through the SSD kernel
(``repro_torch.kernels``); each takes its plain version on the CPU.  A
prefill goes through the same kernels; a decode step is plain PyTorch, as
the JAX package's is plain ``jnp``, except cross-attention, which attends
over the whole memory through the flash kernel in every mode, as the JAX
package runs its ``blocked_attention`` there.  The caches: a KV ring buffer
of ``attn`` and ``local_attn``, written in place; the cross K/V of
``xattn`` and ``dec_block``, projected from the memory once at prefill; the
RG-LRU's and SSD's float32 state with the conv's trailing inputs, replaced
at every call.  An MoE block's attention half takes the KV ring of
``attn``; its FFN routes the call's own tokens, so a decode step of B
sequences routes B tokens as one group, with the capacity taken over them
(``max(1, int(B * k / E * capacity_factor))``), as the JAX package's does.

Under mesh rules (``models/sharding.py``) on DTensors, the dry run's
parameters and activations, the reference's constraint sites lay the
activations out and each kernel runs on a device's shards
(``sharding.local_call``); without rules the sites are no-ops.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels.flash_attention import flash_attention
from ..kernels.moe_gmm import expert_matmul
from ..kernels.ops import ssd_forward
from ..kernels.rglru import rglru_scan
from . import sharding as SH

Params = dict

# Constraint sites of the attention core (q, k, v and o are (B, S, H, hd)):
# heads over TP, else (q and o) the query positions, as the JAX package's
# blocked attention constrains them (``layers.py:33-39`` there; the flash
# kernel keeps no scores, so their spec has no site here); without active
# rules, and on tensors that are no DTensors, they are no-ops.
_KV_SPECS = [("batch", None, "tp", None), ("batch", None, None, None)]
_Q_SPECS = [("batch", None, "tp", None), ("batch", "tp", None, None)]

@dataclasses.dataclass
class Ctx:
    """Per-call context threaded through blocks."""

    mode: str  # "train" | "prefill" | "decode"
    positions: torch.Tensor  # (B, S) absolute positions
    memory: torch.Tensor | None = None  # (B, M, D) modality / encoder memory
    cache_len: int = 0  # allocated cache length (decode)
    causal: bool = True

    @property
    def decoding(self) -> bool:
        return self.mode == "decode"


def cdt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def pdt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _dense_init(gen: torch.Generator, shape, dtype, scale=None):
    """A float32 normal draw scaled in place (one float32 copy beside the
    result: arctic-480b's experts are 17.8 GB a weight in float32), then
    cast to ``dtype``."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(shape, generator=gen, device=gen.device)
    return x.mul_(scale).to(dtype)


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
def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   cross: bool = False) -> Params:
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
    if cross:
        p["xgate"] = _zeros(gen, (), dt)  # llama-vision gated cross-attention
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
        return SH.splittable(y, -1, H).reshape(x.shape[0], x.shape[1], H, hd)

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


def _decode_attention(cfg: ModelConfig, q, k, v, q_positions, kv_positions,
                      window=None):
    """One new token against the whole cache, ``layers.py:238-258`` of the
    JAX package: q (B, 1, Hq, hd), k and v (B, L, Hkv, hd).  Grouped (Hkv,
    G): the KV heads are read once, not repeated G times.  Scores in
    float32, masked by the stored positions (``pos`` -1 is an unwritten
    slot), so the slots' order does not matter once the ring wraps."""
    B, _, Hq, hd = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    qi = q.float().reshape(B, 1, Hkv, G, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qi, k.float()) / math.sqrt(hd)
    if cfg.attn_softcap:
        s = softcap(s, cfg.attn_softcap)
    q_pos = q_positions[:, :1]
    mask = (kv_positions >= 0) & (kv_positions <= q_pos)
    if window is not None:
        mask = mask & (q_pos - kv_positions < window)
    s = torch.where(mask[:, None, None, None, :], s, -1e30)
    w = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", w, v).reshape(B, 1, Hq, hd)


def init_kv_cache(cfg: ModelConfig, batch: int, length: int, *,
                  device) -> dict:
    """An empty KV ring buffer of ``length`` slots: k and v (B, L, Hkv, hd)
    in the compute type, ``pos`` (B, L) int64, -1 where no token is
    written."""
    hd, Hkv = cfg.resolved_head_dim, max(1, cfg.n_kv_heads)
    dtype = cdt(cfg)
    return {
        "k": torch.zeros((batch, length, Hkv, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, length, Hkv, hd), dtype=dtype, device=device),
        "pos": torch.full((batch, length), -1, dtype=torch.int64,
                          device=device),
    }


def _cache_write(cache, k_new, v_new, positions) -> dict:
    """Writes the new K/V in place at the ring slots ``position % length``
    and returns the cache.  A call writes at most ``length`` tokens of
    consecutive positions, so no slot is written twice.  Under mesh rules
    on a DTensor cache each device writes its own shards
    (:func:`_sharded_cache_write`)."""
    if SH.sharded(cache["k"]):
        return _sharded_cache_write(cache, k_new, v_new, positions)
    length = cache["k"].shape[1]
    if positions.shape[1] > length:
        raise ValueError(f"{positions.shape[1]} tokens written into a ring "
                         f"of {length} slots")
    slots = positions % length  # (B, S)
    bidx = torch.arange(k_new.shape[0], device=k_new.device)[:, None]
    cache["k"][bidx, slots] = k_new.to(cache["k"].dtype)
    cache["v"][bidx, slots] = v_new.to(cache["v"].dtype)
    cache["pos"][bidx, slots] = positions.to(cache["pos"].dtype)
    return cache


def _sharded_cache_write(cache, k_new, v_new, positions) -> dict:
    """Each device writes its rows of the new K/V (laid out as its cache's
    shards) and positions into its shards of the cache, in place."""
    kp = list(cache["k"].placements)
    pp = list(cache["pos"].placements)

    def local(k, v, pos, kn, vn, ps):
        c = _cache_write({"k": k, "v": v, "pos": pos}, kn, vn, ps)
        return c["k"], c["v"], c["pos"]

    k, v, pos = SH.local_call(
        local, (cache["k"], cache["v"], cache["pos"], k_new, v_new,
                positions),
        (kp, kp, pp, kp, kp, SH.like(kp, {0: 0})), (kp, kp, pp))
    return dict(cache, k=k, v=v, pos=pos)


def _cross_kv(p, cfg: ModelConfig, mem):
    """The cross-attention keys and values of the memory (B, M, D): its
    projections with their biases and the keys' qk-norm, no rope, in the
    compute type (``layers.py:302-311`` of the JAX package)."""
    dt = cdt(cfg)
    hd, Hkv = cfg.resolved_head_dim, max(1, cfg.n_kv_heads)
    k = SH.splittable(mem @ p["wk"].to(dt), -1, Hkv).reshape(
        mem.shape[0], -1, Hkv, hd)
    v = SH.splittable(mem @ p["wv"].to(dt), -1, Hkv).reshape(
        mem.shape[0], -1, Hkv, hd)
    if "bk" in p:
        k = k + SH.splittable(p["bk"].to(dt), -1, Hkv).reshape(Hkv, hd)
        v = v + SH.splittable(p["bv"].to(dt), -1, Hkv).reshape(Hkv, hd)
    if cfg.qk_norm:
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return k.to(dt), v.to(dt)


def _cross_attention(p, cfg: ModelConfig, x, ctx: Ctx, cache):
    """Cross-attention of x over the memory, ``layers.py:285-313`` of the
    JAX package: every query sees every memory position (the flash kernel,
    non-causal, Sq != Skv).  The keys and values come from ``ctx.memory``
    without a cache and in a prefill, which stores them in the cache; a
    decode step reuses the cached ones and never reads the memory."""
    dt = cdt(cfg)
    hd, Hq = cfg.resolved_head_dim, cfg.n_heads
    q = x @ p["wq"].to(dt)
    if "bq" in p:
        q = q + p["bq"].to(dt)
    q = SH.splittable(q, -1, Hq).reshape(x.shape[0], x.shape[1], Hq, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
    if cache is not None and ctx.decoding:
        k, v = cache["k"], cache["v"]
    else:
        if ctx.memory is None:
            raise ValueError("cross-attention needs the memory (ctx.memory) "
                             "outside a decode step")
        k, v = _cross_kv(p, cfg, ctx.memory)
        if cache is not None:
            cache = {"k": k, "v": v}
    out = _attend(cfg, q, k, v, causal=False)
    return out, cache


def _attend(cfg: ModelConfig, q, k, v, *, causal: bool, window=None):
    """The flash kernel over q (B, Sq, Hq, hd) and k, v (B, Skv, Hkv, hd).
    Under mesh rules on DTensors, q, k and v are constrained as the
    reference's attention is (heads over TP, else q's positions) and the
    kernel runs on each device's shards (:func:`_sharded_attention`)."""
    kw = dict(causal=causal, window=window, softcap=cfg.attn_softcap)
    if SH.sharded(q, k, v):
        return _sharded_attention(q, k, v, kw)
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           **kw)


def _q_specs(Hq: int, Hkv: int) -> list:
    """q's candidate specs: heads over TP only where each device's heads
    read whole kv heads (its share of heads divides the group, or the
    group divides it), else the query positions."""
    rules = SH.active_rules()
    tp = rules.axes_size(rules.tp)
    G = Hq // Hkv
    h = Hq // tp if Hq % tp == 0 else 0
    return _Q_SPECS if h and (G % h == 0 or h % G == 0) else _Q_SPECS[1:]


def _sharded_attention(q, k, v, kw):
    """The flash kernel on each device's shards: q and the output split
    over batch rows, heads or query positions, k and v over batch rows and
    (where they divide) heads.  A device whose q heads read fewer kv heads
    than it holds takes just those; one holding a slice of the queries
    counts its share of the causal pairs (``kernel_work.query_split``)."""
    from torch.distributed.tensor import Replicate, Shard

    from ..roofline import kernel_work

    mesh = SH.active_rules().mesh
    Hq, Hkv = q.shape[2], k.shape[2]
    q = SH.constrain_first(q, _q_specs(Hq, Hkv))
    k = SH.constrain_first(k, _KV_SPECS)
    v = SH.constrain_first(v, _KV_SPECS)
    qp = SH.kept(q, (0, 1, 2))
    n_heads, head_idx = SH.split_of(qp, 2, mesh)
    n_rows, _ = SH.split_of(qp, 1, mesh)
    kv_heads = Hkv % n_heads == 0
    kvp = [Shard(0) if p.is_shard(0) else Shard(2)
           if p.is_shard(2) and kv_heads else Replicate() for p in qp]

    def local(ql, kl, vl):
        hq, hkv = ql.shape[2], kl.shape[2]
        if hq * Hkv != hkv * Hq:  # q's heads sharded, k's and v's not
            G = Hq // Hkv
            lo = head_idx * hq // G
            hi = -(-(head_idx + 1) * hq // G)
            kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
        with kernel_work.query_split(n_rows):
            return flash_attention(ql.contiguous(), kl.contiguous(),
                                   vl.contiguous(), **kw)

    return SH.local_call(local, (q, k, v), (qp, kvp, kvp), qp)


def _merge_heads(out):
    """(B, S, H, hd) -> (B, S, H * hd); under mesh rules on a DTensor on
    each device's shards of rows and heads (a merged head-major dim keeps
    the heads' split), the query positions gathered first: the output
    projection flattens (B, S), which DTensor cannot do over two split
    dims."""
    if not SH.sharded(out):
        return out.reshape(out.shape[0], out.shape[1], -1)
    pl = SH.kept(out, (0, 2))
    return SH.local_call(lambda o: o.reshape(o.shape[0], o.shape[1], -1),
                         (out,), (pl,), pl)


def attention_block(p, cfg: ModelConfig, x, ctx: Ctx, cache, window=None,
                    cross=False):
    """Self- or cross-attention sublayer (no residual or norm: the caller
    wraps it), ``layers.py:285-340`` of the JAX package.

    Self-attention without a cache, and in a prefill, runs the flash kernel
    over the call's own K/V.  It masks by index (query i sees key j <= i),
    which is the JAX package's mask by position for the consecutive
    positions of such a call.  A prefill then writes the last ``min(L, S)``
    tokens into the ring of L slots; a decode step writes its token and
    attends over the whole cache (:func:`_decode_attention`).
    Cross-attention is :func:`_cross_attention`, its output scaled by
    ``tanh(xgate)`` where the block has the gate."""
    if cross:
        out, cache = _cross_attention(p, cfg, x, ctx, cache)
    else:
        q, k, v = _project_qkv(p, cfg, x, x, ctx.positions, ctx.positions)
        if cache is not None and ctx.decoding:
            cache = _cache_write(cache, k, v, ctx.positions)
            out = _decode_attention(cfg, q, cache["k"], cache["v"],
                                    ctx.positions, cache["pos"], window)
        else:
            causal = True if cache is not None else ctx.causal
            out = _attend(cfg, q, k, v, causal=causal, window=window)
            if cache is not None:
                tail = min(cache["k"].shape[1], k.shape[1])
                cache = _cache_write(cache, k[:, -tail:], v[:, -tail:],
                                     ctx.positions[:, -tail:])
    out = _merge_heads(SH.constrain_first(out, _Q_SPECS))
    out = out @ p["wo"].to(cdt(cfg))
    if cross and "xgate" in p:
        out = torch.tanh(p["xgate"].float()).to(out.dtype) * out
    return out, cache


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


# ====================================================================== MoE ====
def init_moe(gen: torch.Generator, cfg: ModelConfig) -> Params:
    D, F_, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    dt = pdt(cfg)
    return {
        "router": _dense_init(gen, (D, E), torch.float32),  # router in fp32
        "w_gate": _dense_init(gen, (E, D, F_), dt),
        "w_up": _dense_init(gen, (E, D, F_), dt),
        "w_down": _dense_init(gen, (E, F_, D), dt),
    }


MOE_GROUP = 1024  # tokens per dispatch group (as in the JAX package)


class Routing(NamedTuple):
    """One MoE layer's routing of G groups of g tokens to their top-k
    experts, slot j being the j-th most probable expert."""

    logits: torch.Tensor  # (G, g, E) float32 router logits
    probs: torch.Tensor   # (G, g, E) their softmax
    gates: torch.Tensor   # (G, g, k) top-k probabilities, renormalised
    idx: torch.Tensor     # (G, g, k) the experts, int64
    pos: torch.Tensor     # (G, g, k) place in the expert's buffer, int64
    keep: torch.Tensor    # (G, g, k) pos < capacity: the slot is not dropped
    capacity: int         # C, rows of each expert's buffer per group


def _router_logits(toks, router):
    """``toks @ router`` in full float32, also where the caller has switched
    TF32 on: a routing decision must not hang on TF32's 10-bit mantissa."""
    if toks.device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            return toks.float() @ router.float()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = True
    return toks.float() @ router.float()


def moe_route(router, cfg: ModelConfig, toks) -> Routing:
    """GShard top-k routing with capacity, ``layers.py:400-420`` of the JAX
    package step for step.  toks: (G, g, D)."""
    g = toks.shape[1]
    E, k = cfg.n_experts, cfg.moe_top_k
    C = max(1, int(g * k / E * cfg.capacity_factor))
    logits = _router_logits(toks, router)
    probs = torch.softmax(logits, dim=-1)
    # lax.top_k's order: descending probability, the lower index first on
    # ties (a stable sort; torch.topk leaves its tie order unspecified)
    idx = torch.sort(probs, dim=-1, descending=True, stable=True).indices
    return routing_of_picks(logits, probs, idx[..., :k], C)


def routing_of_picks(logits, probs, idx, capacity: int) -> Routing:
    """The routing that sends each token to the experts ``idx`` (G, g, k):
    their renormalised gates, places in the experts' buffers and capacity
    drops, as ``moe_route`` makes them from its own top-k."""
    E = logits.shape[-1]
    gates = torch.gather(probs, -1, idx)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    # position in the expert's buffer: the tokens before this one in the same
    # slot, after every earlier slot's tokens of that expert
    mask = F.one_hot(idx, E)  # (G, g, k, E)
    totals = mask.sum(dim=1, keepdim=True)
    pos = torch.cumsum(mask, dim=1) - mask + torch.cumsum(totals, dim=2) \
        - totals
    pos = torch.gather(pos, -1, idx[..., None])[..., 0]
    return Routing(logits, probs, gates, idx, pos, pos < capacity, capacity)


def moe_ffn(p, cfg: ModelConfig, x):
    """Capacity-routed top-k MoE FFN, ``layers.py:391-446`` of the JAX
    package; returns ``(out (B, S, D), aux)`` with the Switch load-balance
    loss ``aux``.

    The JAX package dispatches and combines with one-hot einsums, whose
    every (expert, buffer row) holds at most one token: here they are an
    index scatter and gather with the same values.  The groups are folded
    into the buffer axis, (E, G * C, D), so each expert product is one launch
    of the expert-matmul kernel that reads each expert's weights once.

    The call's own B * S tokens are routed, in groups of MOE_GROUP (one
    group where they are fewer), each expert taking C of a group's tokens;
    past MOE_GROUP they must be whole groups of it, where the JAX package's
    reshape fails and this raises ``ValueError``.

    Under mesh rules on DTensors it runs on each device's shards
    (:func:`_sharded_moe`): the reference's EP layout.
    """
    if SH.sharded(x, p["w_gate"]):
        return _sharded_moe(p, cfg, x)
    return _moe_local(cfg, x, p["router"], p["w_gate"], p["w_up"],
                      p["w_down"], 0)


def _sharded_moe(p, cfg: ModelConfig, x):
    """The MoE FFN on each device's shards, the JAX package's layout
    (``layers.py:427-439`` there): token groups on the DP axes as x's rows
    are, experts on the expert axes, the router whole.  Every device routes
    its rows' tokens to all E experts and computes its own experts' share;
    the output is a partial sum over the expert axes (their reduction is
    the all-to-all's return half), the aux loss an average over the rows'
    axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    rules = SH.active_rules()
    mesh = rules.mesh
    xp = SH.kept(x, (0,))
    expert_axes = set(rules.expert)
    wp = [Shard(0) if a in expert_axes and p_.is_replicate() else Replicate()
          for a, p_ in zip(mesh.mesh_dim_names, xp)]
    n_e, e_idx = SH.split_of(wp, 0, mesh)
    E_l = cfg.n_experts // n_e
    out_p = [Partial() if w.is_shard() else x_ for w, x_ in zip(wp, xp)]
    aux_p = [Partial("avg") if x_.is_shard() else Replicate() for x_ in xp]

    def local(xl, router, wg, wu, wd):
        return _moe_local(cfg, xl, router, wg, wu, wd, e_idx * E_l)

    rep = [Replicate()] * mesh.ndim
    dt = cdt(cfg)  # the weights gathered in the compute type
    return SH.local_call(local, (x, p["router"], p["w_gate"].to(dt),
                                 p["w_up"].to(dt), p["w_down"].to(dt)),
                         (xp, rep, wp, wp, wp), (out_p, aux_p))


def _moe_local(cfg: ModelConfig, x, router, w_gate, w_up, w_down, e_lo: int):
    """The MoE FFN of x's tokens over the experts ``e_lo`` onwards whose
    weights are given (all of them on one device): the routing over all E
    experts, each of these experts' products, and their share of the
    output (slots of the other experts weigh 0)."""
    B, S, D = x.shape
    E = cfg.n_experts
    E_l = w_gate.shape[0]
    T_ = B * S
    g = min(MOE_GROUP, T_)
    G = max(1, T_ // g)
    if G * g != T_:
        raise ValueError(f"B * S = {T_} tokens are not whole groups of "
                         f"MOE_GROUP = {MOE_GROUP} tokens")
    toks = x.reshape(G, g, D)
    r = moe_route(router, cfg, toks)
    C = r.capacity
    dt = cdt(cfg)
    dev = x.device
    group = torch.arange(G, device=dev)[:, None, None].expand_as(r.idx)
    token = torch.arange(g, device=dev)[None, :, None].expand_as(r.idx)
    row = group * C + torch.where(r.keep, r.pos, 0)
    idx, mine = r.idx, r.keep
    if E_l < E:  # another device computes the other experts' slots
        idx = r.idx - e_lo
        mine = r.keep & (idx >= 0) & (idx < E_l)
        idx = torch.where(mine, idx, 0)
    # dropped slots go to a spare expert E_l, which is never computed
    buf = torch.zeros((E_l + 1, G * C, D), dtype=dt, device=dev)
    buf[torch.where(mine, idx, E_l), row] = toks[group, token].to(dt)
    xe = buf[:E_l]
    act = "gelu" if cfg.mlp_variant == "gelu" else "silu"
    h = expert_matmul(xe, w_gate.to(dt), activation=act) \
        * expert_matmul(xe, w_up.to(dt))
    expert_out = expert_matmul(h, w_down.to(dt))  # (E_l, G * C, D)
    comb = (r.gates * mine).to(dt)  # (G, g, k), 0 where dropped
    picked = expert_out[idx, row]   # (G, g, k, D)
    out = (comb.float()[..., None] * picked.float()).sum(dim=2).to(dt)

    # load-balance aux loss (Switch): E * sum_e f_e * P_e
    f = F.one_hot(r.idx[..., 0], E).float().mean(dim=1)  # top-1 routing
    aux = E * (f * r.probs.mean(dim=1)).sum(-1).mean()
    return out.reshape(B, S, D), aux


class RouteAgreement(NamedTuple):
    """Two runs' routings of the same tokens, layer by layer (see
    :func:`routing_agreement`)."""

    picks: int           # (token, slot) picks compared, over every layer
    flips: int           # picks whose expert differs (a swap of two slots
    #                      of one token counts twice)
    diverged: int        # tokens whose kept experts differ at some layer
    worst_gap: float     # see routing_agreement
    agree: torch.Tensor  # (T,) bool: the same kept experts at every layer

    def flips_are_near_ties(self, tol: float) -> bool:
        """Every token that diverged did so at a near tie: an expert that
        one run picks and the other does not lay within ``tol`` of the
        largest |logit| of the reference's top-k cut."""
        return self.worst_gap <= tol


def routing_agreement(got, want) -> RouteAgreement:
    """Compares the routings of two runs of the same MoE layers on the same
    tokens (``got`` and ``want``, one ``(logits (..., E), idx (..., k),
    keep (..., k))`` per layer in order, ``want`` the reference), on the
    CPU.

    In bf16 the two runs round the residual stream differently, so a token
    whose k-th and (k+1)-th experts nearly tie may pick another expert; its
    output then differs by its gate times an expert's output, and through
    attention it perturbs the later tokens' inputs a little.  A token's
    output depends on the set of experts it keeps, not on their slot order,
    so tokens agree where that set is the same at every layer; they are the
    ones to compare by value.  At the first layer where a token's set
    differs, each expert that only one run picked is measured by its
    distance, in the reference's logits, from the reference's top-k cut
    (halfway between its k-th and (k+1)-th logits): ``worst_gap`` is the
    largest such distance over the tokens, relative to the largest |logit|
    of the layer (0 where only a capacity drop differs).  Where the router's
    inputs differ by rounding only, it is small."""
    if len(got) != len(want):
        raise ValueError(f"{len(got)} routed layers against {len(want)}")
    picks = flips = 0
    worst_gap = 0.0
    agree = None
    for g, w in zip(got, want):
        gl, gi, gk = (t.detach().cpu().flatten(0, -2) for t in g)
        wl, wi, wk = (t.detach().cpu().flatten(0, -2) for t in w)
        if gi.shape != wi.shape or gl.shape != wl.shape:
            raise ValueError(f"routings of {tuple(gi.shape)} and "
                             f"{tuple(wi.shape)} picks")
        T_, E = wl.shape
        k = wi.shape[1]
        picks += gi.numel()
        flips += int((gi != wi).sum())

        def chosen(idx, keep=None):
            m = torch.zeros((T_, E), dtype=torch.bool)
            src = torch.ones_like(idx, dtype=torch.bool) if keep is None \
                else keep
            return m.scatter(1, idx, src)

        picked_g, picked_w = chosen(gi), chosen(wi)
        same = (picked_g == picked_w).all(1) & \
            (chosen(gi, gk) == chosen(wi, wk)).all(1)
        first = ~same if agree is None else agree & ~same
        if first.any():
            wl64 = wl.double()
            top = wl64.sort(dim=1, descending=True).values
            cut = top[:, k - 1] if k == E else (top[:, k - 1] + top[:, k]) / 2
            dist = (wl64 - cut[:, None]).abs() * (picked_g ^ picked_w)
            worst_gap = max(worst_gap, float(dist[first].max())
                            / float(wl64.abs().max()))
        agree = same if agree is None else agree & same
    diverged = 0 if agree is None else int((~agree).sum())
    return RouteAgreement(picks, flips, diverged, worst_gap, agree)


def _causal_depthwise_conv(x, w, state=None):
    """x: (B, S, W) causal depthwise conv, kernel (cw, W).

    state: (B, cw-1, W) trailing inputs from the previous call (decode).
    Returns (y, new_state), the state a copy: a slice of the padded input
    would keep all of it alive in the cache."""
    cw = w.shape[0]
    hist = state if state is not None else torch.zeros(
        (x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    xp = torch.cat([hist, x], dim=1)
    y = sum(xp[:, i : i + x.shape[1]] * w[i][None, None, :] for i in range(cw))
    return y, xp[:, -(cw - 1):].clone()


# =================================================================== RG-LRU ====
def init_rglru(gen: torch.Generator, cfg: ModelConfig) -> Params:
    D = cfg.d_model
    W = cfg.rnn_width or D
    dt = pdt(cfg)
    return {
        "w_x": _dense_init(gen, (D, W), dt),  # recurrent branch input
        "w_gate_branch": _dense_init(gen, (D, W), dt),  # gelu gate branch
        "conv_w": _dense_init(gen, (cfg.conv_width, W), dt, scale=0.3),
        "w_input_gate": _dense_init(gen, (W, W), dt),
        "w_rec_gate": _dense_init(gen, (W, W), dt),
        "lam": torch.linspace(0.9, 0.999, W, device=gen.device),  # fp32
        "w_out": _dense_init(gen, (W, D), dt),
    }


def rglru_block(p, cfg: ModelConfig, x, ctx: Ctx, cache):
    """Griffin recurrent block, ``layers.py:491-518`` of the JAX package:
    (conv -> RG-LRU) * gelu gate -> out projection.  The gates' sigmoids
    are taken in the compute type and only then cast to float32, as there.

    Without a cache, and in a prefill, the recurrence runs through the
    RG-LRU kernel; a prefill from a state folds ``a_0 h`` into the first
    input and keeps the last ``h``.  A decode step is ``h = a h + bx``."""
    dt = cdt(cfg)
    u = x @ p["w_x"].to(dt)  # (B, S, W)
    gate_branch = gelu_tanh(x @ p["w_gate_branch"].to(dt))
    u, new_conv = _causal_depthwise_conv(u, p["conv_w"].to(dt),
                                         cache.get("conv") if cache else None)
    i_gate = torch.sigmoid(_gate_product(u, p["w_input_gate"].to(dt))).float()
    r_gate = torch.sigmoid(_gate_product(u, p["w_rec_gate"].to(dt))).float()
    log_a = -8.0 * r_gate * F.softplus(p["lam"].float())  # gated decay
    a = torch.exp(log_a)
    bx = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) \
        * (i_gate * u.float())
    if cache is not None and ctx.decoding:
        y32 = a * cache["h"] + bx  # (B, 1, W)
        new_cache = {"h": y32, "conv": new_conv}
    else:
        if cache is not None and "h" in cache:  # prefill from a state
            bx[:, 0] += a[:, 0] * cache["h"][:, 0]
        y32 = _rglru_recurrence(a, bx)
        new_cache = ({"h": y32[:, -1:].clone(), "conv": new_conv}
                     if cache is not None else None)
    return (y32.to(dt) * gate_branch) @ p["w_out"].to(dt), new_cache


def _gate_product(u, w):
    """``u @ w`` of an RG-LRU gate; under mesh rules on DTensors on each
    device's shards, the reference's layout: on each mesh dim u's rows or
    positions split as they lie, else its channels as w's input dim is
    (its ('tp', None)), a partial sum, else the output's channels as a
    slice of w.  DTensor's own rule leaves the product's gradient split
    over the sequence, and the weight gradient then multiplies a strided
    shard of the flattened (B, S), whose offsets DTensor cannot compute
    on fake tensors."""
    if not SH.sharded(u, w):
        return u @ w
    from torch.distributed.tensor import Partial, Replicate, Shard

    up, wp, out = [], [], []
    for pu, pw in zip(u.placements, w.placements):
        if pu.is_shard(0) or pu.is_shard(1):
            up.append(pu)
            wp.append(Replicate())
            out.append(pu)
        elif pw.is_shard(0):
            up.append(Shard(2))
            wp.append(pw)
            out.append(Partial())
        else:
            up.append(Replicate())
            wp.append(Shard(1))
            out.append(Shard(2))
    return SH.local_call(lambda ul, wl: ul @ wl, (u, w), (up, wp), out)


def _rglru_recurrence(a, b):
    """The RG-LRU kernel; under mesh rules on DTensors on each device's
    shards of rows and channels (a sequence split is gathered)."""
    if SH.sharded(a, b):
        ap = SH.kept(a, (0, 2))
        return SH.local_call(
            lambda al, bl: rglru_scan(al.contiguous(), bl.contiguous()),
            (a, b), (ap, ap), ap)
    return rglru_scan(a.contiguous(), b.contiguous())


def init_rglru_cache(cfg: ModelConfig, batch: int, *, device) -> dict:
    """h (B, 1, W) float32 and the conv's trailing inputs (B, cw-1, W) in
    the compute type, all 0."""
    W = cfg.rnn_width or cfg.d_model
    return {
        "h": torch.zeros((batch, 1, W), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, W), dtype=cdt(cfg),
                            device=device),
    }


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
    """Mamba-2 SSD block, ``layers.py:605-642`` of the JAX package.  Without
    a cache, and in a prefill (from the cache's state), the scan runs
    through :func:`ssd_forward` and the SSD kernel; a decode step is
    ``h = h exp(-dt A) + dt B x``, ``y = C h``."""
    dt_ = cdt(cfg)
    B, S, D = x.shape
    Di = cfg.ssm_expand * D
    H = Di // cfg.ssm_head_dim
    P = cfg.ssm_head_dim
    N = cfg.ssm_state
    zxbcdt = x @ p["w_in"].to(dt_)
    z, xs, Bm, Cm, dtv = zxbcdt.split([Di, Di, N, N, H], dim=-1)
    conv_in = torch.cat([xs, Bm, Cm], dim=-1)
    conv_out, new_conv = _causal_depthwise_conv(
        conv_in, p["conv_w"].to(dt_), cache.get("conv") if cache else None)
    conv_out = F.silu(conv_out)
    xs, Bm, Cm = conv_out.split([Di, N, N], dim=-1)
    xh = xs.reshape(B, S, H, P).float()
    dtv = F.softplus(dtv.float() + p["dt_bias"])  # (B, S, H)
    A = torch.exp(p["A_log"])  # (H,) positive rates
    if cache is not None and ctx.decoding:
        dt0 = dtv[:, 0]  # (B, H)
        dA = torch.exp(-dt0 * A[None, :])
        dBx = (dt0[:, :, None, None] * Bm.float()[:, 0, None, None, :]) \
            * xh[:, 0, :, :, None]  # (B, H, P, N)
        h = cache["h"] * dA[:, :, None, None] + dBx
        y = (Cm.float()[:, 0, None, None, :] * h).sum(-1)[:, None]
        new_cache = {"h": h, "conv": new_conv}
    else:
        h0 = cache["h"] if (cache is not None and "h" in cache) else None
        y, h_last = _ssd_scan(xh, dtv, A, Bm.float(), Cm.float(), h0,
                              cfg.ssm_chunk)
        new_cache = ({"h": h_last, "conv": new_conv} if cache is not None
                     else None)
    y = y + p["D_skip"][None, None, :, None] * xh
    y = y.reshape(B, S, Di).to(dt_)
    y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["w_out"].to(dt_), new_cache


def _ssd_scan(xh, dtv, A, Bm, Cm, h0, chunk: int):
    """:func:`ssd_forward`; under mesh rules on DTensors on each device's
    shards of rows and heads (B and C follow the rows; a sequence split is
    gathered)."""
    if not SH.sharded(xh, dtv, Bm):
        return ssd_forward(xh, dtv, A, Bm, Cm, h0, chunk)
    xp = SH.kept(xh, (0, 2))
    dtp = SH.like(xp, {0: 0, 2: 2})
    bp = SH.like(xp, {0: 0})
    hp = SH.like(xp, {0: 0, 2: 1})

    def local(x, d, a, b, c, h):
        return ssd_forward(x, d, a, b, c, h, chunk)

    return SH.local_call(
        local, (xh, dtv, A, Bm, Cm, h0),
        (xp, dtp, SH.like(xp, {2: 0}), bp, bp, None if h0 is None else hp),
        (xp, hp))


def init_ssd_cache(cfg: ModelConfig, batch: int, *, device) -> dict:
    """h (B, H, P, N) float32 and the conv's trailing inputs (B, cw-1,
    Di + 2N) in the compute type, all 0."""
    Di = cfg.ssm_expand * cfg.d_model
    H = Di // cfg.ssm_head_dim
    conv_dim = Di + 2 * cfg.ssm_state
    return {
        "h": torch.zeros((batch, H, cfg.ssm_head_dim, cfg.ssm_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_dim),
                            dtype=cdt(cfg), device=device),
    }
