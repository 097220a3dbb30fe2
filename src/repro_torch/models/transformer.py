"""Model assembly: embedding + the block pattern repeated over the layers +
head, for the block kinds the port runs so far (``attn``, ``local_attn``,
``moe``, ``moe_dense``, ``rglru``, ``ssd``), with the caches of serving.

Parameters are plain dicts of tensors.  Where the JAX package stacks each
pattern slot's parameters over repetitions for one ``lax.scan``, the port
keeps one dict per layer in layer order (``params["stack"]["layers"]``) and
walks them in a Python loop; its caches are laid out the same way, one per
layer (``init_cache(...)["layers"]``).  ``models/convert.py`` carries JAX
parameters and caches over.  Initialisation draws from an explicit
``torch.Generator`` on the device the parameters live on.  In train mode with
``cfg.remat`` each full repetition of the pattern is rematerialised in the
backward (:func:`apply_stack`).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ModelConfig
from ..core.torch_solvers import resolve_device
from . import layers as L
from .layers import Ctx

# block kinds the port runs
KINDS = ("attn", "local_attn", "moe", "moe_dense", "rglru", "ssd")
# ROADMAP items of the block kinds that are not ported yet.
PENDING_KINDS = {
    "xattn": L.CROSS_ITEM,
    "dec_block": L.CROSS_ITEM,
}


def _check_kind(kind: str) -> None:
    if kind in PENDING_KINDS:
        raise NotImplementedError(f"block kind {kind!r} is not ported yet: "
                                  f"{PENDING_KINDS[kind]}")
    if kind not in KINDS:
        raise ValueError(f"unknown block kind {kind}")


# ------------------------------------------------------------------- params --
def init_block(gen: torch.Generator, cfg: ModelConfig, kind: str) -> dict:
    _check_kind(kind)
    dt = L.pdt(cfg)
    D = cfg.d_model
    p: dict = {"ln1": L._zeros(gen, (D,), dt)}
    if kind in ("attn", "local_attn"):
        p["attn"] = L.init_attention(gen, cfg)
        p["ln2"] = L._zeros(gen, (D,), dt)
        p["mlp"] = L.init_mlp(gen, cfg)
    elif kind in ("moe", "moe_dense"):
        p["attn"] = L.init_attention(gen, cfg)
        p["ln2"] = L._zeros(gen, (D,), dt)
        p["moe"] = L.init_moe(gen, cfg)
        if kind == "moe_dense":
            p["mlp"] = L.init_mlp(gen, cfg)
    elif kind == "rglru":
        p["rglru"] = L.init_rglru(gen, cfg)
        p["ln2"] = L._zeros(gen, (D,), dt)
        p["mlp"] = L.init_mlp(gen, cfg)
    else:  # ssd
        p["ssd"] = L.init_ssd(gen, cfg)
    return p


def _check_cache_kind(kind: str) -> None:
    if kind in ("moe", "moe_dense"):
        raise NotImplementedError(f"block kind {kind!r} with a cache is not "
                                  f"ported yet: {L.MOE_CACHE_ITEM}")


def apply_block(p, cfg: ModelConfig, kind: str, x, ctx: Ctx, cache):
    """Pre-norm block; returns (x, new_cache, aux_loss), the aux loss being
    the MoE load-balance loss of a ``moe`` / ``moe_dense`` block and 0
    otherwise.  A decode step needs the block's cache."""
    _check_kind(kind)
    if cache is not None or ctx.decoding:
        _check_cache_kind(kind)
    if ctx.decoding and cache is None:
        raise ValueError(f"a decode step of a {kind!r} block needs its cache")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind in ("attn", "local_attn", "moe", "moe_dense"):
        window = cfg.window if kind == "local_attn" else None
        h, cache = L.attention_block(
            p["attn"], cfg, L.rmsnorm(x, p["ln1"], cfg.norm_eps), ctx, cache,
            window=window)
        x = x + h
        hin = L.rmsnorm(x, p["ln2"], cfg.norm_eps)
        if kind in ("moe", "moe_dense"):
            y, aux = L.moe_ffn(p["moe"], cfg, hin)
            if kind == "moe_dense":
                y = y + L.mlp(p["mlp"], cfg, hin)
        else:
            y = L.mlp(p["mlp"], cfg, hin)
        x = x + y
    elif kind == "rglru":
        h, cache = L.rglru_block(p["rglru"], cfg,
                                 L.rmsnorm(x, p["ln1"], cfg.norm_eps), ctx,
                                 cache)
        x = x + h
        x = x + L.mlp(p["mlp"], cfg, L.rmsnorm(x, p["ln2"], cfg.norm_eps))
    else:  # ssd
        h, cache = L.ssd_block(p["ssd"], cfg,
                               L.rmsnorm(x, p["ln1"], cfg.norm_eps), ctx,
                               cache)
        x = x + h
    return x, cache, aux


def layer_kinds(n_layers: int, pattern) -> list[str]:
    return [pattern[i % len(pattern)] for i in range(n_layers)]


def init_stack(gen: torch.Generator, cfg: ModelConfig, n_layers: int,
               pattern: tuple[str, ...]) -> dict:
    return {"layers": [init_block(gen, cfg, kind)
                       for kind in layer_kinds(n_layers, pattern)]}


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, length: int,
                     *, device) -> dict:
    """An empty cache of one block for ``length`` tokens: a KV ring of
    ``length`` slots (``min(length, window)`` for ``local_attn``), or the
    RG-LRU's or SSD's state."""
    _check_kind(kind)
    _check_cache_kind(kind)
    if kind == "attn":
        return L.init_kv_cache(cfg, batch, length, device=device)
    if kind == "local_attn":
        return L.init_kv_cache(cfg, batch, min(length, cfg.window or length),
                               device=device)
    if kind == "rglru":
        return L.init_rglru_cache(cfg, batch, device=device)
    return L.init_ssd_cache(cfg, batch, device=device)


def init_stack_cache(cfg: ModelConfig, n_layers: int, pattern, batch: int,
                     length: int, *, device) -> dict:
    """One empty cache per layer, in layer order."""
    return {"layers": [init_block_cache(cfg, kind, batch, length,
                                        device=device)
                       for kind in layer_kinds(n_layers, pattern)]}


def _run_layers(layers, cfg: ModelConfig, kinds, x, ctx: Ctx, caches):
    """``layers`` in order; returns (x, new_caches, aux_sum)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    new_caches = []
    for lp, kind, c in zip(layers, kinds, caches):
        x, c, aux = apply_block(lp, cfg, kind, x, ctx, c)
        aux_total = aux_total + aux
        new_caches.append(c)
    return x, new_caches, aux_total


def apply_stack(p, cfg: ModelConfig, n_layers: int, pattern, x, ctx: Ctx,
                cache):
    """Every layer in order, each with its cache where ``cache`` (one per
    layer, as :func:`init_stack_cache` lays them out) is given.  Returns
    (x, new_cache, aux_sum), ``new_cache`` None without a cache.

    Where ``cfg.remat`` and ``ctx.mode == "train"``, each full repetition of
    the pattern runs under ``torch.utils.checkpoint`` (non-reentrant): its
    activations are recomputed in the backward, as the JAX package's
    ``jax.checkpoint`` over its scan body does; the remainder layers run
    without it, as there."""
    kinds = layer_kinds(n_layers, pattern)
    layers = p["layers"]
    if len(layers) != len(kinds):
        raise ValueError(f"{len(layers)} layers of parameters for "
                         f"{len(kinds)} layers")
    caches = [None] * len(kinds) if cache is None else cache["layers"]
    if len(caches) != len(kinds):
        raise ValueError(f"{len(caches)} layers of caches for {len(kinds)} "
                         f"layers")
    if not (cfg.remat and ctx.mode == "train" and cache is None):
        x, new_caches, aux_total = _run_layers(layers, cfg, kinds, x, ctx,
                                               caches)
        return x, (None if cache is None else {"layers": new_caches}), \
            aux_total
    plen = len(pattern)
    full = n_layers // plen * plen
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for r0 in range(0, full, plen):
        def rep(h, r0=r0):
            h, _, aux = _run_layers(layers[r0:r0 + plen], cfg,
                                    kinds[r0:r0 + plen], h, ctx,
                                    caches[r0:r0 + plen])
            return h, aux

        x, aux = checkpoint(rep, x, use_reentrant=False)
        aux_total = aux_total + aux
    x, _, aux = _run_layers(layers[full:], cfg, kinds[full:], x, ctx,
                            caches[full:])
    return x, None, aux_total + aux


# ---------------------------------------------------------------- full model --
def tree_map(fn, tree):
    """``fn`` applied to every leaf of nested dicts and lists (parameters,
    or a sub-stack of them), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts and lists, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_paths(tree, prefix=()) -> list:
    """(path, leaf) of every leaf of nested dicts and lists, in
    :func:`tree_leaves` order; a path is the tuple of keys and indices."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in tree_paths(
            v, prefix + (k,))]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree) for x in tree_paths(
            v, prefix + (i,))]
    return [(prefix, tree)]


def init_params(gen: torch.Generator, cfg: ModelConfig,
                device: str | torch.device = "cuda") -> dict:
    """Random parameters drawn from ``gen``, which must live on ``device``
    (``"cuda"`` unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    if gen.device.type != dev.type:
        raise ValueError(f"the generator lives on {gen.device}, the "
                         f"parameters are asked for on {dev}")
    if cfg.enc_layers:
        raise NotImplementedError(f"encoder stacks are not ported yet: "
                                  f"{L.CROSS_ITEM}")
    dt = L.pdt(cfg)
    V, D = cfg.vocab_size, cfg.d_model
    params = {
        "embed": (torch.randn((V, D), generator=gen, device=gen.device)
                  * 0.02).to(dt),
        "final_norm": L._zeros(gen, (D,), dt),
        "stack": init_stack(gen, cfg, cfg.n_layers, cfg.pattern),
    }
    if not cfg.tie_embeddings:
        params["head"] = (torch.randn((D, V), generator=gen,
                                      device=gen.device) / D ** 0.5).to(dt)
    return params


def embed_tokens(params, cfg: ModelConfig, tokens):
    x = params["embed"][tokens].to(L.cdt(cfg))
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model, dtype=L.cdt(cfg),
                             device=x.device).sqrt()
    return x


def head_matrix(params, cfg: ModelConfig):
    return params["embed"].T if cfg.tie_embeddings else params["head"]


def forward(params, cfg: ModelConfig, tokens, ctx: Ctx, cache=None,
            memory=None):
    """tokens (B, S) -> (hidden (B, S, D), new_cache, aux); ``cache`` is
    the stack's (:func:`init_cache`), and the new one is returned."""
    if memory is not None:
        raise NotImplementedError(f"modality memory is not ported yet: "
                                  f"{L.CROSS_ITEM}")
    x = embed_tokens(params, cfg, tokens)
    x, new_cache, aux = apply_stack(params["stack"], cfg, cfg.n_layers,
                                    cfg.pattern, x, ctx, cache)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x, new_cache, aux


def init_cache(cfg: ModelConfig, batch: int, length: int,
               device: str | torch.device = "cuda") -> dict:
    """The empty caches of every layer for ``length`` tokens, on ``device``
    (``"cuda"`` unless the caller asks for the CPU)."""
    return init_stack_cache(cfg, cfg.n_layers, cfg.pattern, batch, length,
                            device=resolve_device(device))


def logits_last(params, cfg: ModelConfig, hidden):
    """Final-position logits (serving)."""
    W = head_matrix(params, cfg).to(L.cdt(cfg))
    logits = hidden[:, -1:] @ W
    if cfg.final_softcap:
        logits = L.softcap(logits.float(), cfg.final_softcap)
    return logits.float()
