"""Serving: prefill + decode steps with per-family caches, the JAX package's
``serving/engine.py`` in PyTorch.

``prefill`` runs the prompt through the model from empty caches (attention
through the flash kernel, the SSD and RG-LRU scans through theirs) and
returns the next-token logits with the caches; ``decode_step`` takes one
token per sequence against them, in plain PyTorch (cross-attention
through the flash kernel over the cross K/V the prefill projected).  A
config with cross-attention takes its memory (B, M, D) at ``prefill``,
which encodes it once and keeps it in the cache (``enc_memory``).
``ServingEngine`` is the host loop: it packs requests into the fixed batch, left-pads them with 0,
and decodes greedily until ``max_new`` tokens or ``eos_id``.  Everything
runs eagerly under ``torch.inference_mode()``; the caches' KV rings are
written in place.

Every config serves, MoE too (``moe`` and ``moe_dense`` blocks keep the KV
ring of ``attn``).  An MoE layer routes a call's own tokens: the prefill's
B * S in groups of ``MOE_GROUP`` (whole groups of it past it), a decode
step's B as one group with capacity ``max(1, int(B * k / E *
capacity_factor))``, so a cached decode and a cache-free forward over the
same tokens can rightly drop different slots.  The pad tokens of the
left-padded prompts and the rows past the requests are routed like any
other token and take expert capacity from the real ones; the JAX package
does the same, and the port keeps it.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.torch_solvers import resolve_device
from ..models import transformer as T
from ..models.layers import Ctx
from ..models.sharding import positions


@torch.inference_mode()
def prefill(params, cfg: ModelConfig, tokens, cache_len: int, memory=None,
            cache=None):
    """tokens (B, S) -> (next-token logits (B, 1, V) float32, cache), on
    the tokens' device.  Positions are ``0 .. S-1`` for every row.  A
    ``memory`` (B, M, D) is encoded once (``encode_memory``) and kept in
    the cache as ``enc_memory``.  ``cache`` is the empty stack cache to
    fill (``init_cache(cfg, B, cache_len)``'s, made here when None; the dry
    run passes one laid out over its mesh)."""
    B, S = tokens.shape
    if cache is None:
        cache = T.init_cache(cfg, B, cache_len, device=tokens.device)
    pos = positions(tokens, S)
    enc = (T.encode_memory(params, cfg, memory) if memory is not None
           else None)
    hidden, cache, _ = T.forward(params, cfg, tokens,
                                 Ctx(mode="prefill", positions=pos,
                                     memory=enc),
                                 cache=cache)
    extras = {"enc_memory": enc} if enc is not None else {}
    return T.logits_last(params, cfg, hidden), {"stack": cache, **extras}


@torch.inference_mode()
def decode_step(params, cfg: ModelConfig, cache, tokens, positions):
    """One token per sequence: tokens (B, 1), positions (B, 1) absolute.
    Returns (logits (B, 1, V) float32, the new cache)."""
    ctx = Ctx(mode="decode", positions=positions,
              memory=cache.get("enc_memory"))
    hidden, stack_cache, _ = T.forward(params, cfg, tokens, ctx,
                                       cache=cache["stack"])
    return T.logits_last(params, cfg, hidden), dict(cache, stack=stack_cache)


def make_serve_step(cfg: ModelConfig):
    """One greedy decode step: (params, cache, tokens, positions) ->
    (next token (B,) int64, the new cache); ties go to the first index."""

    def serve_step(params, cache, tokens, positions):
        logits, cache = decode_step(params, cfg, cache, tokens, positions)
        return torch.argmax(logits[:, -1], dim=-1), cache

    return serve_step


def left_pad(prompts, batch: int) -> np.ndarray:
    """The prompts (at most ``batch``) as one (batch, longest) int64 array,
    each row left-padded with 0; rows past the prompts are all 0."""
    pad_to = max(len(p) for p in prompts)
    toks = np.zeros((batch, pad_to), np.int64)
    for i, p in enumerate(prompts):
        toks[i, pad_to - len(p):] = p
    return toks


@dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    generated: list = None


class ServingEngine:
    """Host-side batched serving loop, the JAX package's step for step.  It
    runs on ``device`` (``"cuda"`` unless the caller asks for the CPU),
    where the parameters must live; the host reads each step's tokens once
    (``tolist``)."""

    def __init__(self, cfg: ModelConfig, params, batch_size: int,
                 cache_len: int, eos_id: int = 0,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        for t in T.tree_leaves(params):
            if t.device.type != self.device.type:
                raise ValueError(f"a parameter lives on {t.device}, the "
                                 f"engine runs on {self.device}")
        self.cfg, self.params = cfg, params
        self.B, self.cache_len, self.eos = batch_size, cache_len, eos_id
        self._step = make_serve_step(cfg)

    def generate(self, prompts: list[np.ndarray],
                 max_new: int) -> list[list[int]]:
        """Greedy tokens of each prompt.  As the JAX package's, it passes
        no memory, so a config with cross-attention cannot be served here
        and raises (ROADMAP §C); ``prefill(memory=...)`` and
        ``decode_step`` serve one."""
        if T.has_cross(self.cfg):
            raise ValueError(f"{self.cfg.name} attends to a memory, which "
                             f"ServingEngine.generate does not take (nor "
                             f"does the JAX package's): call "
                             f"prefill(memory=...) and decode_step")
        outs: list[list[int]] = []
        for start in range(0, len(prompts), self.B):
            group = prompts[start : start + self.B]
            toks = torch.from_numpy(left_pad(group, self.B)).to(self.device)
            pad_to = toks.shape[1]
            logits, cache = prefill(self.params, self.cfg, toks,
                                    self.cache_len)
            cur = torch.argmax(logits[:, -1], dim=-1)
            pos = torch.full((self.B, 1), pad_to, dtype=torch.int64,
                             device=self.device)
            gen = [[] for _ in group]
            done = np.zeros(self.B, bool)
            for _ in range(max_new):
                host = cur.tolist()
                for i in range(len(group)):
                    if not done[i]:
                        gen[i].append(host[i])
                        done[i] = host[i] == self.eos
                if done[: len(group)].all():
                    break
                cur, cache = self._step(self.params, cache, cur[:, None], pos)
                pos = pos + 1
            outs.extend(gen)
        return outs
