"""Serving: prefill + decode steps with per-family caches, the JAX package's
``serving/engine.py`` in PyTorch.

``prefill`` runs the prompt through the model from empty caches (attention
through the flash kernel, the SSD and RG-LRU scans through theirs) and
returns the next-token logits with the caches; ``decode_step`` takes one
token per sequence against them, in plain PyTorch.  ``ServingEngine`` is the
host loop: it packs requests into the fixed batch, left-pads them with 0,
and decodes greedily until ``max_new`` tokens or ``eos_id``.  Everything
runs eagerly under ``torch.inference_mode()``; the caches' KV rings are
written in place.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..core.torch_solvers import resolve_device
from ..models import transformer as T
from ..models.layers import CROSS_ITEM, Ctx


@torch.inference_mode()
def prefill(params, cfg: ModelConfig, tokens, cache_len: int, memory=None):
    """tokens (B, S) -> (next-token logits (B, 1, V) float32, cache), on
    the tokens' device.  Positions are ``0 .. S-1`` for every row."""
    if memory is not None:
        raise NotImplementedError(f"modality memory is not ported yet: "
                                  f"{CROSS_ITEM}")
    B, S = tokens.shape
    cache = T.init_cache(cfg, B, cache_len, device=tokens.device)
    pos = torch.arange(S, device=tokens.device).expand(B, S)
    hidden, cache, _ = T.forward(params, cfg, tokens,
                                 Ctx(mode="prefill", positions=pos),
                                 cache=cache)
    return T.logits_last(params, cfg, hidden), {"stack": cache}


@torch.inference_mode()
def decode_step(params, cfg: ModelConfig, cache, tokens, positions):
    """One token per sequence: tokens (B, 1), positions (B, 1) absolute.
    Returns (logits (B, 1, V) float32, the new cache)."""
    ctx = Ctx(mode="decode", positions=positions)
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
