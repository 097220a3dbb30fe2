"""Gradient compression for data-parallel synchronisation, as the JAX
package's ``src/repro/optim/compress.py``:

  * int8 blockwise quantisation with error feedback (EF-SGD style), about
    4x fewer bytes for a data-parallel all-reduce;
  * top-k sparsification with error feedback.

Pure tensor functions on any device; the port's pipeline runtime (ROADMAP
A7) is to use them.
"""
from __future__ import annotations

import math

import torch

BLOCK = 2048


def _pad_to_block(x):
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    return torch.nn.functional.pad(flat, (0, pad)), pad


def quantize_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Blockwise symmetric int8 quantisation.  Returns (q, scales)."""
    flat, _ = _pad_to_block(x.float())
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clip(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape, dtype):
    flat = (q.float() * scale).reshape(-1)
    n = math.prod(shape)
    return flat[:n].reshape(shape).to(dtype)


def compress_with_feedback(grad, error):
    """int8 compress ``grad + error``; returns (q, scale, new_error)."""
    g = grad.float() + error
    q, scale = quantize_int8(g)
    deq = dequantize_int8(q, scale, grad.shape, torch.float32)
    return q, scale, g - deq


def init_error_feedback(params):
    from ..models.transformer import tree_map

    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def topk_sparsify(x: torch.Tensor, frac: float = 0.01):
    """Keep the largest-|.| ``frac`` of entries; returns (values, indices)."""
    flat = x.reshape(-1).float()
    k = max(1, int(flat.shape[0] * frac))
    _, idx = torch.topk(flat.abs(), k)
    return flat[idx], idx


def topk_densify(values, idx, shape, dtype):
    n = math.prod(shape)
    out = torch.zeros((n,), dtype=torch.float32, device=values.device)
    out[idx] = values
    return out.reshape(shape).to(dtype)
