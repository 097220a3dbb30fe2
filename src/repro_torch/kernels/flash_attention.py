"""Flash attention (GQA, causal, sliding window, tanh softcap) as a CUDA kernel.

:func:`flash_attention` is the wrapper, with the JAX package's layout: q
(B, Sq, Hq, hd), k and v (B, Skv, Hkv, hd), query head ``h`` reading kv head
``h // (Hq // Hkv)``; the output has q's shape and type.  On CUDA tensors it
launches the hand-written kernel in ``csrc/flash_attention.cu`` (built with
``nvcc`` for ``sm_90a`` at first use, see :mod:`.build`) and raises if the
build or the launch fails; the kernel takes bf16, the type the model path
gives it.  On CPU tensors it computes :func:`reference_attention`, the plain
PyTorch version, in any floating type.  Nothing here touches CUDA at import.

The kernel keeps the softmax probabilities in fp32 for the product with v,
as the TPU kernel does; the JAX model's own ``blocked_attention`` rounds
them to bf16 first, so the two differ by bf16 rounding.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build as _build

LIBRARY = _build.KernelLibrary("flash_attention", {
    "flash_attention_bf16": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p]})
HEAD_DIMS = (32, 64, 128, 256)  # head widths the kernel is built for
MASKED = -1e30

# Kernel launches made by flash_attention since the count was last set to 0.
launch_count = 0


def build():
    """Compile the kernel now (else it is built at its first launch)."""
    return LIBRARY.build()


def reference_attention(q, k, v, *, causal=True, window=None, softcap=None,
                        scale=None):
    """Plain PyTorch attention with the kernel's semantics: fp32 scores,
    softcap before masking, masked scores -1e30, softmax over all keys."""
    _check_shapes(q, k, v)
    B, Sq, Hq, hd = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    q32 = q.float().reshape(B, Sq, Hkv, G, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", q32, k.float()) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    qi = torch.arange(Sq, device=q.device)[:, None]
    ki = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= ki
    if window is not None:
        mask &= qi - ki < window
    s = s.masked_fill(~mask, MASKED)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", w, v.float())
    return o.reshape(B, Sq, Hq, hd).to(q.dtype)


def _check_shapes(q, k, v) -> None:
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"q (B, Sq, Hq, hd), k and v (B, Skv, Hkv, hd) "
                         f"expected, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]:
        raise ValueError(f"batch and head width must match, got "
                         f"{tuple(q.shape)} vs {tuple(k.shape)}")
    if k.shape[1] < 1:
        raise ValueError("attention needs at least one key")
    if k.shape[2] < 1 or q.shape[2] % k.shape[2]:
        raise ValueError(f"{q.shape[2]} query heads do not share "
                         f"{k.shape[2]} kv heads evenly")


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    softcap: float | None = None, scale: float | None = None):
    """``softmax(q k^T * scale) v`` per head, over the keys that ``causal``
    (query i sees key j <= i) and ``window`` (i - j < window) leave, with
    ``softcap * tanh(s / softcap)`` applied to the scores first.

    CPU tensors take :func:`reference_attention`.  CUDA tensors must be
    contiguous bf16 on one device with a head width in ``HEAD_DIMS``; they
    launch the kernel on the current stream, and anything the kernel does
    not take raises.
    """
    global launch_count
    _check_shapes(q, k, v)
    if not (q.device == k.device == v.device):
        raise ValueError(f"operands on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    if q.device.type == "cpu":
        return reference_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, got "
                         f"{q.device}")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"the flash attention kernel takes bf16 operands, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("the flash attention kernel takes contiguous "
                         "operands")
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"the flash attention kernel takes head widths "
                         f"{HEAD_DIMS}, got {hd}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    fn = LIBRARY.entry("flash_attention_bf16")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Sq, Skv, Hq, Hkv, hd, scale, int(causal), window or 0,
                 softcap or 0.0, stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {err}")
    launch_count += 1
    return out
