"""Flash attention (GQA, causal, sliding window, tanh softcap) as CUDA
kernels, forward and backward.

:func:`flash_attention` is the wrapper, with the JAX package's layout: q
(B, Sq, Hq, hd), k and v (B, Skv, Hkv, hd), query head ``h`` reading kv head
``h // (Hq // Hkv)``; the output has q's shape and type.  On CUDA tensors it
launches the hand-written kernel in ``csrc/flash_attention.cu`` (built with
``nvcc`` for ``sm_90a`` at first use, see :mod:`.build`) and raises if the
build or the launch fails; the kernel takes bf16, the type the model path
gives it.  Where grad mode is on and an operand requires grad, the launch
goes through the autograd Function ``_FlashAttention``: the forward kernel
then also writes each row's log-sum-exp, and the backward is the
hand-written kernel in ``csrc/flash_attention_bwd.cu``
(:func:`flash_attention_bwd`), so no gradient is lost at the kernel.  On
CPU tensors it computes :func:`reference_attention`, the plain PyTorch
version, in any floating type, and autograd differentiates that.  Nothing
here touches CUDA at import.

The forward kernel runs both products on Hopper's tensor cores (``wgmma``,
with TMA loads into a ring of shared-memory stages).  It rounds the softmax
probabilities to bf16 before the product with v, as the JAX model's own
``blocked_attention`` does (``src/repro/models/layers.py:222``); the TPU
kernel and :func:`reference_attention` keep them fp32, so the kernel
differs from its plain version by that rounding too: on an H100 its worst
(batch, query, head) row lies within 4.9e-3 of the row's norm (2.2e-3
with fp32 p), inside ``chip_smoke.py``'s FLASH_TOL of 1e-2.  The tensor
cores' rate bounds it; it reaches about 350–370 TFLOP/s at head width 128
and 550 at 256 (PERF.md).  The backward differentiates the fp32-p function
(:func:`reference_attention`'s) on the tensor cores too (``wgmma``, with P
and dS rounded to bf16 as the products' operands; PERF.md gives its
errors and times).
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..roofline import kernel_work
from . import build as _build

LIBRARY = _build.KernelLibrary("flash_attention", {
    "flash_attention_bf16": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p, ctypes.c_void_p]})
BWD_LIBRARY = _build.KernelLibrary("flash_attention_bwd", {
    "flash_attention_bwd_bf16": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_float,
       ctypes.c_void_p]})
HEAD_DIMS = (16, 32, 64, 128, 256)  # head widths the kernels are built for
MASKED = -1e30

# Kernel launches made by flash_attention since the count was last set to 0
# (forward), and by flash_attention_bwd (backward).
launch_count = 0
bwd_launch_count = 0


def build():
    """Compile the forward kernel now (else it is built at its first
    launch)."""
    return LIBRARY.build()


def reference_attention(q, k, v, *, causal=True, window=None, softcap=None,
                        scale=None, dtype=torch.float32):
    """Plain PyTorch attention with the kernel's semantics: fp32 scores,
    softcap before masking, masked scores -1e30, softmax over all keys.
    ``dtype`` is the type it computes in (float64 for a witness)."""
    _check_shapes(q, k, v)
    B, Sq, Hq, hd = q.shape
    _, Sk, Hkv, _ = k.shape
    G = Hq // Hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.to(dtype).reshape(B, Sq, Hkv, G, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.to(dtype)) * scale
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
    o = torch.einsum("bkgqs,bskh->bqkgh", w, v.to(dtype))
    return o.reshape(B, Sq, Hq, hd).to(q.dtype)


def reference_lse(q, k, *, causal=True, window=None, softcap=None,
                  scale=None):
    """Each (batch, head, query) row's log-sum-exp of the plain version's
    masked scores, float32 (B, Hq, Sq): what the forward kernel writes for
    the backward."""
    B, Sq, Hq, hd = q.shape
    _, Sk, Hkv, _ = k.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    s = torch.einsum("bqkgh,bskh->bkgqs",
                     q.float().reshape(B, Sq, Hkv, Hq // Hkv, hd),
                     k.float()) * scale
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
    return torch.logsumexp(s, dim=-1).reshape(B, Hq, Sq)


def reference_attention_bwd(q, k, v, lse, dout, *, causal=True, window=None,
                            softcap=None, scale=None, dtype=torch.float32):
    """The plain version of the backward: (dq, dk, dv) in ``dtype``,
    autograd through :func:`reference_attention` on the operands widened to
    it (float32: fp32 probabilities, the function the backward kernel
    differentiates; float64: the witness).  It takes the wrapper's
    operands; the forward's ``lse`` is not needed here."""
    with torch.enable_grad():
        q32, k32, v32 = (t.detach().to(dtype).requires_grad_()
                         for t in (q, k, v))
        o = reference_attention(q32, k32, v32, causal=causal, window=window,
                                softcap=softcap, scale=scale, dtype=dtype)
        return torch.autograd.grad(o, (q32, k32, v32), dout.to(dtype))


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


def _check_launch(q, k, v, what: str) -> None:
    """What the kernels take of CUDA operands; raises on anything else."""
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"the flash attention {what} kernel takes bf16 "
                        f"operands, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"the flash attention {what} kernel takes "
                         f"contiguous operands")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"the flash attention {what} kernel takes head "
                         f"widths {HEAD_DIMS}, got {q.shape[3]}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"the flash attention {what} kernel takes 16-byte "
                         f"aligned operands (its TMA loads need them)")


def _check_call(q, k, v, window) -> None:
    _check_shapes(q, k, v)
    if not (q.device == k.device == v.device):
        raise ValueError(f"operands on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be at least 1, got {window}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda or cpu, got "
                         f"{q.device}")


def _launch_forward(q, k, v, causal, window, softcap, scale, with_lse):
    """One launch of the forward kernel: the output, and each row's
    log-sum-exp (B, Hq, Sq) float32 when ``with_lse`` (else None, and the
    kernel writes none)."""
    global launch_count
    _check_launch(q, k, v, "forward")
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return out, lse
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    fn = LIBRARY.entry("flash_attention_bf16")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, Sq, Skv, Hq, Hkv, hd, scale, int(causal), window or 0,
                 softcap or 0.0, lse.data_ptr() if with_lse else None,
                 stream)
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: CUDA "
                           f"error {err}")
    launch_count += 1
    return out, lse


def flash_attention_with_lse(q, k, v, *, causal: bool = True,
                             window: int | None = None,
                             softcap: float | None = None,
                             scale: float | None = None):
    """``(output, lse)``: :func:`flash_attention`'s output and each (batch,
    head, query) row's log-sum-exp of the masked scores, float32 (B, Hq,
    Sq), with no autograd history.  CPU tensors take the plain versions
    (:func:`reference_attention`, :func:`reference_lse`); CUDA tensors one
    launch of the forward kernel, which then writes the log-sum-exp too."""
    _check_call(q, k, v, window)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if kernel_work.is_fake(q, k, v):
        B, Sq, Hq, _ = q.shape
        key = kernel_work.flash_key(q, k, causal, window, softcap)
        return kernel_work.standin(
            "flash_attention", key, None,
            [(q.shape, q.dtype), ((B, Hq, Sq), torch.float32)], q, k, v)
    with torch.no_grad():
        if q.device.type == "cpu":
            return reference_attention(q, k, v, **kw), reference_lse(q, k,
                                                                     **kw)
        return _launch_forward(q, k, v, causal, window, softcap, scale, True)


def flash_attention_bwd(q, k, v, lse, dout, *, causal: bool = True,
                        window: int | None = None,
                        softcap: float | None = None,
                        scale: float | None = None):
    """The gradients ``(dq, dk, dv)`` of :func:`flash_attention` at
    ``(q, k, v)`` for the output's cotangent ``dout``, in q's type, from the
    forward's ``lse`` (:func:`flash_attention_with_lse`).

    CPU tensors take :func:`reference_attention_bwd`.  CUDA tensors launch
    the backward kernel on the current stream (bf16, contiguous, head widths
    ``HEAD_DIMS``); anything it does not take raises."""
    global bwd_launch_count
    _check_call(q, k, v, window)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale)
    if q.device.type == "cpu":
        return tuple(g.to(q.dtype) for g in reference_attention_bwd(
            q, k, v, lse, dout, **kw))
    _check_launch(q, k, v, "backward")
    B, Sq, Hq, hd = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if dout.shape != q.shape or lse.shape != (B, Hq, Sq):
        raise ValueError(f"dout {tuple(q.shape)} and lse {(B, Hq, Sq)} "
                         f"expected, got {tuple(dout.shape)}, "
                         f"{tuple(lse.shape)}")
    if lse.dtype != torch.float32:
        raise TypeError(f"float32 lse expected, got {lse.dtype}")
    dout = dout.to(torch.bfloat16).contiguous()
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    dsum = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    fn = BWD_LIBRARY.entry("flash_attention_bwd_bf16")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 dout.data_ptr(), lse.data_ptr(), dsum.data_ptr(),
                 dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Sq, Skv,
                 Hq, Hkv, hd, scale, int(causal), window or 0,
                 softcap or 0.0, stream)
    if err != 0:
        raise RuntimeError(f"flash attention backward kernel launch failed: "
                           f"CUDA error {err}")
    bwd_launch_count += 1
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """The forward kernel with its log-sum-exp, and the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        out, lse = _launch_forward(q, k, v, causal, window, softcap, scale,
                                   True)
        ctx.save_for_backward(q, k, v, lse)
        ctx.kw = dict(causal=causal, window=window, softcap=softcap,
                      scale=scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, lse, dout, **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    softcap: float | None = None, scale: float | None = None):
    """``softmax(q k^T * scale) v`` per head, over the keys that ``causal``
    (query i sees key j <= i) and ``window`` (i - j < window) leave, with
    ``softcap * tanh(s / softcap)`` applied to the scores first.

    CPU tensors take :func:`reference_attention`.  CUDA tensors must be
    contiguous, 16-byte aligned bf16 on one device with a head width in
    ``HEAD_DIMS``; they launch the kernel on the current stream, and
    anything the kernel does not take raises.  Where grad mode is on and an
    operand requires grad, the result carries the backward kernel.  Fake
    tensors (the dry run) take ``kernel_work.standin``.
    """
    _check_call(q, k, v, window)
    if kernel_work.is_fake(q, k, v):
        key = kernel_work.flash_key(q, k, causal, window, softcap)
        return kernel_work.standin("flash_attention", key, key,
                                   [(q.shape, q.dtype)], q, k, v)
    if q.device.type == "cpu":
        return reference_attention(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window, softcap, scale)
    return _launch_forward(q, k, v, causal, window, softcap, scale, False)[0]
