"""The RG-LRU linear recurrence as CUDA kernels, forward and backward.

:func:`rglru_scan` is the wrapper: a and b (B, S, W) float32 give h
(B, S, W) with ``h_t = a_t h_{t-1} + b_t`` over S from ``h_0 = 0``, every
channel on its own.  On CUDA tensors it launches the hand-written kernel in
``csrc/rglru.cu`` (built with ``nvcc`` for ``sm_90a`` at first use, see
:mod:`.build`) and raises if the build or the launch fails; the kernel takes
float32, the type the model path gives it, and reads a and b once: its TMA
instantiation where :func:`tma_route` allows it, else its ``cp.async``
one.  Where grad mode is on and an operand requires grad, the launch goes
through the autograd Function ``_RGLRUScan``, which keeps h, and whose
backward is the hand-written kernel in ``csrc/rglru_bwd.cu``
(:func:`rglru_scan_bwd`): the reverse scan
``lambda_t = g_t + a_{t+1} lambda_{t+1}`` of the cotangent g, with ``db =
lambda`` and ``da_t = lambda_t h_{t-1}``.  On CPU tensors it computes
:func:`reference_rglru_scan`, the plain PyTorch version, and autograd
differentiates that.  Nothing here touches CUDA at import.
"""
from __future__ import annotations

import ctypes

import torch

from ..roofline import kernel_work
from . import build as _build

LIBRARY = _build.KernelLibrary("rglru", {
    "rglru_scan_f32": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]})
BWD_LIBRARY = _build.KernelLibrary("rglru_bwd", {
    "rglru_scan_bwd_f32": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p],
    "rglru_bwd_chunks": [ctypes.c_int]})

# Kernel launches made by rglru_scan since the count was last set to 0
# (forward), and by rglru_scan_bwd (backward).
launch_count = 0
bwd_launch_count = 0


def build():
    """Compile the forward kernel now (else it is built at its first
    launch)."""
    return LIBRARY.build()


def reference_rglru_scan(a, b, *, dtype=torch.float32):
    """Plain PyTorch version, computed and returned in ``dtype`` (float32,
    the kernel's type; float64 gives a witness of the exact values): a
    doubling scan over S, which combines the pairs (a, h) as the JAX
    package's associative scan does, ``(a1, h1) . (a2, h2) = (a1 a2,
    a2 h1 + h2)``, in log2(S) steps."""
    _check(a, b)
    A, H = a.to(dtype), b.to(dtype)
    d = 1
    while d < a.shape[1]:
        H = torch.cat([H[:, :d], A[:, d:] * H[:, :-d] + H[:, d:]], dim=1)
        A = torch.cat([A[:, :d], A[:, d:] * A[:, :-d]], dim=1)
        d *= 2
    return H


def _shift(t, to_later: bool):
    """t moved one step along S, zero-filled: ``out_t = t_{t-1}`` (to a
    later step) or ``out_t = t_{t+1}``."""
    zero = torch.zeros_like(t[:, :1])
    return (torch.cat([zero, t[:, :-1]], dim=1) if to_later else
            torch.cat([t[:, 1:], zero], dim=1))


def reference_rglru_scan_bwd(a, h, g, *, dtype=torch.float32):
    """The plain version of the backward: ``(da, db)`` of
    :func:`reference_rglru_scan` at a and the b that gives h, for the
    cotangent g of h, in ``dtype`` (float64 gives a witness).  The
    recurrence is linear in b, so its transpose is the same recurrence run
    from the end: ``lambda = flip(reference_rglru_scan(flip(a_{t+1}),
    flip(g)))``, which is db, and ``da_t = lambda_t h_{t-1}`` with
    ``h_0 = 0``."""
    _check(a, h)
    _check(a, g)
    a, h, g = (t.to(dtype) for t in (a, h, g))
    lam = reference_rglru_scan(_shift(a, False).flip(1), g.flip(1),
                               dtype=dtype).flip(1)
    return lam * _shift(h, True), lam


def _check(a, b) -> None:
    if a.ndim != 3 or a.shape != b.shape:
        raise ValueError(f"a and b (B, S, W) of one shape expected, got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")


def _check_call(operands, what: str) -> None:
    if len({t.device for t in operands}) != 1:
        raise ValueError(f"operands on different devices: "
                         f"{[str(t.device) for t in operands]}")
    if operands[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, got "
                         f"{operands[0].device}")


def _check_launch(operands, what: str) -> None:
    """What the kernels take of CUDA operands; raises on anything else."""
    if any(t.dtype != torch.float32 for t in operands):
        raise TypeError(f"the RG-LRU {what} kernel takes float32 operands, "
                        f"got {[t.dtype for t in operands]}")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError(f"the RG-LRU {what} kernel takes contiguous "
                         f"operands")


def tma_route(*operands) -> bool:
    """Whether the forward kernel takes these (B, S, W) float32 operands
    through its TMA instantiation: W a multiple of 4 (16-byte row strides)
    and every base 16-byte aligned, the tensor maps' rules.  Any other W or
    base (a view with a storage offset) takes its ``cp.async``
    instantiation, the same hand-written scan."""
    return (operands[0].shape[-1] % 4 == 0
            and all(t.data_ptr() % 16 == 0 for t in operands))


def _launch_forward(a, b):
    global launch_count
    _check_launch((a, b), "forward")
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    B, S, W = a.shape
    fn = LIBRARY.entry("rglru_scan_f32")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), B, S, W,
                 int(tma_route(a, b, out)), stream)
    if err != 0:
        raise RuntimeError(f"RG-LRU kernel launch failed: CUDA error {err}")
    launch_count += 1
    return out


def rglru_scan_bwd(a, h, g):
    """The gradients ``(da, db)`` of :func:`rglru_scan` at ``(a, b)`` for
    the cotangent ``g`` of its output ``h`` (B, S, W), from a and h alone
    (the gradient does not depend on b), all float32.

    CPU tensors take :func:`reference_rglru_scan_bwd`.  CUDA tensors launch
    the backward kernels on the current stream (float32, contiguous; g is
    made so); anything they do not take raises."""
    global bwd_launch_count
    _check(a, h)
    _check(a, g)
    _check_call((a, h, g), "rglru_scan_bwd")
    if a.device.type == "cpu":
        return reference_rglru_scan_bwd(a, h, g)
    g = g.float().contiguous()
    _check_launch((a, h, g), "backward")
    da, db = torch.empty_like(a), torch.empty_like(a)
    if a.numel() == 0:
        return da, db
    B, S, W = a.shape
    chunks = BWD_LIBRARY.entry("rglru_bwd_chunks")(S)
    summaries = torch.empty((2, B, chunks, W), dtype=torch.float32,
                            device=a.device)
    fn = BWD_LIBRARY.entry("rglru_scan_bwd_f32")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), h.data_ptr(), g.data_ptr(), da.data_ptr(),
                 db.data_ptr(), summaries[0].data_ptr(),
                 summaries[1].data_ptr(), B, S, W, stream)
    if err != 0:
        raise RuntimeError(f"RG-LRU backward kernel launch failed: CUDA "
                           f"error {err}")
    bwd_launch_count += 1
    return da, db


class _RGLRUScan(torch.autograd.Function):
    """The forward kernel, keeping h, and the backward kernel."""

    @staticmethod
    def forward(ctx, a, b):
        h = _launch_forward(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        da, db = rglru_scan_bwd(*ctx.saved_tensors, g)
        return (da if ctx.needs_input_grad[0] else None,
                db if ctx.needs_input_grad[1] else None)


def rglru_scan(a, b):
    """``h_t = a_t h_{t-1} + b_t`` over axis 1 from ``h_0 = 0``: (B, S, W).

    CPU tensors take :func:`reference_rglru_scan`.  CUDA tensors must be
    contiguous float32 on one device; they launch the kernel on the current
    stream, and anything the kernel does not take raises.  Where grad mode
    is on and an operand requires grad, the result carries the backward
    kernel.  Fake tensors (the dry run) take ``kernel_work.standin``.
    """
    _check(a, b)
    _check_call((a, b), "rglru_scan")
    if kernel_work.is_fake(a, b):
        key = tuple(a.shape)
        return kernel_work.standin("rglru", key, key, [(a.shape, a.dtype)],
                                   a, b)
    if a.device.type == "cpu":
        return reference_rglru_scan(a, b)
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _RGLRUScan.apply(a, b)
    return _launch_forward(a, b)
