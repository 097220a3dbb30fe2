"""The RG-LRU linear recurrence as a CUDA kernel.

:func:`rglru_scan` is the wrapper: a and b (B, S, W) float32 give h
(B, S, W) with ``h_t = a_t h_{t-1} + b_t`` over S from ``h_0 = 0``, every
channel on its own.  On CUDA tensors it launches the hand-written kernel in
``csrc/rglru.cu`` (built with ``nvcc`` for ``sm_90a`` at first use, see
:mod:`.build`) and raises if the build or the launch fails; the kernel takes
float32, the type the model path gives it.  On CPU tensors it computes
:func:`reference_rglru_scan`, the plain PyTorch version.  Nothing here
touches CUDA at import.
"""
from __future__ import annotations

import ctypes

import torch

from . import build as _build

LIBRARY = _build.KernelLibrary("rglru", {
    "rglru_scan_f32": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p],
    "rglru_chunks": [ctypes.c_int]})

# Kernel launches made by rglru_scan since the count was last set to 0.
launch_count = 0
# Where grad mode is on and an operand requires grad, a CUDA launch raises
# naming the ROADMAP item that brings this kernel's backward: a result
# without autograd history would cut the gradient of every parameter before
# it.  (CPU tensors take the plain version, which autograd differentiates.)
TRAINING_ITEM = ("ROADMAP A4b: MoE and RG-LRU training (the expert matmul's "
                 "and the RG-LRU scan's backward kernels)")


def build():
    """Compile the kernel now (else it is built at its first launch)."""
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


def _check(a, b) -> None:
    if a.ndim != 3 or a.shape != b.shape:
        raise ValueError(f"a and b (B, S, W) of one shape expected, got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")


def rglru_scan(a, b):
    """``h_t = a_t h_{t-1} + b_t`` over axis 1 from ``h_0 = 0``: (B, S, W).

    CPU tensors take :func:`reference_rglru_scan`.  CUDA tensors must be
    contiguous float32 on one device; they launch the kernel on the current
    stream, and anything the kernel does not take raises.
    """
    global launch_count
    _check(a, b)
    if a.device != b.device:
        raise ValueError(f"operands on different devices: {a.device}, "
                         f"{b.device}")
    if a.device.type == "cpu":
        return reference_rglru_scan(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"rglru_scan runs on cuda or cpu, got {a.device}")
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        raise NotImplementedError(f"the RG-LRU kernel has no backward yet: "
                                  f"{TRAINING_ITEM}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise TypeError(f"the RG-LRU kernel takes float32 operands, got "
                        f"{a.dtype}, {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("the RG-LRU kernel takes contiguous operands")
    out = torch.empty_like(a)
    if out.numel() == 0:
        return out
    B, S, W = a.shape
    chunks = LIBRARY.entry("rglru_chunks")(S)
    summaries = torch.empty((2, B, chunks, W), dtype=torch.float32,
                            device=a.device)
    fn = LIBRARY.entry("rglru_scan_f32")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                 summaries[0].data_ptr(), summaries[1].data_ptr(), B, S, W,
                 stream)
    if err != 0:
        raise RuntimeError(f"RG-LRU kernel launch failed: CUDA error {err}")
    launch_count += 1
    return out
