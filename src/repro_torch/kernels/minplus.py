"""Tropical (min-plus) product for frontier composition, as a CUDA kernel.

``val[..., m, n] = min_k a[..., m, k] + b[..., k, n]`` with ``idx`` the
*first* minimising ``k`` (int32; 0 for an all-+inf column).  The DFTS tour
relaxation (``core/torch_solvers.py::dfts_scan``) composes one stage's
frontier with the next through it.

:func:`minplus_matmul` is the wrapper.  On CUDA tensors it launches the
hand-written kernel in ``csrc/minplus.cu`` (built with ``nvcc`` for
``sm_90a`` at first use into ``build/kernels/`` at the repository root,
keyed on a hash of the source) and raises if the build or the launch fails.
On CPU tensors it computes :func:`minplus_reference`, the plain PyTorch
version with the same semantics.  Nothing here touches CUDA at import.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from . import build as _build

LIBRARY = _build.KernelLibrary("minplus", {
    "minplus_f64": [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]})
SOURCE = LIBRARY.source
BUILD_DIR = _build.BUILD_DIR

# Kernel launches made by minplus_matmul since the count was last set to 0.
launch_count = 0


def minplus_reference(a: torch.Tensor, b: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch tropical product: the (..., M, K, N) broadcast sum
    reduced over ``k`` with ``amin`` and a first-occurrence ``argmin``."""
    _check_shapes(a, b)
    cand = a[..., :, :, None] + b[..., None, :, :]  # (..., M, K, N)
    return cand.amin(dim=-2), cand.argmin(dim=-2).to(torch.int32)


def _check_shapes(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.ndim < 2 or a.ndim != b.ndim or a.shape[:-2] != b.shape[:-2]:
        raise ValueError(f"batch dims must match, got {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    if a.shape[-1] != b.shape[-2]:
        raise ValueError(f"contraction dims must match, got "
                         f"{tuple(a.shape)} vs {tuple(b.shape)}")


def build() -> Path:
    """Compile ``csrc/minplus.cu`` into ``BUILD_DIR`` unless a library
    built from the same source is already there; returns its path (what
    the build printed and took is then in ``LIBRARY.build_info``)."""
    return LIBRARY.build(BUILD_DIR)


def minplus_matmul(a: torch.Tensor, b: torch.Tensor
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched tropical product ``a (..., M, K) ∘ b (..., K, N)``.

    Returns ``(val, idx)``: ``val`` in the inputs' dtype, ``idx`` int32.  CPU
    tensors take :func:`minplus_reference`.  CUDA tensors must be
    contiguous, on one device, and float64 (the planner's type); they launch
    the kernel on the current stream, and anything the kernel does not take
    raises.
    """
    global launch_count
    _check_shapes(a, b)
    if a.device != b.device:
        raise ValueError(f"operands on different devices: {a.device} vs "
                         f"{b.device}")
    if a.device.type == "cpu":
        return minplus_reference(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"minplus_matmul runs on cuda or cpu, got {a.device}")
    if a.dtype != torch.float64 or b.dtype != torch.float64:
        raise TypeError(f"minplus kernel takes float64 operands, got "
                        f"{a.dtype} and {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("minplus kernel takes contiguous operands")
    *batch, M, K = a.shape
    N = b.shape[-1]
    val = torch.empty((*batch, M, N), dtype=a.dtype, device=a.device)
    idx = torch.empty((*batch, M, N), dtype=torch.int32, device=a.device)
    if val.numel() == 0:
        return val, idx
    nb = 1
    for d in batch:
        nb *= d
    fn = LIBRARY.entry("minplus_f64")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), val.data_ptr(), idx.data_ptr(),
                 nb, M, K, N, stream)
    if err != 0:
        raise RuntimeError(f"minplus kernel launch failed: CUDA error {err}")
    launch_count += 1
    return val, idx
