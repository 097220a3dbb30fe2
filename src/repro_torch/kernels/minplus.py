"""Tropical (min-plus) kernels for frontier composition, in CUDA.

* :func:`minplus_matmul`: ``val[..., m, n] = min_k a[..., m, k] + b[..., k,
  n]`` with ``idx`` the *first* minimising ``k`` (int32; 0 for an all-+inf
  column), the counterpart of ``repro.kernels.minplus_matmul``.  Its plain
  version is :func:`minplus_reference`.
* :func:`minplus_scan`: the whole DFTS tour relaxation of N tours in one
  launch (``core/torch_solvers.py::dfts_scan`` runs on it), the counterpart
  of the JAX package's ``dfts_scan`` with ``use_pallas=True`` (a
  ``lax.scan`` over the Pallas product).  Its plain version is
  :func:`minplus_scan_reference`, K-1 products of :func:`minplus_reference`.

On CUDA tensors each wrapper launches its hand-written kernel in
``csrc/minplus.cu`` (one library, built with ``nvcc`` for ``sm_90a`` at
first use into ``build/kernels/`` at the repository root, keyed on a hash
of the source) and raises if the build or the launch fails.  On CPU tensors
it computes its plain version, with the same semantics.  Each wrapper
counts its own launches (``launch_count``, ``scan_launch_count``).  Nothing
here touches CUDA at import.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from . import build as _build

LIBRARY = _build.KernelLibrary("minplus", {
    "minplus_f64": [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p],
    "minplus_scan_f64": [ctypes.c_void_p] * 6 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]})
SOURCE = LIBRARY.source
BUILD_DIR = _build.BUILD_DIR

# Kernel launches made by minplus_matmul since the count was last set to 0.
launch_count = 0
# Kernel launches made by minplus_scan since the count was last set to 0.
scan_launch_count = 0


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


def minplus_scan_reference(comp: torch.Tensor, D: torch.Tensor,
                           tail: torch.Tensor):
    """Plain PyTorch DFTS scan: one :func:`minplus_reference` product
    ``best[:, None, :] ∘ D_k`` per stage step, then ``+ tail``, ``amin`` and
    a first-occurrence ``argmin``.  Returns (total (N,) float64, tail_src
    (N,) int64, srcs (K-1, N, S) int32; an empty int64 (0, N, S) at K = 1,
    like the empty output of a zero-length ``lax.scan``)."""
    N, K, S = _check_scan(comp, D, tail)
    Dk = D.transpose(0, 1).contiguous()  # (K-1, N, S, S): one slab per step
    best = comp[:, 0, :]
    srcs = []
    for k in range(K - 1):
        val, idx = minplus_reference(best[:, None, :].contiguous(), Dk[k])
        best = val[:, 0, :] + comp[:, k + 1, :]
        srcs.append(idx[:, 0, :])
    tot = best + tail
    return (tot.amin(dim=1), tot.argmin(dim=1),
            torch.stack(srcs) if srcs else
            torch.empty((0, N, S), dtype=torch.int64, device=comp.device))


def _check_scan(comp: torch.Tensor, D: torch.Tensor,
                tail: torch.Tensor) -> tuple[int, int, int]:
    if comp.ndim != 3 or comp.shape[1] < 1 or comp.shape[2] < 1:
        raise ValueError(f"comp must be (N, K >= 1, S >= 1), got "
                         f"{tuple(comp.shape)}")
    N, K, S = comp.shape
    if D.shape != (N, K - 1, S, S) or tail.shape != (N, S):
        raise ValueError(f"D must be {(N, K - 1, S, S)} and tail {(N, S)} "
                         f"for comp {tuple(comp.shape)}, got "
                         f"{tuple(D.shape)} and {tuple(tail.shape)}")
    return N, K, S


def _scan_output_specs(N: int, K: int, S: int) -> tuple:
    """(shape, dtype) of :func:`minplus_scan`'s three outputs."""
    return (((N,), torch.float64), ((N,), torch.int64),
            ((K - 1, N, S), torch.int32 if K > 1 else torch.int64))


def minplus_scan(comp: torch.Tensor, D: torch.Tensor, tail: torch.Tensor, *,
                 out: tuple | None = None):
    """Batched DFTS tour relaxation of N tours in one launch.

    comp (N, K, S), D (N, K-1, S, S), tail (N, S): step k takes
    ``best <- min_j (best[j] + D[:, k, j, n]) + comp[:, k+1, n]`` from
    ``best = comp[:, 0]`` and records the first minimising j in ``srcs[k]``;
    then ``total = min (best + tail)`` and ``tail_src`` its first index.
    Returns (total (N,) float64, tail_src (N,) int64, srcs (K-1, N, S) int32
    (empty int64 at K = 1)), written into ``out`` when it is given (three
    contiguous tensors of those shapes and types, on the operands' device).
    CPU tensors take :func:`minplus_scan_reference`.  CUDA tensors must be
    contiguous float64 on one device; they launch the kernel on the current
    stream (none when N is 0), and anything the kernel does not take
    raises.
    """
    global scan_launch_count
    N, K, S = _check_scan(comp, D, tail)
    dev = comp.device
    if D.device != dev or tail.device != dev:
        raise ValueError(f"operands on different devices: {comp.device}, "
                         f"{D.device}, {tail.device}")
    specs = _scan_output_specs(N, K, S)
    if out is not None:
        if len(out) != 3 or any(
                o.shape != shape or o.dtype != dtype or o.device != dev
                or not o.is_contiguous()
                for o, (shape, dtype) in zip(out, specs)):
            raise ValueError(f"out must be three contiguous tensors on {dev} "
                             f"of (shape, dtype) {specs}")
    if dev.type == "cpu":
        got = minplus_scan_reference(comp, D, tail)
        if out is None:
            return got
        for o, g in zip(out, got):
            o.copy_(g)
        return tuple(out)
    if dev.type != "cuda":
        raise ValueError(f"minplus_scan runs on cuda or cpu, got {dev}")
    if not all(t.dtype == torch.float64 for t in (comp, D, tail)):
        raise TypeError(f"minplus scan kernel takes float64 operands, got "
                        f"{comp.dtype}, {D.dtype} and {tail.dtype}")
    if not all(t.is_contiguous() for t in (comp, D, tail)):
        raise ValueError("minplus scan kernel takes contiguous operands")
    if out is None:
        out = tuple(torch.empty(shape, dtype=dtype, device=dev)
                    for shape, dtype in specs)
    if N == 0:
        return tuple(out)
    total, tail_src, srcs = out
    fn = LIBRARY.entry("minplus_scan_f64")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(comp.data_ptr(), D.data_ptr(), tail.data_ptr(),
                 total.data_ptr(), tail_src.data_ptr(), srcs.data_ptr(), N, K,
                 S, stream)
    if err != 0:
        raise RuntimeError(f"minplus scan kernel launch failed: CUDA error "
                           f"{err}")
    scan_launch_count += 1
    return tuple(out)
