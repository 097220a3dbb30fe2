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
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parent / "csrc" / "minplus.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# Kernel launches made by minplus_matmul since the count was last set to 0.
launch_count = 0
# What the last build of the library printed and took (seconds); None until
# the library is first loaded in this process.
build_info: dict | None = None

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


def _nvcc() -> Path:
    """``$CUDA_HOME/bin/nvcc``, else the ``nvcc`` on the PATH, else the
    toolkit's default place."""
    if "CUDA_HOME" in os.environ:
        return Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"
    found = shutil.which("nvcc")
    return Path(found) if found else Path("/usr/local/cuda/bin/nvcc")


def build() -> Path:
    """Compile ``csrc/minplus.cu`` into ``build/kernels/`` unless a library
    built from the same source is already there; returns its path."""
    global build_info
    src = SOURCE.read_bytes()
    out = BUILD_DIR / f"minplus_{hashlib.sha256(src).hexdigest()[:16]}.so"
    if out.exists():
        build_info = {"seconds": 0.0, "log": "", "path": str(out)}
        return out
    nvcc = _nvcc()
    if not nvcc.is_file():
        raise RuntimeError(f"nvcc not found at {nvcc}: the minplus kernel "
                           f"needs the CUDA toolkit (set CUDA_HOME)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    t0 = time.perf_counter()
    proc = subprocess.run([str(nvcc), *NVCC_FLAGS, "-o", str(tmp),
                           str(SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed to build {SOURCE}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    build_info = {"seconds": time.perf_counter() - t0,
                  "log": proc.stdout + proc.stderr, "path": str(out)}
    return out


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.minplus_f64.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.minplus_f64.restype = ctypes.c_int
    return lib


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
    fn = _lib().minplus_f64
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), val.data_ptr(), idx.data_ptr(),
                 nb, M, K, N, stream)
    if err != 0:
        raise RuntimeError(f"minplus kernel launch failed: CUDA error {err}")
    launch_count += 1
    return val, idx
