"""Per-expert (grouped) matmul with a fused activation as a CUDA kernel.

:func:`expert_matmul` is the wrapper: x (E, C, D) and w (E, D, F) give
``act(x[e] @ w[e])`` (E, C, F) in x's type, the products summed in fp32 and
the activation (``"none"``, ``"silu"``, or ``"gelu"`` in its tanh form)
applied to the fp32 sum before the one cast.  On CUDA tensors it launches
the hand-written kernel in ``csrc/moe_gmm.cu`` (built with ``nvcc`` for
``sm_90a`` at first use, see :mod:`.build`) and raises if the build or the
launch fails; the kernel takes bf16, the type the model path gives it.  On
CPU tensors it computes :func:`reference_expert_matmul`, the plain PyTorch
version, in any floating type.  Nothing here touches CUDA at import.

The kernel is a warp-specialised Hopper GEMM: one producer thread loads x
and w tiles by TMA, through 3-D tensor maps that keep every box inside one
expert, into a ring of shared-memory stages, and two consumer warpgroups
multiply them with ``wgmma`` (w MN-major through the transpose bit) into a
128 x 256 fp32 tile per block, which the epilogue activates, rounds to bf16
once and stores by TMA.  TMA needs 16-byte row pitches and base pointers,
so the kernel takes D and F that are multiples of 8 and 16-byte aligned
operands: :func:`pad_operands` pads a ragged D or F with zeros (exact zeros
in the sums), and the wrapper slices the output back and raises on a
misaligned operand.  Its times against its bound and ``torch.bmm`` at the
MoE path's shapes are in PERF.md.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build as _build

LIBRARY = _build.KernelLibrary("moe_gmm", {
    "expert_matmul_bf16": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]})
ACTIVATIONS = {"none": 0, "silu": 1, "gelu": 2}  # the kernel's codes
TMA_ELEMS = 8  # bf16 elements in TMA's 16-byte row pitch: D and F are multiples

# Kernel launches made by expert_matmul since the count was last set to 0.
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


def reference_expert_matmul(x, w, *, activation: str = "none"):
    """Plain PyTorch version: an fp32 product per expert, the activation in
    fp32, then the cast to x's type (``ref.reference_expert_matmul`` of the
    JAX package)."""
    _check(x, w, activation)
    out = torch.einsum("ecd,edf->ecf", x.float(), w.float())
    if activation == "silu":
        out = out * torch.sigmoid(out)
    elif activation == "gelu":
        out = F.gelu(out, approximate="tanh")
    return out.to(x.dtype)


def _check(x, w, activation) -> None:
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {tuple(ACTIVATIONS)}, "
                         f"got {activation!r}")
    if x.ndim != 3 or w.ndim != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"x (E, C, D) and w (E, D, F) expected, got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")


def pad_operands(x, w):
    """x (E, C, D) and w (E, D, F) with D and F padded with zeros up to
    multiples of TMA_ELEMS (the operands themselves where nothing pads).
    The zero depths add exact zeros to every sum, so the product of the
    padded operands, sliced back to F columns, is the product of x and w."""
    D, Fo = x.shape[2], w.shape[2]
    pad_d, pad_f = -D % TMA_ELEMS, -Fo % TMA_ELEMS
    if pad_d:
        x = F.pad(x, (0, pad_d))
    if pad_d or pad_f:
        w = F.pad(w, (0, pad_f, 0, pad_d))
    return x, w


def expert_matmul(x, w, activation: str = "none"):
    """``act(x[e] @ w[e])`` for every expert e: (E, C, F) in x's type.

    CPU tensors take :func:`reference_expert_matmul`.  CUDA tensors must be
    contiguous bf16 on one device, 16-byte aligned where D and F are
    multiples of TMA_ELEMS (else :func:`pad_operands` copies them); they
    launch the kernel on the current stream, and anything the kernel does
    not take raises.
    """
    global launch_count
    _check(x, w, activation)
    if x.device != w.device:
        raise ValueError(f"operands on different devices: {x.device}, "
                         f"{w.device}")
    if x.device.type == "cpu":
        return reference_expert_matmul(x, w, activation=activation)
    if x.device.type != "cuda":
        raise ValueError(f"expert_matmul runs on cuda or cpu, got {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise NotImplementedError(f"the expert matmul kernel has no backward "
                                  f"yet: {TRAINING_ITEM}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"the expert matmul kernel takes bf16 operands, got "
                        f"{x.dtype}, {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("the expert matmul kernel takes contiguous operands")
    E, C, D = x.shape
    Fo = w.shape[2]
    if D == 0:
        raise ValueError("the expert matmul kernel needs a depth D >= 1")
    if E * C * Fo == 0:
        return torch.empty((E, C, Fo), dtype=x.dtype, device=x.device)
    xp, wp = pad_operands(x, w)
    if any(t.data_ptr() % 16 for t in (xp, wp)):
        raise ValueError("the expert matmul kernel takes 16-byte aligned "
                         "operands (its TMA loads need them)")
    Dp, Fp = xp.shape[2], wp.shape[2]
    out = torch.empty((E, C, Fp), dtype=x.dtype, device=x.device)
    fn = LIBRARY.entry("expert_matmul_bf16")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(xp.data_ptr(), wp.data_ptr(), out.data_ptr(), E, C, Dp, Fp,
                 ACTIVATIONS[activation], stream)
    if err != 0:
        raise RuntimeError(f"expert matmul kernel launch failed: CUDA error "
                           f"{err}")
    launch_count += 1
    return out if Fp == Fo else out[..., :Fo].contiguous()
