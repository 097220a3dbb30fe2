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

Where grad mode is on and an operand requires grad, the launch goes through
the autograd Function ``_ExpertMatmul``.  With an activation its forward
launches the kernel's variant that also writes Z, the bf16 rounding of the
fp32 sum before the activation, and keeps it; its backward is the
hand-written code in ``csrc/moe_gmm_bwd.cu`` (:func:`expert_matmul_bwd`),
which reads that Z: dZ = dY act'(Z) in one elementwise pass, then dX = dZ
W^T and dW = X^T dZ on two persistent GEMMs, each in bf16 from fp32 sums.
On CPU tensors autograd differentiates the plain version.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..roofline import kernel_work
from . import build as _build

LIBRARY = _build.KernelLibrary("moe_gmm", {
    "expert_matmul_bf16": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]})
BWD_LIBRARY = _build.KernelLibrary("moe_gmm_bwd", {
    "expert_matmul_bwd_bf16": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]})
ACTIVATIONS = {"none": 0, "silu": 1, "gelu": 2}  # the kernels' codes
TMA_ELEMS = 8  # bf16 elements in TMA's 16-byte row pitch: D and F are multiples

# Kernel launches made by expert_matmul since the count was last set to 0
# (forward), and by expert_matmul_bwd (backward).
launch_count = 0
bwd_launch_count = 0


def build():
    """Compile the forward kernel now (else it is built at its first
    launch)."""
    return LIBRARY.build()


def _act(t, activation: str):
    if activation == "silu":
        return t * torch.sigmoid(t)
    if activation == "gelu":
        return F.gelu(t, approximate="tanh")
    return t


def reference_expert_matmul(x, w, *, activation: str = "none",
                            dtype=torch.float32, keep_z: bool = False):
    """Plain PyTorch version: a product per expert in ``dtype`` (float32; a
    float64 witness for the backward's checks), the activation in it, then
    the cast to x's type (``ref.reference_expert_matmul`` of the JAX
    package).  With ``keep_z``, ``(out, z)``: z the product before the
    activation, cast to x's type, as the kernel keeps it under grad."""
    _check(x, w, activation)
    z = torch.einsum("ecd,edf->ecf", x.to(dtype), w.to(dtype))
    out = _act(z, activation).to(x.dtype)
    return (out, z.to(x.dtype)) if keep_z else out


def reference_expert_matmul_bwd(x, w, dy, activation: str = "none", *,
                                z=None, dtype=torch.float32):
    """The plain version of the backward: ``(dx, dw)`` for the cotangent
    ``dy`` of :func:`reference_expert_matmul`'s output.  dZ = dY act'(z)
    from the forward's pre-activation ``z`` (E, C, F), which an activation
    needs (without one, dZ = dY), then dx = dZ w^T and dw = x^T dZ, all in
    ``dtype``.  In float32 (the default) the gradients come back in x's and
    w's types; ``dtype=torch.float64`` computes in float64 from the
    operands widened to it and returns float64 (given z formed in float64
    from x and w: the witness of the exact values)."""
    _check(x, w, activation)
    if activation == "none":
        dz = dy.to(dtype)
    elif z is None:
        raise ValueError(f"the expert matmul backward with activation "
                         f"{activation!r} needs the forward's "
                         f"pre-activation z")
    else:
        with torch.enable_grad():
            zz = z.detach().to(dtype).requires_grad_()
            (dz,) = torch.autograd.grad(_act(zz, activation), zz,
                                        dy.to(dtype))
    dx = torch.einsum("ecf,edf->ecd", dz, w.to(dtype))
    dw = torch.einsum("ecd,ecf->edf", x.to(dtype), dz)
    if dtype == torch.float64:
        return dx, dw
    return dx.to(x.dtype), dw.to(w.dtype)


def _check(x, w, activation) -> None:
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {tuple(ACTIVATIONS)}, "
                         f"got {activation!r}")
    if x.ndim != 3 or w.ndim != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"x (E, C, D) and w (E, D, F) expected, got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")


def _check_call(x, w, activation, what: str) -> None:
    _check(x, w, activation)
    if x.device != w.device:
        raise ValueError(f"operands on different devices: {x.device}, "
                         f"{w.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu, got {x.device}")


def _check_launch(operands, what: str) -> None:
    """What the kernels take of CUDA operands; raises on anything else."""
    if any(t.dtype != torch.bfloat16 for t in operands):
        raise TypeError(f"the expert matmul {what} kernel takes bf16 "
                        f"operands, got {[t.dtype for t in operands]}")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError(f"the expert matmul {what} kernel takes contiguous "
                         f"operands")
    if operands[0].shape[2] == 0:
        raise ValueError(f"the expert matmul {what} kernel needs a depth "
                         f"D >= 1")


def _aligned(operands, what: str) -> None:
    if any(t.data_ptr() % 16 for t in operands):
        raise ValueError(f"the expert matmul {what} kernel takes 16-byte "
                         f"aligned operands (its TMA loads need them)")


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


def _launch_forward(x, w, activation: str, keep_z: bool = False):
    """``(out, z)`` of one forward launch: z the pre-activation that the
    kernel's KEEP_Z variant writes beside the output where ``keep_z`` is
    asked with an activation, else None (the launch without Z)."""
    global launch_count
    _check_launch((x, w), "forward")
    E, C, D = x.shape
    Fo = w.shape[2]
    with_z = keep_z and activation != "none"
    if E * C * Fo == 0:
        out = torch.empty((E, C, Fo), dtype=x.dtype, device=x.device)
        return out, (torch.empty_like(out) if with_z else None)
    xp, wp = pad_operands(x, w)
    _aligned((xp, wp), "forward")
    Dp, Fp = xp.shape[2], wp.shape[2]
    out = torch.empty((E, C, Fp), dtype=x.dtype, device=x.device)
    z = torch.empty_like(out) if with_z else None
    fn = LIBRARY.entry("expert_matmul_bf16")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(xp.data_ptr(), wp.data_ptr(), out.data_ptr(),
                 z.data_ptr() if with_z else None, E, C, Dp, Fp,
                 ACTIVATIONS[activation], stream)
    if err != 0:
        raise RuntimeError(f"expert matmul kernel launch failed: CUDA error "
                           f"{err}")
    launch_count += 1
    if Fp != Fo:
        out = out[..., :Fo].contiguous()
        z = z[..., :Fo].contiguous() if with_z else None
    return out, z


def expert_matmul_bwd(x, w, dy, activation: str = "none", z=None):
    """The gradients ``(dx (E, C, D), dw (E, D, F))`` of
    :func:`expert_matmul` at ``(x, w)`` for the cotangent ``dy`` (E, C, F)
    of its output, in x's and w's types.  ``z`` is the forward's
    pre-activation (E, C, F), which the Function ``_ExpertMatmul`` keeps
    from the forward's launch; act'(z) gives dZ.  With an activation z is
    needed on every device, and its absence raises (nothing recomputes Z).

    CPU tensors take :func:`reference_expert_matmul_bwd`.  CUDA tensors
    launch the backward kernels on the current stream (bf16, contiguous; a
    ragged D or F padded with zeros, in dy's and z's columns too, and the
    gradients sliced back; dy and z cast to bf16); anything else they do
    not take raises."""
    global bwd_launch_count
    _check_call(x, w, activation, "expert_matmul_bwd")
    E, C, D = x.shape
    Fo = w.shape[2]
    for name, t in (("dy", dy), ("z", z)):
        if t is None:
            continue
        if t.shape != (E, C, Fo):
            raise ValueError(f"{name} {(E, C, Fo)} expected, got "
                             f"{tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, the operands on "
                             f"{x.device}")
    if activation != "none" and z is None:
        raise ValueError(f"the expert matmul backward with activation "
                         f"{activation!r} needs the forward's "
                         f"pre-activation z")
    if x.device.type == "cpu":
        return reference_expert_matmul_bwd(x, w, dy, activation, z=z)
    dy = dy.to(torch.bfloat16).contiguous()
    z = (z.to(torch.bfloat16).contiguous() if activation != "none"
         else None)
    _check_launch((x, w, dy), "backward")
    if E * C * Fo == 0:
        return torch.zeros_like(x), torch.zeros_like(w)
    xp, wp = pad_operands(x, w)
    Dp, Fp = xp.shape[2], wp.shape[2]
    if Fp != Fo:
        dy = F.pad(dy, (0, Fp - Fo))
        z = F.pad(z, (0, Fp - Fo)) if z is not None else None
    dz = torch.empty_like(dy) if z is not None else None
    dx = torch.empty_like(xp)
    dw = torch.empty_like(wp)
    _aligned([t for t in (xp, wp, dy, z, dz, dx, dw) if t is not None],
             "backward")
    fn = BWD_LIBRARY.entry("expert_matmul_bwd_bf16")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(xp.data_ptr(), wp.data_ptr(), dy.data_ptr(),
                 *(t.data_ptr() if t is not None else None for t in (z, dz)),
                 dx.data_ptr(), dw.data_ptr(), E, C, Dp, Fp,
                 ACTIVATIONS[activation], stream)
    if err != 0:
        raise RuntimeError(f"expert matmul backward kernel launch failed: "
                           f"CUDA error {err}")
    bwd_launch_count += 1
    if (Dp, Fp) != (D, Fo):
        dx, dw = dx[..., :D].contiguous(), dw[:, :D, :Fo].contiguous()
    return dx, dw


class _ExpertMatmul(torch.autograd.Function):
    """The forward kernel (writing Z beside the output where there is an
    activation), and the backward kernels for both operands from that Z."""

    @staticmethod
    def forward(ctx, x, w, activation):
        ctx.activation = activation
        out, z = _launch_forward(x, w, activation, keep_z=True)
        ctx.save_for_backward(x, w, *(() if z is None else (z,)))
        return out

    @staticmethod
    def backward(ctx, dy):
        x, w, *z = ctx.saved_tensors
        dx, dw = expert_matmul_bwd(x, w, dy, activation=ctx.activation,
                                   z=z[0] if z else None)
        return (dx if ctx.needs_input_grad[0] else None,
                dw if ctx.needs_input_grad[1] else None, None)


def expert_matmul(x, w, activation: str = "none"):
    """``act(x[e] @ w[e])`` for every expert e: (E, C, F) in x's type.

    CPU tensors take :func:`reference_expert_matmul`.  CUDA tensors must be
    contiguous bf16 on one device, 16-byte aligned where D and F are
    multiples of TMA_ELEMS (else :func:`pad_operands` copies them); they
    launch the kernel on the current stream, and anything the kernel does
    not take raises.  Where grad mode is on and an operand requires grad,
    the result carries the backward kernel (and the launch also writes Z
    for it where there is an activation).  Fake tensors (the dry run) take
    ``kernel_work.standin``.
    """
    _check_call(x, w, activation, "expert_matmul")
    if kernel_work.is_fake(x, w):
        E, C, _ = x.shape
        key = (*x.shape, w.shape[2], activation)
        return kernel_work.standin("moe_gmm", key, key,
                                   [((E, C, w.shape[2]), x.dtype)], x, w)
    if x.device.type == "cpu":
        return reference_expert_matmul(x, w, activation=activation)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _ExpertMatmul.apply(x, w, activation)
    return _launch_forward(x, w, activation)[0]
