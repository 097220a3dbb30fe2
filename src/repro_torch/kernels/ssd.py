"""Mamba-2 SSD intra-chunk terms as CUDA kernels, forward and backward.

Per (batch, chunk, head), with ``cum = cumsum(-A * dt)`` over the chunk:

  * ``y = ((C B^T) o exp(cum_q - cum_k)|causal o dt_k) x``   (Q, P)
  * the chunk state ``(B o exp(cum_end - cum) o dt)^T x``   (N, P)
  * the incoming-state decay ``exp(cum)``                    (Q,)

:func:`ssd_intra_chunk` is the wrapper: x (B, nc, H, Q, P), B and C
(B, nc, Q, N), dt (B, nc, H, Q), A (H,) > 0; every output is float32.  On
CUDA tensors it launches the hand-written kernel in ``csrc/ssd.cu`` (built
with ``nvcc`` for ``sm_90a`` at first use, see :mod:`.build`) and raises if
the build or the launch fails; the kernel takes float32, the type the model
path gives it, and does its products on the tensor cores in TF32, three
products for each fp32 one, which keeps fp32 accuracy.  Where grad mode is
on and an operand requires grad, the launch goes through the autograd
Function ``_SSDIntraChunk``, whose backward is the hand-written kernel in
``csrc/ssd_bwd.cu`` (:func:`ssd_intra_chunk_bwd`, plain fp32 SIMT for now),
which maps the cotangents of all three outputs to dx, dB, dC, ddt and dA.
On CPU tensors it computes :func:`reference_ssd_intra_chunk`, the plain
PyTorch version, and autograd differentiates that.  Nothing here touches
CUDA at import.
"""
from __future__ import annotations

import ctypes

import torch

from . import build as _build

LIBRARY = _build.KernelLibrary("ssd", {
    "ssd_intra_chunk_f32": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]})
BWD_LIBRARY = _build.KernelLibrary("ssd_bwd", {
    "ssd_intra_chunk_bwd_f32": [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6
    + [ctypes.c_void_p]})
HEAD_WIDTHS = (16, 32, 64)  # head widths P the kernels are built for
MAX_STATE = 128             # widest state N the kernels take

# Kernel launches made by ssd_intra_chunk since the count was last set to 0
# (forward), and by ssd_intra_chunk_bwd (backward).
launch_count = 0
bwd_launch_count = 0


def build():
    """Compile the forward kernel now (else it is built at its first
    launch)."""
    return LIBRARY.build()


def reference_ssd_intra_chunk(x, Bm, Cm, dt, A, *, dtype=torch.float32):
    """Plain PyTorch intra-chunk terms, computed and returned in ``dtype``
    (float32, the kernel's type; float64 gives a witness of the exact
    values); the causal mask is applied to the exponent, where non-causal
    deltas are positive and would overflow."""
    _check_shapes(x, Bm, Cm, dt, A)
    x32, B32, C32, dt32 = (t.to(dtype) for t in (x, Bm, Cm, dt))
    dA = dt32 * (-A.to(dtype))[None, None, :, None]  # (B, nc, H, Q)
    cum = torch.cumsum(dA, dim=-1)
    scores = torch.einsum("bcqn,bckn->bcqk", C32, B32)
    Q = x.shape[3]
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    delta = cum[..., :, None] - cum[..., None, :]  # (B, nc, H, Q, K)
    decay = torch.exp(delta.masked_fill(~causal, float("-inf")))
    w = scores[:, :, None] * decay
    w = w * dt32[:, :, :, None, :]
    y = torch.einsum("bchqk,bchkp->bchqp", w, x32)
    end_decay = torch.exp(cum[..., -1:] - cum) * dt32  # (B, nc, H, Q)
    hc = torch.einsum("bchq,bcqn,bchqp->bchnp", end_decay, B32, x32)
    return y, hc, torch.exp(cum)


def reference_ssd_intra_chunk_bwd(x, Bm, Cm, dt, A, gy, ghc, gdec, *,
                                  dtype=torch.float32):
    """The plain version of the backward: ``(dx, dB, dC, ddt, dA)`` in
    ``dtype`` (float64 gives a witness), autograd through
    :func:`reference_ssd_intra_chunk` for the cotangents ``gy`` of y,
    ``ghc`` of the chunk states and ``gdec`` of the decay."""
    with torch.enable_grad():
        ins = [t.detach().to(dtype).requires_grad_() for t in
               (x, Bm, Cm, dt, A)]
        outs = reference_ssd_intra_chunk(*ins, dtype=dtype)
        return torch.autograd.grad(outs, ins, [g.to(dtype) for g in
                                               (gy, ghc, gdec)])


def _check_shapes(x, Bm, Cm, dt, A) -> None:
    if x.ndim != 5:
        raise ValueError(f"x (B, nc, H, Q, P) expected, got {tuple(x.shape)}")
    Bsz, nc, H, Q, _ = x.shape
    N = Bm.shape[-1] if Bm.ndim == 4 else -1
    if Bm.shape != (Bsz, nc, Q, N) or Cm.shape != Bm.shape:
        raise ValueError(f"B and C (B, nc, Q, N) = ({Bsz}, {nc}, {Q}, N) "
                         f"expected, got {tuple(Bm.shape)}, {tuple(Cm.shape)}")
    if dt.shape != (Bsz, nc, H, Q) or A.shape != (H,):
        raise ValueError(f"dt ({Bsz}, {nc}, {H}, {Q}) and A ({H},) expected, "
                         f"got {tuple(dt.shape)}, {tuple(A.shape)}")


def _check_call(operands) -> None:
    _check_shapes(*operands[:5])
    if len({t.device for t in operands}) != 1:
        raise ValueError(f"operands on different devices: "
                         f"{[str(t.device) for t in operands]}")
    if operands[0].device.type not in ("cpu", "cuda"):
        raise ValueError(f"the SSD kernels run on cuda or cpu, got "
                         f"{operands[0].device}")


def _check_launch(operands, what: str) -> None:
    """What the kernels take of CUDA operands; raises on anything else."""
    if any(t.dtype != torch.float32 for t in operands):
        raise TypeError(f"the SSD {what} kernel takes float32 operands, got "
                        f"{[t.dtype for t in operands]}")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError(f"the SSD {what} kernel takes contiguous operands")
    P, N = operands[0].shape[-1], operands[1].shape[-1]
    if P not in HEAD_WIDTHS or not 1 <= N <= MAX_STATE:
        raise ValueError(f"the SSD {what} kernel takes P in {HEAD_WIDTHS} and "
                         f"N <= {MAX_STATE}, got P {P}, N {N}")


def _launch_forward(x, Bm, Cm, dt, A):
    global launch_count
    _check_launch((x, Bm, Cm, dt, A), "forward")
    Bsz, nc, H, Q, P = x.shape
    N = Bm.shape[-1]
    y = torch.empty_like(x)
    dec = torch.empty_like(dt)
    if x.numel() == 0:
        return (y, torch.empty((Bsz, nc, H, N, P), dtype=torch.float32,
                               device=x.device), dec)
    # the kernel loads B and C by TMA, whose rows are whole 16-byte units:
    # a state width off a multiple of 4 is padded with zero columns, which
    # add nothing to C B^T and give chunk-state rows that are cut off
    N4 = -(-N // 4) * 4
    if N4 != N:
        Bm, Cm = (torch.nn.functional.pad(t, (0, N4 - N)) for t in (Bm, Cm))
    hc = torch.empty((Bsz, nc, H, N4, P), dtype=torch.float32, device=x.device)
    fn = LIBRARY.entry("ssd_intra_chunk_f32")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(),
                 A.data_ptr(), y.data_ptr(), hc.data_ptr(), dec.data_ptr(),
                 Bsz, nc, H, Q, P, N4, stream)
    if err != 0:
        raise RuntimeError(f"SSD kernel launch failed: CUDA error {err}")
    launch_count += 1
    return y, hc[..., :N, :], dec


def ssd_intra_chunk_bwd(x, Bm, Cm, dt, A, gy, ghc, gdec):
    """The gradients ``(dx, dB, dC, ddt, dA)`` of :func:`ssd_intra_chunk`
    at ``(x, B, C, dt, A)`` for the cotangents ``gy`` (B, nc, H, Q, P) of y,
    ``ghc`` (B, nc, H, N, P) of the chunk states and ``gdec`` (B, nc, H, Q)
    of the decay, all float32.

    CPU tensors take :func:`reference_ssd_intra_chunk_bwd`.  CUDA tensors
    launch the backward kernel on the current stream (float32, P in
    ``HEAD_WIDTHS``, N at most ``MAX_STATE``; the kernel reads B and C
    unpadded, so no gradient of a padded column arises); anything it does
    not take raises."""
    global bwd_launch_count
    operands = (x, Bm, Cm, dt, A)
    _check_call(operands + (gy, ghc, gdec))
    Bsz, nc, H, Q, P = x.shape
    N = Bm.shape[-1]
    if gy.shape != x.shape or ghc.shape != (Bsz, nc, H, N, P) \
            or gdec.shape != dt.shape:
        raise ValueError(f"cotangents of shapes {tuple(x.shape)}, "
                         f"{(Bsz, nc, H, N, P)}, {tuple(dt.shape)} expected, "
                         f"got {tuple(gy.shape)}, {tuple(ghc.shape)}, "
                         f"{tuple(gdec.shape)}")
    if x.device.type == "cpu":
        return reference_ssd_intra_chunk_bwd(*operands, gy, ghc, gdec)
    gy, ghc, gdec = (t.float().contiguous() for t in (gy, ghc, gdec))
    _check_launch(operands + (gy, ghc, gdec), "backward")
    grads = tuple(torch.empty_like(t) for t in operands)
    if x.numel() == 0:
        return tuple(g.zero_() for g in grads)
    fn = BWD_LIBRARY.entry("ssd_intra_chunk_bwd_f32")
    heads = Bsz * nc * H
    scratch = torch.empty(heads * (4 * Q + 1) + 2 * heads * Q * N,
                          dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(*(t.data_ptr() for t in operands + (gy, ghc, gdec) + grads),
                 scratch.data_ptr(), Bsz, nc, H, Q, P, N, stream)
    if err != 0:
        raise RuntimeError(f"SSD backward kernel launch failed: CUDA error "
                           f"{err}")
    bwd_launch_count += 1
    return grads


class _SSDIntraChunk(torch.autograd.Function):
    """The forward kernel, and the backward kernel for all three outputs'
    cotangents (an unused output's is zeros)."""

    @staticmethod
    def forward(ctx, x, Bm, Cm, dt, A):
        ctx.save_for_backward(x, Bm, Cm, dt, A)
        return _launch_forward(x, Bm, Cm, dt, A)

    @staticmethod
    def backward(ctx, gy, ghc, gdec):
        return ssd_intra_chunk_bwd(*ctx.saved_tensors, gy, ghc, gdec)


def ssd_intra_chunk(x, Bm, Cm, dt, A):
    """Returns ``(y (B, nc, H, Q, P), chunk_states (B, nc, H, N, P),
    in_decay (B, nc, H, Q))``, all float32.

    CPU tensors take :func:`reference_ssd_intra_chunk`.  CUDA tensors must
    be contiguous float32 on one device, with P in ``HEAD_WIDTHS`` and N at
    most ``MAX_STATE``; they launch the kernel on the current stream, and
    anything the kernel does not take raises.  Where grad mode is on and an
    operand requires grad, the results carry the backward kernel.
    """
    operands = (x, Bm, Cm, dt, A)
    _check_call(operands)
    if x.device.type == "cpu":
        return reference_ssd_intra_chunk(*operands)
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        return _SSDIntraChunk.apply(*operands)
    return _launch_forward(*operands)
