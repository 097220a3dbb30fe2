"""Mamba-2 SSD intra-chunk terms as a CUDA kernel.

Per (batch, chunk, head), with ``cum = cumsum(-A * dt)`` over the chunk:

  * ``y = ((C B^T) o exp(cum_q - cum_k)|causal o dt_k) x``   (Q, P)
  * the chunk state ``(B o exp(cum_end - cum) o dt)^T x``   (N, P)
  * the incoming-state decay ``exp(cum)``                    (Q,)

:func:`ssd_intra_chunk` is the wrapper: x (B, nc, H, Q, P), B and C
(B, nc, Q, N), dt (B, nc, H, Q), A (H,) > 0; every output is float32.  On
CUDA tensors it launches the hand-written kernel in ``csrc/ssd.cu`` (built
with ``nvcc`` for ``sm_90a`` at first use, see :mod:`.build`) and raises if
the build or the launch fails; the kernel takes float32, the type the model
path gives it.  On CPU tensors it computes :func:`reference_ssd_intra_chunk`,
the plain PyTorch version.  Nothing here touches CUDA at import.
"""
from __future__ import annotations

import ctypes

import torch

from . import build as _build

LIBRARY = _build.KernelLibrary("ssd", {
    "ssd_intra_chunk_f32": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]})
HEAD_WIDTHS = (16, 32, 64)  # head widths P the kernel is built for
MAX_STATE = 128             # widest state N the kernel takes

# Kernel launches made by ssd_intra_chunk since the count was last set to 0.
launch_count = 0


def build():
    """Compile the kernel now (else it is built at its first launch)."""
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


def ssd_intra_chunk(x, Bm, Cm, dt, A):
    """Returns ``(y (B, nc, H, Q, P), chunk_states (B, nc, H, N, P),
    in_decay (B, nc, H, Q))``, all float32.

    CPU tensors take :func:`reference_ssd_intra_chunk`.  CUDA tensors must
    be contiguous float32 on one device, with P in ``HEAD_WIDTHS`` and N at
    most ``MAX_STATE``; they launch the kernel on the current stream, and
    anything the kernel does not take raises.
    """
    global launch_count
    _check_shapes(x, Bm, Cm, dt, A)
    operands = (x, Bm, Cm, dt, A)
    if len({t.device for t in operands}) != 1:
        raise ValueError(f"operands on different devices: "
                         f"{[str(t.device) for t in operands]}")
    if x.device.type == "cpu":
        return reference_ssd_intra_chunk(x, Bm, Cm, dt, A)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_intra_chunk runs on cuda or cpu, got "
                         f"{x.device}")
    if any(t.dtype != torch.float32 for t in operands):
        raise TypeError(f"the SSD kernel takes float32 operands, got "
                        f"{[t.dtype for t in operands]}")
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("the SSD kernel takes contiguous operands")
    Bsz, nc, H, Q, P = x.shape
    N = Bm.shape[-1]
    if P not in HEAD_WIDTHS or not 1 <= N <= MAX_STATE:
        raise ValueError(f"the SSD kernel takes P in {HEAD_WIDTHS} and N <= "
                         f"{MAX_STATE}, got P {P}, N {N}")
    y = torch.empty_like(x)
    hc = torch.empty((Bsz, nc, H, N, P), dtype=torch.float32, device=x.device)
    dec = torch.empty_like(dt)
    if x.numel() == 0:
        return y, hc, dec
    fn = LIBRARY.entry("ssd_intra_chunk_f32")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(),
                 A.data_ptr(), y.data_ptr(), hc.data_ptr(), dec.data_ptr(),
                 Bsz, nc, H, Q, P, N, stream)
    if err != 0:
        raise RuntimeError(f"SSD kernel launch failed: CUDA error {err}")
    launch_count += 1
    return y, hc, dec
