"""The kernels' entry points, as the JAX package's ``kernels/ops.py`` has
them: ``flash_attention``, ``expert_matmul``, ``rglru_scan`` and
``ssd_intra_chunk`` as they are,
and ``ssd_forward``, the composed SSD forward: the intra-chunk kernel plus
the inter-chunk recurrence, a short sequential loop over chunks in plain
PyTorch (the JAX package leaves it to ``lax.scan``)."""
from __future__ import annotations

import torch

from .flash_attention import flash_attention
from .moe_gmm import expert_matmul
from .rglru import rglru_scan
from .ssd import ssd_intra_chunk

__all__ = ["flash_attention", "expert_matmul", "rglru_scan",
           "ssd_intra_chunk", "ssd_forward"]


def ssd_forward(xh, dtv, A, Bm, Cm, h0=None, chunk: int = 256):
    """Full SSD layer forward through :func:`ssd_intra_chunk`.

    xh (B, S, H, P); dtv (B, S, H), already through softplus; A (H,)
    positive rates; Bm, Cm (B, S, N).  Returns ``(y (B, S, H, P) float32,
    h_last (B, H, P, N) float32)``.  The chunk states come out of the kernel
    as (N, P) and are carried as (P, N), the model layer's layout.
    """
    Bsz, S, H, P = xh.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    nc = S // Q
    if nc * Q != S:
        raise ValueError(f"the chunk {Q} must divide the sequence length {S}")
    xk = xh.reshape(Bsz, nc, Q, H, P).movedim(3, 2).contiguous()
    dtk = dtv.reshape(Bsz, nc, Q, H).movedim(3, 2).contiguous()
    Bc = Bm.reshape(Bsz, nc, Q, N).contiguous()
    Cc = Cm.reshape(Bsz, nc, Q, N).contiguous()
    y_intra, chunk_states, in_decay = ssd_intra_chunk(xk, Bc, Cc, dtk,
                                                      A.contiguous())

    # h_c = decay_c * h_{c-1} + S_c, keeping the state before each chunk
    chunk_decay = in_decay[..., -1]  # (B, nc, H)
    h = (h0.float() if h0 is not None
         else torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                          device=xh.device))
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = (h * chunk_decay[:, c, :, None, None]
             + chunk_states[:, c].transpose(-1, -2))
    h_prev = torch.stack(h_prevs, dim=1)  # (B, nc, H, P, N)
    y_inter = torch.einsum("bcqn,bchq,bchpn->bchqp", Cc.float(), in_decay,
                           h_prev)
    y = (y_intra + y_inter).movedim(2, 3).reshape(Bsz, S, H, P)
    return y, h
