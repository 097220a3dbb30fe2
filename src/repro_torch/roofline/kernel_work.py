"""The least work of each hand-written kernel, forward and backward: one
formula of its operations and bytes from its shape key, and its bound on
one H100.  ``chip_smoke.py`` prints its bound column from these, and the dry
run (``launch/dryrun.py``) counts the kernels by them, so both read the same
formula.

Bytes count each input read once and each output written once; operations
count a multiply-add as two.  Where the work depends on the data (the
visible pairs of attention), they count what the key's masks leave.

On fake operands (``FakeTensorMode``, the dry run) each kernel wrapper
records its work here (:func:`record`, into the active :func:`recording`
sink) and returns a stand-in of its outputs' shapes and types
(:func:`standin`): an autograd Function whose backward records the backward
kernel's work.  Without it the dry run would count the plain versions'
intermediates (the plain attention's (B, H, S, S) scores are 4.3 GB a head
at 32k tokens).  Real tensors, on the CPU or the card, never come here.
"""
from __future__ import annotations

import contextlib
import contextvars

import torch

# NVIDIA's data sheet for the H100 SXM part (NVIDIA H100 80GB HBM3 at
# 700.00 W), dense rates: the rates chip_smoke.py holds the kernels to
HBM_BYTES_PER_S = 3.35e12
FP64_OPS_PER_S = 34e12    # fp64 outside the tensor cores
FP32_OPS_PER_S = 67e12    # fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12   # bf16 tensor cores
TF32_OPS_PER_S = 495e12   # TF32 tensor cores
# TF32 tensor-core products the SSD kernels do for each fp32 product
# (csrc/ssd.cu's wgmma3: lo.hi, hi.lo, hi.hi)
SSD_TF32_PASSES = 3


def bound(n_ops: float, n_bytes: float, ops_per_s: float, passes: int = 1
          ) -> tuple[float, str]:
    """(ms, "operations" or "bytes"): the larger of the operations' time
    (``passes`` products at ``ops_per_s`` for each) and the bytes' time."""
    op_ms = passes * n_ops / ops_per_s * 1e3
    byte_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return (max(op_ms, byte_ms), "operations" if op_ms >= byte_ms else
            "bytes")


# ------------------------------------------------------------ min-plus --
def minplus_work(shape) -> tuple[int, int]:
    """The product at (batch, m, k, n): a and b read once, the sums (f64)
    and first argmins (int32) written once; an add and a compare per (b,
    m, n, k)."""
    batch, m, k, n = shape
    nb = 1
    for d in batch:
        nb *= d
    return 2 * nb * m * n * k, 8 * nb * (m * k + k * n) + 12 * nb * m * n


def scan_work(key) -> tuple[int, int]:
    """The fused scan at (N, K, S): comp, D and tail read once, total,
    tail_src (int64) and srcs (int32) written once; an add and a compare
    per candidate of each step (S per output), an add of comp per output,
    and the tail's add and the last minimum's compare per candidate."""
    N, K, S = key
    n_bytes = (8 * N * (K * S + (K - 1) * S * S + S) + 16 * N
               + 4 * (K - 1) * N * S)
    n_ops = 2 * N * (K - 1) * S * S + N * (K - 1) * S + 2 * N * S
    return n_ops, n_bytes


# ------------------------------------------------------- flash attention --
def visible_pairs(Sq: int, Skv: int, causal: bool, window) -> int:
    """The (query, key) pairs the masks leave: query i sees key j where j
    <= i (causal) and i - j < window, j < Skv.  Integer arithmetic only
    (a fake mode turns tensors into shapes): the count of a query is
    linear in i between the points where a bound starts or stops
    binding, so each stretch is an arithmetic series."""

    def count(i):
        hi = min(i, Skv - 1) if causal else Skv - 1
        lo = max(0, i - window + 1) if window else 0
        return max(0, hi - lo + 1)

    w = window or 0
    cuts = sorted({0, Sq} | {c for c in (Skv - 1, Skv, w - 1, w,
                                         Skv + w - 1, Skv + w)
                             if 0 < c < Sq})
    return sum((count(a) + count(b - 1)) * (b - a) // 2
               for a, b in zip(cuts, cuts[1:]))


def flash_work(key) -> tuple[int, int]:
    """key (B, Sq, Hq, Skv, Hkv, hd, causal, window, softcap[, split]):
    q.k and p.v, a multiply-add each, over the visible pairs; q, k, v read
    and the output written once, bf16.  ``split`` n > 1: the queries are
    one of n equal slices of the sequence (a device's share), and count
    1/n of the whole sequence's pairs."""
    B, Sq, Hq, Skv, Hkv, hd, causal, window = key[:8]
    n = key[9] if len(key) > 9 else 1
    pairs = visible_pairs(Sq * n, Skv, causal, window) // n
    n_ops = 4 * B * Hq * hd * pairs
    n_bytes = 2 * (2 * B * Sq * Hq * hd + 2 * B * Skv * Hkv * hd)
    return n_ops, n_bytes


def flash_bwd_work(key) -> tuple[int, int]:
    """Five products over the visible pairs (S = Q K^T, dP = dO V^T, dV =
    P^T dO, dQ = dS K, dK = dS^T Q), 2.5 times the forward's operations;
    q, k, v, dO and lse read and dQ, dK, dV written once."""
    B, Sq, Hq, Skv, Hkv, hd = key[:6]
    n_ops = flash_work(key)[0] * 5 // 2
    q_bytes, kv_bytes = 2 * B * Sq * Hq * hd, 2 * B * Skv * Hkv * hd
    n_bytes = (2 * q_bytes + 2 * kv_bytes + 4 * B * Hq * Sq
               + q_bytes + 2 * kv_bytes)
    return n_ops, n_bytes


# ------------------------------------------------------------------ SSD --
def ssd_work(key) -> tuple[int, int]:
    """key (B, nc, H, Q, P, N): C B^T counted once per (batch, chunk), as
    the heads share it, and every product over causal pairs only; float32
    operands read and outputs written once."""
    B, nc, H, Q, P, N = key
    pairs = Q * (Q + 1) // 2
    n_ops = (2 * N * pairs * B * nc + 2 * P * pairs * B * nc * H
             + 2 * Q * N * P * B * nc * H)
    n_bytes = 4 * (B * nc * H * Q * P * 2 + 2 * B * nc * Q * N
                   + 2 * B * nc * H * Q + H + B * nc * H * N * P)
    return n_ops, n_bytes


def ssd_bwd_work(key) -> tuple[int, int]:
    """The backward's products counted as the forward's (over causal pairs;
    the head-free C B^T, dC = (sum_h dS) B and dB = (sum_h dS)^T C once per
    (batch, chunk)): C B^T, dC and dB; G = gy x^T and W^T gy per head; the
    chunk states' ghc^T B and ghc x per head.  Operands and cotangents read
    and gradients written once."""
    B, nc, H, Q, P, N = key
    pairs = Q * (Q + 1) // 2
    n_ops = (3 * 2 * N * pairs * B * nc + 2 * 2 * P * pairs * B * nc * H
             + 2 * 2 * Q * N * P * B * nc * H)
    reads = (2 * B * nc * H * Q * P + 2 * B * nc * Q * N
             + 2 * B * nc * H * Q + H + B * nc * H * N * P)
    writes = B * nc * H * Q * P + 2 * B * nc * Q * N + B * nc * H * Q + H
    return n_ops, 4 * (reads + writes)


# ------------------------------------------------------- expert matmul --
def gmm_work(key) -> tuple[int, int]:
    """key (E, C, D, F, activation): every row of the buffers, filled or
    not, 2 E C D F operations; x and w read and the output written once,
    bf16."""
    E, C, D, F_, _ = key
    return 2 * E * C * D * F_, 2 * (E * C * D + E * D * F_ + E * C * F_)


def gmm_bwd_work(key) -> tuple[int, int]:
    """dX = dZ W^T and dW = X^T dZ, 2 E C D F operations each; x, w, dY
    and, with an activation, the forward's Z read once, dX and dW written
    once."""
    E, C, D, F_, act = key
    n_bytes = 2 * (2 * E * C * D + 2 * E * D * F_ + E * C * F_
                   + (E * C * F_ if act != "none" else 0))
    return 4 * E * C * D * F_, n_bytes


# ---------------------------------------------------------------- RG-LRU --
def rglru_work(key) -> tuple[int, int]:
    """key (B, S, W): a and b read and h written once, float32; a
    multiply-add per element."""
    n = key[0] * key[1] * key[2]
    return 2 * n, 12 * n


def rglru_bwd_work(key) -> tuple[int, int]:
    """a, h and g read and da and db written once; an add and two
    multiplies per element."""
    n = key[0] * key[1] * key[2]
    return 3 * n, 20 * n


# The rate each kernel's operations run at on the card, and the products
# it does for each
RATES = {
    "minplus": (FP64_OPS_PER_S, 1), "minplus_scan": (FP64_OPS_PER_S, 1),
    "flash_attention": (BF16_OPS_PER_S, 1),
    "flash_attention_bwd": (BF16_OPS_PER_S, 1),
    "ssd": (TF32_OPS_PER_S, SSD_TF32_PASSES),
    "ssd_bwd": (TF32_OPS_PER_S, SSD_TF32_PASSES),
    "moe_gmm": (BF16_OPS_PER_S, 1), "moe_gmm_bwd": (BF16_OPS_PER_S, 1),
    "rglru": (FP32_OPS_PER_S, 1), "rglru_bwd": (FP32_OPS_PER_S, 1),
}
WORK = {
    "minplus": minplus_work, "minplus_scan": scan_work,
    "flash_attention": flash_work, "flash_attention_bwd": flash_bwd_work,
    "ssd": ssd_work, "ssd_bwd": ssd_bwd_work,
    "moe_gmm": gmm_work, "moe_gmm_bwd": gmm_bwd_work,
    "rglru": rglru_work, "rglru_bwd": rglru_bwd_work,
}


def kernel_bound(kernel: str, key) -> tuple[float, str, int, int]:
    """(ms, bound_by, operations, bytes) of one launch of ``kernel`` at
    ``key`` on one H100."""
    n_ops, n_bytes = WORK[kernel](key)
    ms, by = bound(n_ops, n_bytes, *RATES[kernel])
    return ms, by, n_ops, n_bytes


# ------------------------------------------------------------ stand-ins --
_SINK: contextvars.ContextVar = contextvars.ContextVar("kernel_work_sink",
                                                      default=None)
_QUERY_SPLIT: contextvars.ContextVar = contextvars.ContextVar(
    "kernel_work_query_split", default=1)


@contextlib.contextmanager
def query_split(n: int):
    """The flash stand-ins inside see one of ``n`` equal slices of the
    queries (a device's share of a sequence split over ranks)."""
    tok = _QUERY_SPLIT.set(n)
    try:
        yield
    finally:
        _QUERY_SPLIT.reset(tok)


def flash_key(q, k, causal, window, softcap) -> tuple:
    """The work key of :func:`flash_work` of q (B, Sq, Hq, hd), k (B, Skv,
    Hkv, hd), with the active :func:`query_split`."""
    key = (*q.shape[:3], k.shape[1], k.shape[2], q.shape[3], causal, window,
           softcap)
    n = _QUERY_SPLIT.get()
    return key + (n,) if n != 1 else key


@contextlib.contextmanager
def recording(sink):
    """Sends the work of every stand-in launched inside to
    ``sink(kernel, key, n_ops, n_bytes)``."""
    tok = _SINK.set(sink)
    try:
        yield
    finally:
        _SINK.reset(tok)


def record(kernel: str, key) -> None:
    sink = _SINK.get()
    if sink is not None:
        n_ops, n_bytes = WORK[kernel](key)
        sink(kernel, key, n_ops, n_bytes)


def is_fake(*tensors) -> bool:
    """Any of ``tensors`` is a fake tensor (``FakeTensorMode``)."""
    from torch._subclasses.fake_tensor import is_fake as _fake

    return any(isinstance(t, torch.Tensor) and _fake(t) for t in tensors)


class _StandIn(torch.autograd.Function):
    """Records the forward kernel's work and returns empty outputs of its
    shapes and types; the backward records the backward kernel's and
    returns empty gradients of the inputs'."""

    @staticmethod
    def forward(ctx, kernel, key, bwd, out_specs, *inputs):
        record(kernel, key)
        ctx.bwd = bwd
        ctx.specs = [(t.shape, t.dtype) if isinstance(t, torch.Tensor)
                     else None for t in inputs]
        ref = next(t for t in inputs if isinstance(t, torch.Tensor))
        outs = tuple(ref.new_empty(shape, dtype=dtype)
                     for shape, dtype in out_specs)
        return outs if len(outs) > 1 else outs[0]

    @staticmethod
    def backward(ctx, *grads):
        if ctx.bwd is not None:
            record(*ctx.bwd)
        ref = next(g for g in grads if g is not None)
        return (None, None, None, None) + tuple(
            None if spec is None or not ctx.needs_input_grad[4 + i]
            else ref.new_empty(spec[0], dtype=spec[1])
            for i, spec in enumerate(ctx.specs))


def standin(kernel: str, key, bwd_key, out_specs, *inputs):
    """The outputs (``out_specs``: (shape, dtype) each) of one launch of
    ``kernel`` at ``key`` on fake ``inputs``, its work recorded; under
    autograd, the backward records ``kernel + "_bwd"`` at ``bwd_key``."""
    bwd = (kernel + "_bwd", bwd_key) if bwd_key is not None else None
    return _StandIn.apply(kernel, key, bwd, list(out_specs), *inputs)
