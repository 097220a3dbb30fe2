"""Batched PyTorch solver core: ``dfts_torch`` / ``bcd_torch`` / ``dfts_np``.

The scalar solvers (dfts.py, segmentation.py, bcd.py) walk Python dicts per
stage; this module runs the *same* recurrences as dense tensor programs on a
device (the card by default, the CPU when the caller passes
``device="cpu"``):

* the DFTS tour relaxation is a min-plus composition of per-stage frontier
  matrices, the whole scan of N tours (every stage, the tail, the minimum
  and its first argmin) in one launch of
  ``repro_torch.kernels.minplus.minplus_scan`` (the CUDA kernel on the
  card, its plain version on the CPU); the tour loops are generators, and
  `_run_tours` runs the tours of many instances in lockstep waves, one scan
  per (K, S) group of a wave;
* the K-sequence segmentation DPs (seq and bottleneck-capped pipe variants)
  are loops over segment count of torch ``min``/``argmin``/``where`` on dense
  (e2, e[, tau]) transition tensors; the round-trip training variants
  (mode=TR, schedule=pipe, M > 1 -- docs/training.md) reuse the same scans
  under per-direction (F, B) cap scans mirroring dfts._dfts_pipe_tr and
  segmentation._run_k_seq_pipe_tr.

Bit-parity contract (tests/test_torch_solvers.py): every encoded cost uses
the exact same IEEE-754 operations in the same order as the scalar oracles,
+inf marks infeasible/padded entries (absorbing under min-plus), every
argmin is first-occurrence, and every tensor is float64 -- so plans,
latencies, and BCD trajectories are bit-identical to the NumPy solvers, not
merely close.  Padding (candidate sets to a power-of-two S, batches to a
power-of-two N with all-inf dummies, tau grids to a power-of-two T) can
therefore never change a result.

The host side (encode, decode, memos, control flow) is NumPy; only the DP
scans run on the device, and no memo holds a device tensor.
"""
from __future__ import annotations

import functools
import time
from dataclasses import replace
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from ..kernels.minplus import minplus_scan

from .costmodel import (BW, FW, PIPE, SEQ, TR, ModelProfile, dirs_for_mode,
                        even_split)
from .dfts import _stage_path, dfts
from .engine import register_solver
from .network import PhysicalNetwork, transmission_time_s
from .plan import (EvalCache, LatencyBreakdown, Plan, PlanEvaluator,
                   ServiceChainRequest)
from .problem import ProblemInstance, SolveResult

INF = float("inf")

# ----------------------------------------------------------------- memo tables
# All memos key on *content* (net.content_key() / profile.content_key()), so
# they are safe across distinct-but-equal objects and are never invalidated by
# mutation (a mutated network has a new content key).  Bounded: cleared
# wholesale past _MEMO_CAP entries — they are caches, not state.
_MEMO_CAP = 4096
_ENCODE_MEMO: dict = {}   # (inst key, segments) -> _EncodedSeq
_GRID_MEMO: dict = {}     # (net, profile, b, mode, node) -> (L+1, L+1) grid
_SHIP_MEMO: dict = {}     # per-path cut-shipping vectors (seq segmentation)
_PATH_MEMO: dict = {}     # (net, src, dst, fw, bw, cap, scale) -> path tuple
_PATHCOST_MEMO: dict = {}  # (net, path, fw, bw) -> (trans, prop, max link)
_NODEVEC_MEMO: dict = {}  # (net, b) -> per-node coefficient arrays
_PROFILE_MEMO: dict = {}  # (profile, mode) -> dense cumsum/peak tables
_PLAN_MEMO: dict = {}     # (enc key, scan output, cap, scale) -> (Plan, lb)


def _memo_put(memo: dict, key, val):
    if len(memo) >= _MEMO_CAP:
        memo.clear()
    memo[key] = val
    return val


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _inst_key(net: PhysicalNetwork, profile: ModelProfile,
              request: ServiceChainRequest, cands) -> tuple:
    # fast path: engine-canonical candidates are already tuple-of-tuples
    if not (type(cands) is tuple
            and (not cands or type(cands[0]) is tuple)):
        cands = tuple(tuple(c) for c in cands)
    return (net.content_key(), profile.content_key(), request, cands)


# ------------------------------------------------------------- device scans
def resolve_device(device: str | torch.device) -> torch.device:
    """The device a solve (or a model) runs on: what the caller names,
    ``"cuda"`` by default.  Without a usable card a CUDA device raises -- the
    port never falls back to the CPU unless the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the port runs on cuda or cpu, got {dev}")
    return dev


def _stack(rows: list[torch.Tensor], empty_shape: tuple,
           device: torch.device) -> torch.Tensor:
    """``torch.stack(rows)``, or an empty int64 tensor when there are no
    steps (K = 1), like the empty output of a zero-length ``lax.scan``."""
    if rows:
        return torch.stack(rows)
    return torch.empty(empty_shape, dtype=torch.int64, device=device)


def dfts_scan(comp: torch.Tensor, D: torch.Tensor, tail: torch.Tensor, *,
              out: tuple | None = None):
    """Batched DFTS tour relaxation: one launch of the fused min-plus scan
    kernel (``repro_torch.kernels.minplus.minplus_scan``; its plain version
    on CPU tensors).

    comp (N, K, S): per-stage candidate compute (+inf infeasible/padded),
    already cap-filtered and 1/M-scaled by the caller for capped tours.
    D (N, K-1, S, S): frontier matrix of stage k-1 sources x stage k
    targets.  tail (N, S): last-stage candidate -> destination frontier.
    Returns (total (N,), tail_src (N,), srcs (K-1, N, S)), written into
    ``out`` when it is given.
    """
    return minplus_scan(comp, D, tail, out=out)


def kseq_scan(scost: torch.Tensor, valid: torch.Tensor):
    """Sequential K-sequence segmentation DP.

    scost (K, L+1, L+1): scost[k, e2, e] = segcost(stage k, lo=e2+1,
    hi=e) (+inf infeasible); valid (K, L+1): admissible e per stage.
    Returns (dp_K (L+1,), choices (K-1, L+1)) with first-argmin choices,
    matching the oracle's first-strict-improvement update.
    """
    K, Lp1 = scost.shape[0], scost.shape[1]
    ar = torch.arange(Lp1, device=scost.device)
    tri = ar[:, None] < ar[None, :]
    dp = torch.where(valid[0], scost[0, 0, :], INF)
    choices = []
    for k in range(1, K):
        cand = torch.where(tri, dp[:, None] + scost[k], INF)
        choices.append(cand.argmin(dim=0))
        dp = torch.where(valid[k], cand.amin(dim=0), INF)
    return dp, _stack(choices, (0, Lp1), scost.device)


def kseq_pipe_scan(sfill: torch.Tensor, ssmax: torch.Tensor,
                   valid: torch.Tensor, taus: torch.Tensor):
    """Pipelined segmentation DP, vectorized over bottleneck caps.

    sfill/ssmax (K, L+1, L+1): fill cost and stage-time max of segment
    (lo=e2+1, hi=e) per stage; valid (K, L+1); taus (T,) candidate caps
    (+inf padded).  dp[k, e, t] considers only segments with stage time
    <= taus[t].  Returns (dp_K (L+1, T), choices (K-1, L+1, T)).
    """
    K, Lp1 = sfill.shape[0], sfill.shape[1]
    ar = torch.arange(Lp1, device=sfill.device)
    tri = ar[:, None] < ar[None, :]
    dp = torch.where(
        valid[0][:, None] & (taus[None, :] >= ssmax[0, 0, :, None]),
        sfill[0, 0, :, None], INF)
    choices = []
    for k in range(1, K):
        segc = torch.where(taus[None, None, :] >= ssmax[k][:, :, None],
                           sfill[k][:, :, None], INF)  # (e2, e, T)
        cand = torch.where(tri[:, :, None], dp[:, None, :] + segc, INF)
        choices.append(cand.argmin(dim=0))
        dp = torch.where(valid[k][:, None], cand.amin(dim=0), INF)
    return dp, _stack(choices, (0, Lp1, taus.shape[0]), sfill.device)


def _to(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``, keeping its dtype (float64 or bool)."""
    return torch.from_numpy(x).to(device)


# --------------------------------------------------------------- dense encode
def _node_vectors(net: PhysicalNetwork, b: int) -> SimpleNamespace:
    """Per-node compute/capacity coefficient arrays in node_index order."""
    key = (net.content_key(), b)
    hit = _NODEVEC_MEMO.get(key)
    if hit is not None:
        return hit
    names = sorted(net.nodes)
    n = len(names)
    a = np.empty(n)
    beta = np.empty(n)
    tau = np.empty(n)
    mem = np.empty(n)
    disk = np.empty(n)
    for i, name in enumerate(names):
        spec = net.nodes[name]
        ak, bk = spec.compute._coeffs(b)
        a[i], beta[i] = ak, bk
        # exactly ComputeModel.tau_s
        tau[i] = max(0.0, (spec.compute.alpha_tau * b
                           + spec.compute.beta_tau)) / 1e3
        mem[i], disk[i] = spec.mem_capacity, spec.disk_capacity
    return _memo_put(_NODEVEC_MEMO, key, SimpleNamespace(
        a=a, beta=beta, tau=tau, mem=mem, disk=disk))


def _profile_tables(profile: ModelProfile, mode: str) -> SimpleNamespace:
    """Dense prefix-sum / peak-smashed tables mirroring ModelProfile exactly.

    The cumsum arrays are numpy views of the profile's own python-float
    prefix sums, so ``c[hi] - c[lo-1]`` is the same subtraction of the same
    doubles the scalar ``seg_*`` methods perform.
    """
    key = (profile.content_key(), mode)
    hit = _PROFILE_MEMO.get(key)
    if hit is not None:
        return hit
    cum = profile._cumsums()
    L = profile.L
    cfw = np.asarray(cum[(FW, "flops")])
    cbw = np.asarray(cum[(BW, "flops")])
    cmem = np.asarray(cum["mem"])
    cdisk = np.asarray(cum["disk"])
    m = np.asarray([max(layer.smashed_bytes(d) for d in dirs_for_mode(mode))
                    for layer in profile.layers])
    # peak[lo, hi] = max(m[lo-1 .. hi-1]); IEEE max is order-independent,
    # matching seg_peak_smashed's running max.
    peak = np.zeros((L + 1, L + 1))
    for lo in range(1, L + 1):
        peak[lo, lo:] = np.maximum.accumulate(m[lo - 1:])

    def seg_grid(c):
        lo = np.arange(L + 1)
        return c[None, :] - c[np.maximum(lo - 1, 0)][:, None]  # [lo, hi]

    out = SimpleNamespace(L=L, phi_fw=seg_grid(cfw), phi_bw=seg_grid(cbw),
                          mem=seg_grid(cmem), disk=seg_grid(cdisk), peak=peak)
    return _memo_put(_PROFILE_MEMO, key, out)


def _comp_fits_grid(net: PhysicalNetwork, profile: ModelProfile,
                    request: ServiceChainRequest, node: str) -> np.ndarray:
    """(L+1, L+1) grid [lo, hi] of segment_comp_s at ``node`` (+inf where
    segment_fits fails or lo > hi).  Bit-equal to the EvalCache entries."""
    b = request.batch_size
    key = (net.content_key(), profile.content_key(), b, request.mode, node)
    hit = _GRID_MEMO.get(key)
    if hit is not None:
        return hit
    pt = _profile_tables(profile, request.mode)
    spec = net.nodes[node]
    a, beta = spec.compute._coeffs(b)
    tau = max(0.0, (spec.compute.alpha_tau * b + spec.compute.beta_tau)) / 1e3
    # total = (kappa_fw + tau) [+ (kappa_bw + tau)] — the oracle's 0.0 + FW
    # + BW accumulation order.
    comp = np.maximum(0.0, (a * b + beta) * pt.phi_fw) / 1e3 + tau
    if request.mode == TR:
        comp = comp + (np.maximum(0.0, (a * b + beta) * pt.phi_bw) / 1e3 + tau)
    mem_load = pt.mem + b * pt.peak  # mem += b * peak
    fits = (pt.disk <= spec.disk_capacity) & (mem_load <= spec.mem_capacity)
    grid = np.where(fits, comp, INF)
    lo = np.arange(pt.L + 1)
    grid[(lo[:, None] > lo[None, :]) | (lo[:, None] < 1)] = INF
    grid.setflags(write=False)
    return _memo_put(_GRID_MEMO, key, grid)


def _comp_fits_grid_dir(net: PhysicalNetwork, profile: ModelProfile,
                        request: ServiceChainRequest, node: str,
                        direction: str) -> np.ndarray:
    """(L+1, L+1) grid [lo, hi] of ``trainpipe.segment_comp_dir_s`` at
    ``node`` (+inf where segment_fits fails or lo > hi) — the per-direction
    twin of `_comp_fits_grid`, keyed with the direction appended (the 6-tuple
    is length-disjoint from the fused 5-tuple keys in the shared memo)."""
    b = request.batch_size
    key = (net.content_key(), profile.content_key(), b, request.mode, node,
           direction)
    hit = _GRID_MEMO.get(key)
    if hit is not None:
        return hit
    pt = _profile_tables(profile, request.mode)
    spec = net.nodes[node]
    a, beta = spec.compute._coeffs(b)
    tau = max(0.0, (spec.compute.alpha_tau * b + spec.compute.beta_tau)) / 1e3
    phi = pt.phi_fw if direction == FW else pt.phi_bw
    comp = np.maximum(0.0, (a * b + beta) * phi) / 1e3 + tau
    mem_load = pt.mem + b * pt.peak
    fits = (pt.disk <= spec.disk_capacity) & (mem_load <= spec.mem_capacity)
    grid = np.where(fits, comp, INF)
    lo = np.arange(pt.L + 1)
    grid[(lo[:, None] > lo[None, :]) | (lo[:, None] < 1)] = INF
    grid.setflags(write=False)
    return _memo_put(_GRID_MEMO, key, grid)


class _EncodedSeq(SimpleNamespace):
    """Dense arrays of one (instance, segments) DFTS tour: comp (K, Sp),
    D (K-1, Sp, Sp), tail (Sp,), plus cut_sizes/cands/tail_bw metadata."""


def _encode_seq(net: PhysicalNetwork, profile: ModelProfile,
                request: ServiceChainRequest, K: int, cands,
                segments) -> _EncodedSeq:
    if not (type(segments) is tuple
            and (not segments or type(segments[0]) is tuple)):
        segments = tuple(tuple(s) for s in segments)
    key = (_inst_key(net, profile, request, cands), segments)
    hit = _ENCODE_MEMO.get(key)
    if hit is not None:
        return hit
    cands = [list(c) for c in cands]
    b = request.batch_size
    training = request.mode == TR
    round_trip = (training and request.schedule == PIPE
                  and request.microbatches() > 1)
    idx = net.node_index()
    Sp = _pow2(max(len(c) for c in cands))
    comp = np.full((K, Sp), INF)
    comp_fw = comp_bw = None
    if round_trip:
        comp_fw = np.full((K, Sp), INF)
        comp_bw = np.full((K, Sp), INF)
    for k, (lo, hi) in enumerate(segments):
        # one memoized grid per node: gather the (lo, hi) scalar per candidate
        comp[k, :len(cands[k])] = [
            _comp_fits_grid(net, profile, request, n)[lo, hi]
            for n in cands[k]]
        if round_trip:
            comp_fw[k, :len(cands[k])] = [
                _comp_fits_grid_dir(net, profile, request, n, FW)[lo, hi]
                for n in cands[k]]
            comp_bw[k, :len(cands[k])] = [
                _comp_fits_grid_dir(net, profile, request, n, BW)[lo, hi]
                for n in cands[k]]
    cut_sizes: list[tuple[float, float | None]] = [(0.0, None)] * K
    D = np.full((K - 1, Sp, Sp), INF)
    for k in range(1, K):
        cut = segments[k - 1][1]
        fw = b * profile.cut_bytes(cut, FW)
        bw = b * profile.cut_bytes(cut, BW) if training else None
        cut_sizes[k] = (fw, bw)
        Dfull = net.frontier_matrix(tuple(cands[k - 1]), fw, bw)
        cols = [idx[n] for n in cands[k]]
        D[k - 1, :len(cands[k - 1]), :len(cands[k])] = Dfull[:, cols]
    tail_bw = 0.0 if training else None
    tail = np.full(Sp, INF)
    tail_mat = net.frontier_matrix(tuple(cands[K - 1]), 0.0, tail_bw)
    tail[:len(cands[K - 1])] = tail_mat[:, idx[request.destination]]
    enc = _EncodedSeq(comp=comp, comp_fw=comp_fw, comp_bw=comp_bw, D=D,
                      tail=tail, cut_sizes=cut_sizes, cands=cands,
                      segments=segments, tail_bw=tail_bw, Sp=Sp, key=key)
    return _memo_put(_ENCODE_MEMO, key, enc)


# --------------------------------------------------------- decode + fast eval
def _stage_path_memo(net: PhysicalNetwork, src: str, dst: str, fw: float,
                     bw: float | None, cap: float | None = None,
                     scale: float = 1.0,
                     cap_bw: float | None = None) -> tuple:
    key = (net.content_key(), src, dst, fw, bw, cap, scale, cap_bw)
    hit = _PATH_MEMO.get(key)
    if hit is None:
        hit = _memo_put(_PATH_MEMO, key,
                        tuple(_stage_path(net, src, dst, fw, bw, cap, scale,
                                          cap_bw)))
    return hit


def _path_cost(net: PhysicalNetwork, path: tuple, fw: float,
               bw: float | None) -> tuple[float, float, float]:
    """(transmission, propagation, max single-link transmission) of a path —
    computed by the network's own exact functions, memoized by content."""
    key = (net.content_key(), path, fw, bw)
    hit = _PATHCOST_MEMO.get(key)
    if hit is None:
        trans, prop = net.path_cost_breakdown(list(path), fw, bw)
        maxlink = 0.0
        for u, v in zip(path, path[1:]):
            maxlink = max(maxlink, net.link_trans_s(u, v, fw, bw))
        hit = _memo_put(_PATHCOST_MEMO, key, (trans, prop, maxlink))
    return hit


def _path_dir_vectors(net: PhysicalNetwork, path: tuple, size_bytes: float,
                      direction: str) -> tuple[tuple, tuple]:
    """Per-link (transmission times, propagation delays) of shipping
    ``size_bytes`` along ``path`` in one direction, in link order — the
    round-trip evaluator accumulates per link, so the memo keeps the vectors
    (the direction string keeps keys disjoint from `_path_cost` entries)."""
    key = (net.content_key(), path, size_bytes, direction)
    hit = _PATHCOST_MEMO.get(key)
    if hit is None:
        ts, ds = [], []
        for u, v in zip(path, path[1:]):
            link = net.links[(u, v)]
            ts.append(transmission_time_s(size_bytes, link.rate(direction)))
            ds.append(link.delay(direction))
        hit = _memo_put(_PATHCOST_MEMO, key, (tuple(ts), tuple(ds)))
    return hit


def _plan_comp_vals(net: PhysicalNetwork, profile: ModelProfile,
                    request: ServiceChainRequest, plan: Plan) -> list[float]:
    return [float(_comp_fits_grid(net, profile, request, node)[lo, hi])
            for (lo, hi), node in zip(plan.segments, plan.placement)]


def _plan_comp_vals_dir(net: PhysicalNetwork, profile: ModelProfile,
                        request: ServiceChainRequest, plan: Plan,
                        direction: str) -> list[float]:
    return [float(_comp_fits_grid_dir(net, profile, request, node,
                                      direction)[lo, hi])
            for (lo, hi), node in zip(plan.segments, plan.placement)]


def _fast_evaluate(net: PhysicalNetwork, profile: ModelProfile,
                   request: ServiceChainRequest, plan: Plan) -> LatencyBreakdown:
    """PlanEvaluator.evaluate, bit-for-bit, from memoized components."""
    b = request.batch_size
    training = request.mode == TR
    if (training and request.schedule == PIPE
            and request.microbatches() > 1):
        return _fast_evaluate_round_trip(net, profile, request, plan)
    comp_vals = _plan_comp_vals(net, profile, request, plan)
    if request.schedule == PIPE:
        M = request.microbatches()
        comp_s = trans_s = prop_s = 0.0
        tau = 0.0
        for t in comp_vals:
            comp_s += t / M
            tau = max(tau, t)
        for k, path in enumerate(plan.paths):
            cut = plan.segments[k][1]
            fw = b * profile.cut_bytes(cut, FW)
            bw = b * profile.cut_bytes(cut, BW) if training else None
            trans, prop, ml = _path_cost(net, tuple(path), fw, bw)
            trans_s += trans / M
            prop_s += prop
            tau = max(tau, ml)
        if plan.tail_path:
            _, prop, _ = _path_cost(net, tuple(plan.tail_path), 0.0, None)
            prop_s += prop
        return LatencyBreakdown(comp_s, trans_s, prop_s, (M - 1) * tau / M)
    comp_s = trans_s = prop_s = 0.0
    for t in comp_vals:
        comp_s += t
    for k, path in enumerate(plan.paths):
        cut = plan.segments[k][1]
        fw = b * profile.cut_bytes(cut, FW)
        bw = b * profile.cut_bytes(cut, BW) if training else None
        trans, prop, _ = _path_cost(net, tuple(path), fw, bw)
        trans_s += trans
        prop_s += prop
    if plan.tail_path:
        _, prop, _ = _path_cost(net, tuple(plan.tail_path), 0.0, None)
        prop_s += prop
    return LatencyBreakdown(comp_s, trans_s, prop_s)


def _fast_evaluate_round_trip(net: PhysicalNetwork, profile: ModelProfile,
                              request: ServiceChainRequest,
                              plan: Plan) -> LatencyBreakdown:
    """``trainpipe.evaluate_round_trip``, bit-for-bit, from memoized
    components — the same per-link / per-stage accumulation order (forward
    wave, psi_K = 0 tail, backward wave), so totals are identical doubles."""
    b = request.batch_size
    M = request.microbatches()
    comp_s = trans_s = prop_s = 0.0
    tau_fw = tau_bw = 0.0
    for t in _plan_comp_vals_dir(net, profile, request, plan, FW):
        comp_s += t / M
        tau_fw = max(tau_fw, t)
    for k, path in enumerate(plan.paths):
        fw = b * profile.cut_bytes(plan.segments[k][1], FW)
        ts, ds = _path_dir_vectors(net, tuple(path), fw, FW)
        for t, d in zip(ts, ds):
            trans_s += t / M
            prop_s += d
            tau_fw = max(tau_fw, t)
    if plan.tail_path:  # psi_K = 0: forward propagation only
        _, prop, _ = _path_cost(net, tuple(plan.tail_path), 0.0, None)
        prop_s += prop
    for t in _plan_comp_vals_dir(net, profile, request, plan, BW):
        comp_s += t / M
        tau_bw = max(tau_bw, t)
    for k, path in enumerate(plan.paths):
        bw = b * profile.cut_bytes(plan.segments[k][1], BW)
        ts, ds = _path_dir_vectors(net, tuple(path), bw, BW)
        for t, d in zip(ts, ds):
            trans_s += t / M
            prop_s += d
            tau_bw = max(tau_bw, t)
    return LatencyBreakdown(comp_s, trans_s, prop_s,
                            (M - 1) * (tau_fw + tau_bw) / M)


def _fast_round_trip_taus(net: PhysicalNetwork, profile: ModelProfile,
                          request: ServiceChainRequest,
                          plan: Plan) -> tuple[float, float]:
    """``trainpipe.round_trip_taus`` from the memoized components."""
    b = request.batch_size
    tau_fw = max(_plan_comp_vals_dir(net, profile, request, plan, FW))
    tau_bw = max(_plan_comp_vals_dir(net, profile, request, plan, BW))
    for k, path in enumerate(plan.paths):
        cut = plan.segments[k][1]
        fw = b * profile.cut_bytes(cut, FW)
        bw = b * profile.cut_bytes(cut, BW)
        for t in _path_dir_vectors(net, tuple(path), fw, FW)[0]:
            tau_fw = max(tau_fw, t)
        for t in _path_dir_vectors(net, tuple(path), bw, BW)[0]:
            tau_bw = max(tau_bw, t)
    return tau_fw, tau_bw


def _fast_latency(net, profile, request, plan) -> float:
    return _fast_evaluate(net, profile, request, plan).total_s


def _fast_bottleneck(net: PhysicalNetwork, profile: ModelProfile,
                     request: ServiceChainRequest, plan: Plan) -> float:
    b = request.batch_size
    training = request.mode == TR
    tau = max(_plan_comp_vals(net, profile, request, plan))
    for k, path in enumerate(plan.paths):
        cut = plan.segments[k][1]
        fw = b * profile.cut_bytes(cut, FW)
        bw = b * profile.cut_bytes(cut, BW) if training else None
        tau = max(tau, _path_cost(net, tuple(path), fw, bw)[2])
    return tau


def _decode_seq(net: PhysicalNetwork, request: ServiceChainRequest,
                enc: _EncodedSeq, tail_src: int, srcs: np.ndarray,
                cap: float | None = None, scale: float = 1.0,
                cap_bw: float | None = None) -> Plan:
    """Backtrack one instance's placement/paths from the scan outputs —
    exactly the oracle's backtracking (same memoized sssp parent trees)."""
    K = len(enc.segments)
    placement = [""] * K
    pi = int(tail_src)
    placement[K - 1] = enc.cands[K - 1][pi]
    for k in range(K - 1, 0, -1):
        pi = int(srcs[k - 1, pi])
        placement[k - 1] = enc.cands[k - 1][pi]
    paths = [list(_stage_path_memo(net, placement[k - 1], placement[k],
                                   *enc.cut_sizes[k], cap, scale, cap_bw))
             for k in range(1, K)]
    # the tail ships zero bytes, so the backward cap never prunes its links
    tail = _stage_path_memo(net, placement[K - 1], request.destination, 0.0,
                            enc.tail_bw if cap is None and scale == 1.0
                            else None, cap, scale)
    return Plan(segments=[tuple(s) for s in enc.segments],
                placement=placement, paths=paths,
                tail_path=list(tail) if len(tail) > 1 else [])


def _decode_eval_seq(net: PhysicalNetwork, profile: ModelProfile,
                     request: ServiceChainRequest, enc: _EncodedSeq,
                     tail_src, srcs: np.ndarray, cap: float | None = None,
                     scale: float = 1.0, cap_bw: float | None = None
                     ) -> tuple[Plan, LatencyBreakdown]:
    """Backtrack + evaluate, memoized by the *scan output* (plus the encode's
    content key): recurring instances pay only the DP scan on warm calls —
    the optimization itself always runs; only the derived backtracking/
    path/latency reconstruction is cached, like the oracle's EvalCache."""
    key = (enc.key, int(tail_src), srcs.tobytes(), cap, scale, cap_bw)
    hit = _PLAN_MEMO.get(key)
    if hit is None:
        plan = _decode_seq(net, request, enc, tail_src, srcs, cap, scale,
                           cap_bw)
        hit = _memo_put(_PLAN_MEMO, key,
                        (plan, _fast_evaluate(net, profile, request, plan)))
    return hit


# ----------------------------------------------------------------- DFTS torch
def _run_dfts_scan(comp: np.ndarray, D: np.ndarray, tail: np.ndarray,
                   device: torch.device):
    """One ``dfts_scan`` of host operands on ``device``: the three operands
    go in by one copy of a packed host buffer and the three outputs come
    back by one copy of a packed device buffer (the one synchronisation).
    Returns (total (N,), tail_src (N,), srcs (K-1, N, S)) as numpy arrays."""
    N, K, S = comp.shape
    sizes = (comp.size, D.size, tail.size)
    host = np.concatenate([comp.ravel(), D.ravel(), tail.ravel()])
    ops = torch.from_numpy(host).to(device).split(sizes)
    n_src = (K - 1) * N * S
    raw = torch.empty(16 * N + 4 * n_src, dtype=torch.uint8, device=device)
    out = (raw[:8 * N].view(torch.float64),
           raw[8 * N:16 * N].view(torch.int64),
           raw[16 * N:].view(torch.int32 if K > 1 else torch.int64).view(
               K - 1, N, S))
    dfts_scan(ops[0].view(N, K, S), ops[1].view(N, K - 1, S, S),
              ops[2].view(N, S), out=out)
    back = raw.cpu().numpy()
    srcs = (back[16 * N:].view(np.int32).reshape(K - 1, N, S) if K > 1
            else np.empty((0, N, S), dtype=np.int64))
    return back[:8 * N].view(np.float64), back[8 * N:16 * N].view(np.int64), \
        srcs


class _Tour(NamedTuple):
    """One DFTS tour an instance needs: its encode, and the caps and 1/M
    scale of a capped tour (`dfts._capped_tour`; with ``cap_bw``,
    `dfts._capped_tour_tr`).  ``cap`` None with ``scale`` 1.0 is the
    uncapped tour of the encode itself, the convention of `_decode_seq`."""
    enc: _EncodedSeq
    cap: float | None = None
    scale: float = 1.0
    cap_bw: float | None = None


def _tour_operands(net: PhysicalNetwork, request: ServiceChainRequest,
                   tour: _Tour) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(comp (K, Sp), D (K-1, Sp, Sp), tail (Sp,)) of one tour: the encode's
    own arrays, or the capped tour's: candidates pruned to comp <= cap (per
    direction: comp_fw <= cap AND comp_bw <= cap_bw) and 1/M-scaled, links
    pruned inside the frontier matrices; the tail ships zero bytes, so no
    cap prunes a tail link."""
    enc, cap, scale, cap_bw = tour
    if cap is None and scale == 1.0:
        return enc.comp, enc.D, enc.tail
    K = len(enc.segments)
    if cap_bw is None:
        ceff = np.where(enc.comp <= (INF if cap is None else cap),
                        enc.comp * scale, INF)
    else:
        ceff = np.where((enc.comp_fw <= cap) & (enc.comp_bw <= cap_bw),
                        enc.comp * scale, INF)
    idx = net.node_index()
    Sp = enc.Sp
    D = np.full((K - 1, Sp, Sp), INF)
    for k in range(1, K):
        fw, bw = enc.cut_sizes[k]
        Dfull = net.frontier_matrix(tuple(enc.cands[k - 1]), fw, bw, cap,
                                    scale, cap_bw)
        cols = [idx[n] for n in enc.cands[k]]
        D[k - 1, :len(enc.cands[k - 1]), :len(enc.cands[k])] = Dfull[:, cols]
    tail = np.full(Sp, INF)
    tail_mat = net.frontier_matrix(tuple(enc.cands[K - 1]), 0.0, None, cap,
                                   scale)
    tail[:len(enc.cands[K - 1])] = tail_mat[:, idx[request.destination]]
    return ceff, D, tail


def _pipe_tours(net, profile, request, enc: _EncodedSeq):
    """`_dfts_pipe` as a generator of capped tours: yields each `_Tour` it
    needs and is sent its (plan, breakdown) or None; returns the best pair.
    Identical candidate-tau enumeration, incumbent bounds, and break
    conditions."""
    K = len(enc.segments)
    comp = enc.comp
    M = request.microbatches()
    inv_M = 1.0 / M
    c_bub = (M - 1) / M

    lb = max(float(comp[k][np.isfinite(comp[k])].min()) for k in range(K))
    taus = {float(v) for k in range(K) for v in comp[k][np.isfinite(comp[k])]}
    for k in range(1, K):
        fw, bw = enc.cut_sizes[k]
        for (u, v) in net.links:
            taus.add(net.link_trans_s(u, v, fw, bw))
    cand_taus = sorted(t for t in taus if t >= lb)

    pair0 = yield _Tour(enc, None, inv_M)
    if pair0 is None:
        return None
    plan0, best_lb = pair0
    best_pair, best_lat = pair0, best_lb.total_s
    fill_min = (best_lb.computation_s + best_lb.transmission_s
                + best_lb.propagation_s)
    tau0 = _fast_bottleneck(net, profile, request, plan0)

    for tau in cand_taus:
        if tau >= tau0 or fill_min + c_bub * tau >= best_lat:
            break
        pair_t = yield _Tour(enc, tau, inv_M)
        if pair_t is None:
            continue
        lat = pair_t[1].total_s
        if lat < best_lat:
            best_pair, best_lat = pair_t, lat
    return best_pair


def _pipe_tr_tours(net, profile, request, enc: _EncodedSeq):
    """`dfts._dfts_pipe_tr` as a generator of capped tours (as
    `_pipe_tours`): identical (F, B) pair enumeration, incumbent bound, and
    skip/break conditions, so plans and latencies are bit-identical to the
    scalar oracle (docs/training.md)."""
    K = len(enc.segments)
    M = request.microbatches()
    inv_M = 1.0 / M
    c_bub = (M - 1) / M

    lb_fw = max(float(enc.comp_fw[k][np.isfinite(enc.comp_fw[k])].min())
                for k in range(K))
    lb_bw = max(float(enc.comp_bw[k][np.isfinite(enc.comp_bw[k])].min())
                for k in range(K))
    fw_vals = {float(v) for k in range(K)
               for v in enc.comp_fw[k][np.isfinite(enc.comp_fw[k])]}
    bw_vals = {float(v) for k in range(K)
               for v in enc.comp_bw[k][np.isfinite(enc.comp_bw[k])]}
    for k in range(1, K):
        fw, bw = enc.cut_sizes[k]
        for (u, v), spec in net.links.items():
            fw_vals.add(transmission_time_s(fw, spec.bw_fw))
            bw_vals.add(transmission_time_s(bw, spec.bw_bw))
    cand_fw = sorted(t for t in fw_vals if t >= lb_fw)
    cand_bw = sorted(t for t in bw_vals if t >= lb_bw)

    pair0 = yield _Tour(enc, None, inv_M)
    if pair0 is None:
        return None
    plan0, lb0 = pair0
    best_pair, best_lat = pair0, lb0.total_s
    fill_min = lb0.computation_s + lb0.transmission_s + lb0.propagation_s
    tau_fw0, tau_bw0 = _fast_round_trip_taus(net, profile, request, plan0)

    pairs = sorted(((F, B) for F in cand_fw for B in cand_bw),
                   key=lambda p: (p[0] + p[1], p[0]))
    for F, B in pairs:
        if fill_min + c_bub * (F + B) >= best_lat:
            break
        if F >= tau_fw0 and B >= tau_bw0:
            continue
        pair_t = yield _Tour(enc, F, inv_M, B)
        if pair_t is None:
            continue
        lat = pair_t[1].total_s
        if lat < best_lat:
            best_pair, best_lat = pair_t, lat
    return best_pair


def _dfts_tours(net, profile, request, segments, cands):
    """Torch counterpart of :func:`repro_torch.core.dfts.dfts` (same
    dispatch) as a generator: yields each `_Tour` it needs, is sent the
    tour's (plan, breakdown) or None, and returns the instance's (plan,
    breakdown) or None.  Run it with `_run_tours`."""
    K = len(segments)
    enc = _encode_seq(net, profile, request, K, cands, segments)
    if request.schedule == PIPE and request.microbatches() > 1:
        for k in range(K):
            if not np.isfinite(enc.comp[k, :len(enc.cands[k])]).any():
                return None
        if request.mode == TR:
            return (yield from _pipe_tr_tours(net, profile, request, enc))
        return (yield from _pipe_tours(net, profile, request, enc))
    return (yield _Tour(enc))


def _run_tours(jobs: list, device: torch.device) -> list:
    """Run tour generators in lockstep waves; returns each one's result.

    ``jobs`` holds (net, profile, request, generator).  Wave w collects the
    tour every live generator yields next (within one instance each tour's
    break and skip tests depend only on the tours before it, so every
    instance runs exactly its own tours, in its own order), groups the
    wave's tours by (K, Sp), pads each group's N to a power of two with
    all-+inf rows (which can never change a result), runs one scan per
    group, then decodes each tour and sends it its result in job order.  A
    generator that returns leaves the waves."""
    results: list = [None] * len(jobs)
    pending: dict[int, _Tour] = {}

    def advance(i: int, gen_step):
        try:
            pending[i] = gen_step()
        except StopIteration as stop:
            results[i] = stop.value

    for i, (_, _, _, gen) in enumerate(jobs):
        advance(i, gen.__next__)
    while pending:
        groups: dict[tuple, list[int]] = {}
        for i, tour in pending.items():
            groups.setdefault((len(tour.enc.segments), tour.enc.Sp),
                              []).append(i)
        scanned: dict[int, tuple] = {}
        for (K, Sp), members in groups.items():
            n = len(members)
            Np = _pow2(n)
            comp = np.full((Np, K, Sp), INF)
            D = np.full((Np, K - 1, Sp, Sp), INF)
            tail = np.full((Np, Sp), INF)
            for r, i in enumerate(members):
                net, _, request, _ = jobs[i]
                comp[r], D[r], tail[r] = _tour_operands(net, request,
                                                        pending[i])
            total, tail_src, srcs = _run_dfts_scan(comp, D, tail, device)
            # (K-1, N, S) -> contiguous (N, K-1, S): per-row views, one copy
            srcs_rows = np.ascontiguousarray(np.moveaxis(srcs, 1, 0))
            for r, i in enumerate(members):
                scanned[i] = (total[r], tail_src[r], srcs_rows[r])
        tours, pending = pending, {}
        for i in sorted(tours):
            net, profile, request, gen = jobs[i]
            tour = tours[i]
            total, tail_src, srcs = scanned[i]
            pair = (_decode_eval_seq(net, profile, request, tour.enc,
                                     tail_src, srcs, tour.cap, tour.scale,
                                     tour.cap_bw)
                    if np.isfinite(total) else None)
            advance(i, lambda: gen.send(pair))
    return results


def _dfts_torch_plan(net, profile, request, segments, cands,
                     device: torch.device
                     ) -> tuple[Plan, LatencyBreakdown] | None:
    """One instance's DFTS on ``device``: its tours one wave each."""
    return _run_tours([(net, profile, request,
                        _dfts_tours(net, profile, request, segments,
                                    cands))], device)[0]


# --------------------------------------------------------- segmentation torch
def _ship_vectors(net: PhysicalNetwork, profile: ModelProfile,
                  request: ServiceChainRequest, path: tuple):
    """(trans[hi] (L+1,), prop) of shipping the cut after layer hi along
    ``path`` — the oracle's cut_transfer_s, vectorized over hi in link order."""
    b = request.batch_size
    training = request.mode == TR
    key = (net.content_key(), profile.content_key(), b, training, path)
    hit = _SHIP_MEMO.get(key)
    if hit is not None:
        return hit
    L = profile.L
    fw_b = np.array([b * profile.cut_bytes(c, FW) for c in range(1, L)])
    bw_b = (np.array([b * profile.cut_bytes(c, BW) for c in range(1, L)])
            if training else None)
    trans = np.full(L + 1, INF)
    trans[1:L] = 0.0
    prop = 0.0
    for u, v in zip(path, path[1:]):
        spec = net.links[(u, v)]
        trans[1:L] += transmission_time_s(fw_b, spec.bw_fw)
        prop += spec.delay_fw
        if bw_b is not None:
            trans[1:L] += transmission_time_s(bw_b, spec.bw_bw)
            prop += spec.delay_bw
    return _memo_put(_SHIP_MEMO, key, (trans, prop))


def _valid_mask(K: int, L: int) -> np.ndarray:
    """Admissible dp end-layers per stage: the oracle's e ranges."""
    valid = np.zeros((K, L + 1), dtype=bool)
    valid[0, 1:L - K + 2] = True  # stage 1: e in [1, L-K+1]
    for k in range(2, K):
        valid[k - 1, k:L - K + k + 1] = True
    if K > 1:
        valid[K - 1, :] = False
        valid[K - 1, L] = True  # stage K: e = L only
    return valid


def _segments_from_cuts(cuts: list[int], L: int) -> list[tuple[int, int]]:
    segments, lo = [], 1
    for c in cuts + [L]:
        segments.append((lo, c))
        lo = c + 1
    return segments


def _kseq_torch_seq(net, profile, request, plan: Plan,
                    device: torch.device):
    K, L = plan.K, profile.L
    scost = np.full((K, L + 1, L + 1), INF)
    for k in range(K):
        cost = np.array(_comp_fits_grid(net, profile, request,
                                        plan.placement[k]))
        if k < K - 1:
            trans, prop = _ship_vectors(net, profile, request,
                                        tuple(plan.paths[k]))
            cost = cost + (trans[None, :] + prop)  # cost += trans + prop
        scost[k, :L, :] = cost[1:, :]  # scost[k, e2, e] = cost[e2+1, e]
    dp, choices = kseq_scan(_to(scost, device),
                            _to(_valid_mask(K, L), device))
    dp = dp.cpu().numpy()
    choices = choices.cpu().numpy()
    if not np.isfinite(dp[L]):
        return None
    cuts = []
    e = L
    for k in range(K, 1, -1):
        e = int(choices[k - 2, e])
        cuts.append(e)
    cuts.reverse()
    return _segments_from_cuts(cuts, L)


def _kseq_torch_pipe(net, profile, request, plan: Plan,
                     device: torch.device):
    K, L = plan.K, profile.L
    M = request.microbatches()
    inv_M = 1.0 / M
    c_bub = (M - 1) / M
    b = request.batch_size
    training = request.mode == TR

    comp = np.full((K, L + 1, L + 1), INF)
    for k in range(K):
        lo_min, hi_max = k + 1, L - (K - 1 - k)
        grid = _comp_fits_grid(net, profile, request, plan.placement[k])
        comp[k, lo_min:hi_max + 1, lo_min:hi_max + 1] = \
            grid[lo_min:hi_max + 1, lo_min:hi_max + 1]

    # shipping tables — the oracle's exact loops (same accumulation order)
    fw_b = np.array([b * profile.cut_bytes(c, FW) for c in range(1, L)])
    bw_b = (np.array([b * profile.cut_bytes(c, BW) for c in range(1, L)])
            if training else None)
    ship_sum = np.zeros((max(K - 1, 1), L + 1))
    ship_max = np.zeros((max(K - 1, 1), L + 1))
    ship_prop = np.zeros(max(K - 1, 1))
    for k in range(K - 1):
        for u, v in zip(plan.paths[k], plan.paths[k][1:]):
            spec = net.links[(u, v)]
            t = transmission_time_s(fw_b, spec.bw_fw)
            ship_prop[k] += spec.delay_fw
            if bw_b is not None:
                t = t + transmission_time_s(bw_b, spec.bw_bw)
                ship_prop[k] += spec.delay_bw
            ship_sum[k, 1:L] += t
            ship_max[k, 1:L] = np.maximum(ship_max[k, 1:L], t)

    per_stage_min = []
    for k in range(K):
        fin = comp[k][np.isfinite(comp[k])]
        if fin.size == 0:
            return None
        per_stage_min.append(float(fin.min()))
    lb = max(per_stage_min)
    tau_set = set(comp[np.isfinite(comp)].tolist())
    for k in range(K - 1):
        tau_set.update(ship_max[k, 1:L].tolist())
    taus = np.array(sorted(t for t in tau_set if t >= lb))
    if taus.size == 0:
        return None
    T = taus.size

    fill = comp * inv_M
    smax = comp.copy()
    for k in range(K - 1):
        fill[k] = fill[k] + (ship_sum[k][None, :] * inv_M + ship_prop[k])
        smax[k] = np.maximum(smax[k], ship_max[k][None, :])
    sfill = np.full((K, L + 1, L + 1), INF)
    ssmax = np.full((K, L + 1, L + 1), INF)
    sfill[:, :L, :] = fill[:, 1:, :]
    ssmax[:, :L, :] = smax[:, 1:, :]

    taus_pad = np.full(_pow2(T), INF)
    taus_pad[:T] = taus
    dp, choices = kseq_pipe_scan(
        _to(sfill, device), _to(ssmax, device),
        _to(_valid_mask(K, L), device), _to(taus_pad, device))
    dp_KL = dp[L].cpu().numpy()
    choices = choices.cpu().numpy()

    tot = dp_KL + c_bub * taus_pad
    t_idx = int(np.argmin(tot))
    if not np.isfinite(tot[t_idx]):
        return None
    cuts = []
    e = L
    for k in range(K, 1, -1):
        e = int(choices[k - 2, e, t_idx])
        cuts.append(e)
    cuts.reverse()
    return _segments_from_cuts(cuts, L)


def _run_pipe_dp_torch(sfill, ssmax, valid, taus, device: torch.device):
    """``segmentation._pipe_dp_np`` on the device ``kseq_pipe_scan``: pads
    the cap grid to a power of two with +inf caps (absorbing; the first
    ``len(taus)`` columns stay aligned, as the shared driver requires) and
    returns the dp row at [K, L] plus the scan's first-occurrence choice
    lookup."""
    L = sfill.shape[1] - 1
    taus_pad = np.full(_pow2(max(taus.size, 1)), INF)
    taus_pad[:taus.size] = taus
    dp, choices = kseq_pipe_scan(
        _to(sfill, device), _to(ssmax, device), _to(valid, device),
        _to(taus_pad, device))
    dp_KL = dp[L].cpu().numpy()
    choices = choices.cpu().numpy()
    return dp_KL, lambda k, e, t: int(choices[k - 2, e, t])


def _kseq_torch_pipe_tr(net, profile, request, plan: Plan,
                        device: torch.device):
    """`segmentation._k_seq_pipe_tr` with the inner DP on the device scan:
    the (K, L+1, L+1) grids are rebuilt bit-identically from the memoized
    dense tables, then the *shared* driver `_run_k_seq_pipe_tr` executes the
    forward-cap scan — same control flow by construction, so segment choices
    match the scalar oracle exactly (docs/training.md)."""
    from .segmentation import _run_k_seq_pipe_tr

    K, L = plan.K, profile.L
    M = request.microbatches()
    inv_M = 1.0 / M
    c_bub = (M - 1) / M
    b = request.batch_size
    paths = plan.paths

    comp = np.full((K, L + 1, L + 1), INF)
    comp_fw = np.full((K, L + 1, L + 1), INF)
    comp_bw = np.full((K, L + 1, L + 1), INF)
    for k in range(K):
        lo_min, hi_max = k + 1, L - (K - 1 - k)
        w = slice(lo_min, hi_max + 1)
        node = plan.placement[k]
        comp[k, w, w] = _comp_fits_grid(net, profile, request, node)[w, w]
        comp_fw[k, w, w] = _comp_fits_grid_dir(net, profile, request, node,
                                               FW)[w, w]
        comp_bw[k, w, w] = _comp_fits_grid_dir(net, profile, request, node,
                                               BW)[w, w]

    # shipping tables — segmentation._tr_stage_grids' exact loops
    fw_b = np.array([b * profile.cut_bytes(c, FW) for c in range(1, L)])
    bw_b = np.array([b * profile.cut_bytes(c, BW) for c in range(1, L)])
    ship_sum = np.zeros((max(K - 1, 1), L + 1))
    ship_prop = np.zeros(max(K - 1, 1))
    ship_max_fw = np.zeros((max(K - 1, 1), L + 1))
    ship_max_bw = np.zeros((max(K - 1, 1), L + 1))
    for k in range(K - 1):
        for u, v in zip(paths[k], paths[k][1:]):
            spec = net.links[(u, v)]
            t_fw = transmission_time_s(fw_b, spec.bw_fw)
            t_bw = transmission_time_s(bw_b, spec.bw_bw)
            ship_prop[k] += spec.delay_fw + spec.delay_bw
            ship_sum[k, 1:L] += t_fw + t_bw
            ship_max_fw[k, 1:L] = np.maximum(ship_max_fw[k, 1:L], t_fw)
            ship_max_bw[k, 1:L] = np.maximum(ship_max_bw[k, 1:L], t_bw)

    fill = comp * inv_M
    sfmax = comp_fw.copy()
    sbmax = comp_bw.copy()
    for k in range(K - 1):
        fill[k] = fill[k] + (ship_sum[k][None, :] * inv_M + ship_prop[k])
        sfmax[k] = np.maximum(sfmax[k], ship_max_fw[k][None, :])
        sbmax[k] = np.maximum(sbmax[k], ship_max_bw[k][None, :])
    return _run_k_seq_pipe_tr(K, L, c_bub, fill, sfmax, sbmax,
                              functools.partial(_run_pipe_dp_torch,
                                                device=device))


def _kseq_torch(net, profile, request, plan: Plan, device: torch.device):
    """Torch counterpart of k_sequence_segmentation (same dispatch)."""
    if request.schedule == PIPE and request.microbatches() > 1:
        if request.mode == TR:
            return _kseq_torch_pipe_tr(net, profile, request, plan, device)
        return _kseq_torch_pipe(net, profile, request, plan, device)
    return _kseq_torch_seq(net, profile, request, plan, device)


# ----------------------------------------------------------------- solvers
def _fallback_split(profile, request, K, segments):
    """The min-memory split that the one-shot solvers try when the even
    split ``segments`` has no placement, or None when there is none to try
    (shared by ``dfts_np`` and ``dfts_torch``, identical by construction)."""
    from .baselines import min_memory_split  # local import avoids a cycle

    alt = min_memory_split(profile, request, K)
    return alt if alt is not None and alt != segments else None


def _split_place(profile, request, K, place):
    """``dfts_torch``'s even-split -> DFTS -> min-memory-fallback control
    flow as a tour generator: ``place(segments)`` is a generator of the
    tours that placement needs (`_dfts_tours`) returning a (Plan,
    breakdown) pair or None; this only checks feasibility (None) and passes
    the result through."""
    segments = even_split(profile.L, K)
    res = yield from place(segments)
    if res is None:
        alt = _fallback_split(profile, request, K, segments)
        if alt is not None:
            res = yield from place(alt)
    return res


def dfts_np_solve(
    net: PhysicalNetwork,
    profile: ModelProfile,
    request: ServiceChainRequest,
    K: int,
    candidates: list[list[str]],
    cache: EvalCache | None = None,
) -> SolveResult:
    """Scalar NumPy twin of ``dfts_torch``: even split + one DFTS tour (the
    oracle implementation), min-memory fallback.  The benchmark's baseline."""
    t0 = time.perf_counter()
    cache = cache if cache is not None else EvalCache()
    ev = PlanEvaluator(net, profile, request, cache=cache)
    segments = even_split(profile.L, K)
    plan = dfts(net, profile, request, segments, candidates, cache=cache)
    if plan is None:
        alt = _fallback_split(profile, request, K, segments)
        if alt is not None:
            plan = dfts(net, profile, request, alt, candidates, cache=cache)
    if plan is None:
        return SolveResult(None, None, time.perf_counter() - t0, 0,
                           solver="dfts_np")
    return SolveResult(plan, ev.evaluate(plan), time.perf_counter() - t0, 1,
                       solver="dfts_np")


def dfts_torch_solve(
    net: PhysicalNetwork,
    profile: ModelProfile,
    request: ServiceChainRequest,
    K: int,
    candidates: list[list[str]],
    cache: EvalCache | None = None,
    device: str | torch.device = "cuda",
) -> SolveResult:
    """Even split + one DFTS tour on ``device`` (min-memory fallback):
    bit-identical to ``dfts_np``."""
    t0 = time.perf_counter()
    device = resolve_device(device)
    pair = _run_tours([(net, profile, request,
                        _dfts_torch_gen(net, profile, request, K,
                                        candidates))], device)[0]
    if pair is None:
        return SolveResult(None, None, time.perf_counter() - t0, 0,
                           solver="dfts_torch")
    return SolveResult(pair[0], pair[1], time.perf_counter() - t0, 1,
                       solver="dfts_torch")


def _dfts_torch_gen(net, profile, request, K, candidates):
    """``dfts_torch``'s whole control flow for one instance, as a tour
    generator for `_run_tours`."""
    return _split_place(
        profile, request, K,
        lambda segs: _dfts_tours(net, profile, request, segs, candidates))


def _dfts_torch_batch(problems: list[ProblemInstance], *,
                      cache: EvalCache | None = None,
                      device: str | torch.device = "cuda"
                      ) -> list[SolveResult]:
    """Batched ``dfts_torch``: every instance's tours run in lockstep waves
    (`_run_tours`), one scan per (K, S-bucket) group of a wave: the first
    wave holds every instance's first tour (a sequential instance's only
    one, a pipelined instance's uncapped one); later waves the pipelined
    instances' capped tours and the min-memory fallbacks.  Each
    ``SolveResult.wall_time_s`` is the instance's share of the batch's
    time (pipelined instances' too)."""
    t0 = time.perf_counter()
    device = resolve_device(device)
    problems = list(problems)
    pairs = _run_tours([(p.net, p.profile, p.request,
                         _dfts_torch_gen(p.net, p.profile, p.request, p.K,
                                         p.candidates))
                        for p in problems], device)
    share = (time.perf_counter() - t0) / max(1, len(problems))
    return [SolveResult(None, None, share, 0, solver="dfts_torch")
            if pair is None else
            SolveResult(pair[0], pair[1], share, 1, solver="dfts_torch")
            for pair in pairs]  # aligned with `problems`


def _bcd_torch_batch(problems: list[ProblemInstance], *,
                     cache: EvalCache | None = None,
                     **kwargs) -> list[SolveResult]:
    """Batched ``bcd_torch``: a per-instance loop (BCD trajectories have
    data-dependent lengths, so instances don't pad into one scan)."""
    return [bcd_torch_solve(*p.solver_args(), cache=cache, **kwargs)
            for p in problems]


@register_solver("dfts_np", schedules=(SEQ, PIPE),
                 description="scalar one-shot baseline: even split (min-mem "
                             "fallback) + one exact DFTS placement/chaining "
                             "tour — the NumPy twin of dfts_torch")
def _dfts_np_registered(net, profile, request, K, candidates,
                        cache: EvalCache | None = None) -> SolveResult:
    return dfts_np_solve(net, profile, request, K, candidates, cache=cache)


register_solver("dfts_torch", schedules=(SEQ, PIPE), batch=_dfts_torch_batch,
                description="batched one-shot solver on the card: even split "
                            "(min-mem fallback) + DFTS tours in lockstep "
                            "waves, each a batched min-plus DP in one launch "
                            "of the CUDA scan kernel; bit-identical to "
                            "dfts_np")(dfts_torch_solve)


def bcd_torch_solve(
    net: PhysicalNetwork,
    profile: ModelProfile,
    request: ServiceChainRequest,
    K: int,
    candidates: list[list[str]],
    eps: float = 0.0,
    max_iters: int = 50,
    cache: EvalCache | None = None,
    device: str | torch.device = "cuda",
) -> SolveResult:
    """`bcd_solve` with both block minimizations on the device DP scans —
    same trajectories, same plans, bit-identical latencies."""
    t0 = time.perf_counter()
    device = resolve_device(device)
    cache = cache if cache is not None else EvalCache()
    pipelined = request.schedule == PIPE and request.microbatches() > 1

    def alternate(segments):
        pair = _dfts_torch_plan(net, profile, request, segments, candidates,
                                device=device)
        if pair is None:
            return None, INF, [], 0
        plan, prev = pair[0], pair[1].total_s
        history = [prev]
        iters = 0
        for iters in range(1, max_iters + 1):
            new_segments = _kseq_torch(net, profile, request, plan, device)
            if new_segments is None:
                break
            new_pair = _dfts_torch_plan(net, profile, request, new_segments,
                                        candidates, device=device)
            if new_pair is None:
                break
            plan, cur = new_pair[0], new_pair[1].total_s
            history.append(cur)
            if abs(cur - prev) <= eps:
                prev = cur
                break
            prev = cur
        return plan, prev, history, iters

    segments = even_split(profile.L, K)
    plan, prev, history, iters = alternate(segments)
    if plan is None:
        from .baselines import min_memory_split  # local import avoids a cycle

        segments = min_memory_split(profile, request, K)
        if segments is not None:
            plan, prev, history, iters = alternate(segments)
    if plan is None:
        return SolveResult(None, None, time.perf_counter() - t0, 0,
                           solver="bcd_torch")

    if pipelined:
        from .baselines import comp_balance_split  # local import avoids cycle

        bal = comp_balance_split(net, profile, request, K, candidates,
                                 cache=cache)
        if bal is not None and bal != segments:
            plan2, prev2, history2, iters2 = alternate(bal)
            if plan2 is not None and prev2 < prev:
                plan, prev, history, iters = plan2, prev2, history2, iters2

        seq_req = replace(request, schedule=SEQ, n_microbatches=1)
        seq_res = bcd_torch_solve(net, profile, seq_req, K, candidates,
                                  eps=eps, max_iters=max_iters, cache=cache,
                                  device=device)
        if seq_res.plan is not None:
            anchor = _fast_latency(net, profile, request, seq_res.plan)
            if anchor < prev:
                plan, prev = seq_res.plan, anchor
                history.append(anchor)

    return SolveResult(plan, _fast_evaluate(net, profile, request, plan),
                       time.perf_counter() - t0, iters, history,
                       solver="bcd_torch")


register_solver("bcd_torch", schedules=(SEQ, PIPE), batch=_bcd_torch_batch,
                description="paper Alg. 1 on the device DP scans: "
                            "alternate the K-seq segmentation and DFTS "
                            "min-plus blocks; bit-identical to bcd")(
    bcd_torch_solve)
