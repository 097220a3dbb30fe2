"""K-sequence segmentation via dynamic programming (paper Alg. 2, [23]).

Optimizes the model splitting y_t for a *fixed* placement + chaining x_{t-1}:
segment k's cost is its compute time at the node currently hosting F^k plus the
cost of shipping its output cut along the current (k)th inter-stage path.
Capacity violations (constraints (14)-(15)) yield +inf, as in the paper.

We index dp[k][e] = min cost of covering layers 1..e with k segments (the paper's
dp_{k,l} covers 1..l-1; the shift removes its off-by-one at the last segment).
Complexity O(K L^2) segment evaluations, per Sec. V-D.
"""
from __future__ import annotations

import numpy as np

from .costmodel import BW, FW, PIPE, TR, ModelProfile
from .network import PhysicalNetwork, transmission_time_s
from .plan import EvalCache, Plan, PlanEvaluator, ServiceChainRequest
from .trainpipe import segment_comp_dir_s

INF = float("inf")


def _segment_cost(
    ev: PlanEvaluator,
    profile: ModelProfile,
    net: PhysicalNetwork,
    request: ServiceChainRequest,
    k: int,
    K: int,
    lo: int,
    hi: int,
    placement: list[str],
    paths: list[list[str]],
) -> float:
    """T(x^k, 1^k_{lo,hi}, b, mode): compute at placement[k] + outgoing cut shipping."""
    node = placement[k]
    if not ev.segment_fits(node, lo, hi):
        return INF
    cost = ev.segment_comp_s(node, lo, hi)
    if k < K - 1:  # ship delta_hi along the existing (k+1)-th subpath
        trans, prop = ev.cut_transfer_s(paths[k], hi)
        cost += trans + prop
    return cost


def k_sequence_segmentation(
    net: PhysicalNetwork,
    profile: ModelProfile,
    request: ServiceChainRequest,
    plan: Plan,
    cache: EvalCache | None = None,
) -> list[tuple[int, int]] | None:
    """Re-split L layers into K segments for plan's fixed placement/chaining.

    Pipelined requests (schedule="pipe", M > 1) go through `_k_seq_pipe`,
    which optimizes the pipelined objective (balanced stages beat
    front-loaded ones once the bottleneck term dominates); pipelined
    *training* requests go through `_k_seq_pipe_tr`, which optimizes the
    round-trip objective with its two per-direction bottlenecks
    (docs/training.md)."""
    if request.schedule == PIPE and request.microbatches() > 1:
        if request.mode == TR:
            return _k_seq_pipe_tr(net, profile, request, plan, cache)
        return _k_seq_pipe(net, profile, request, plan, cache)
    K, L = plan.K, profile.L
    ev = PlanEvaluator(net, profile, request, cache=cache)
    placement, paths = plan.placement, plan.paths

    def segcost(k: int, lo: int, hi: int) -> float:
        return _segment_cost(ev, profile, net, request, k, K, lo, hi, placement, paths)

    # dp[k][e]: k segments covering layers 1..e; e in [k, L-(K-k)]
    dp = [[INF] * (L + 1) for _ in range(K + 1)]
    choice = [[-1] * (L + 1) for _ in range(K + 1)]
    for e in range(1, L - K + 2):
        dp[1][e] = segcost(0, 1, e)
    for k in range(2, K + 1):
        e_vals = range(k, L - K + k + 1) if k < K else [L]
        for e in e_vals:
            for e2 in range(k - 1, e):
                prev = dp[k - 1][e2]
                if prev == INF:
                    continue
                c = prev + segcost(k - 1, e2 + 1, e)
                if c < dp[k][e]:
                    dp[k][e] = c
                    choice[k][e] = e2
    if dp[K][L] == INF:
        return None
    cuts = []
    e = L
    for k in range(K, 1, -1):
        e = choice[k][e]
        cuts.append(e)
    cuts.reverse()
    segments, lo = [], 1
    for c in cuts + [L]:
        segments.append((lo, c))
        lo = c + 1
    return segments


def _k_seq_pipe(
    net: PhysicalNetwork,
    profile: ModelProfile,
    request: ServiceChainRequest,
    plan: Plan,
    cache: EvalCache | None = None,
) -> list[tuple[int, int]] | None:
    """K-sequence segmentation under the pipelined objective (docs/pipeline.md).

    For the fixed placement/chaining, stage times are the per-stage compute
    plus each link's transmission of the stage's outgoing cut; the objective
    fill + (M-1)/M * tau couples segments through the bottleneck tau, which a
    plain min-sum DP cannot express.  We therefore run the DP *vectorized over
    candidate bottleneck caps*: dp[k][e] is an array over caps tau (segments
    slower than tau cost +inf), and the answer is the cap minimizing
    dp[K][L][tau] + (M-1)/M * tau.  The optimum's bottleneck is always one of
    the finitely many candidate stage-time values, so the scan is exact for
    this block.  O(K L^2) transitions, each an O(|taus|) NumPy op.
    """
    K, L = plan.K, profile.L
    ev = PlanEvaluator(net, profile, request, cache=cache)
    placement, paths = plan.placement, plan.paths
    M = request.microbatches()
    inv_M = 1.0 / M
    c_bub = (M - 1) / M
    b = request.batch_size
    training = request.mode == TR

    # full-batch compute per (stage, lo, hi); +inf where capacity-infeasible
    comp = np.full((K, L + 1, L + 1), INF)
    for k in range(K):
        node = placement[k]
        lo_min, hi_max = k + 1, L - (K - 1 - k)
        for lo in range(lo_min, hi_max + 1):
            for hi in range(lo, hi_max + 1):
                if ev.segment_fits(node, lo, hi):
                    comp[k, lo, hi] = ev.segment_comp_s(node, lo, hi)

    # shipping along the existing (k)-th subpath, tabulated per cut position c:
    # total link transmission (fill), slowest single link (bottleneck), and the
    # cut-independent propagation sum
    fw_b = np.array([b * profile.cut_bytes(c, FW) for c in range(1, L)])
    bw_b = (np.array([b * profile.cut_bytes(c, BW) for c in range(1, L)])
            if training else None)
    ship_sum = np.zeros((max(K - 1, 1), L + 1))
    ship_max = np.zeros((max(K - 1, 1), L + 1))
    ship_prop = np.zeros(max(K - 1, 1))
    for k in range(K - 1):
        for u, v in zip(paths[k], paths[k][1:]):
            spec = net.links[(u, v)]
            t = transmission_time_s(fw_b, spec.bw_fw)
            ship_prop[k] += spec.delay_fw
            if bw_b is not None:
                t = t + transmission_time_s(bw_b, spec.bw_bw)
                ship_prop[k] += spec.delay_bw
            ship_sum[k, 1:L] += t
            ship_max[k, 1:L] = np.maximum(ship_max[k, 1:L], t)

    # candidate bottleneck caps: every stage time any segmentation can exhibit
    per_stage_min = []
    for k in range(K):
        fin = comp[k][np.isfinite(comp[k])]
        if fin.size == 0:
            return None  # stage k fits nowhere for any segment
        per_stage_min.append(float(fin.min()))
    lb = max(per_stage_min)
    tau_set = set(comp[np.isfinite(comp)].tolist())
    for k in range(K - 1):
        tau_set.update(ship_max[k, 1:L].tolist())
    taus = np.array(sorted(t for t in tau_set if t >= lb))
    if taus.size == 0:
        return None
    T = taus.size

    def seg_cost(k0: int, lo: int, hi: int):
        """(fill, stage max) of zero-based stage k0 hosting [lo, hi]."""
        c = comp[k0, lo, hi]
        if c == INF:
            return None
        fill = c * inv_M
        smax = c
        if k0 < K - 1:
            fill += ship_sum[k0, hi] * inv_M + ship_prop[k0]
            smax = max(smax, ship_max[k0, hi])
        return fill, smax

    dp = np.full((K + 1, L + 1, T), INF)
    choice = np.full((K + 1, L + 1, T), -1, dtype=np.int32)
    for e in range(1, L - K + 2):
        sc = seg_cost(0, 1, e)
        if sc is not None:
            dp[1, e] = np.where(taus >= sc[1], sc[0], INF)
    for k in range(2, K + 1):
        e_vals = range(k, L - K + k + 1) if k < K else [L]
        for e in e_vals:
            for e2 in range(k - 1, e):
                sc = seg_cost(k - 1, e2 + 1, e)
                if sc is None:
                    continue
                cand = dp[k - 1, e2] + np.where(taus >= sc[1], sc[0], INF)
                better = cand < dp[k, e]
                if better.any():
                    dp[k, e][better] = cand[better]
                    choice[k, e][better] = e2

    tot = dp[K, L] + c_bub * taus
    t_idx = int(np.argmin(tot))
    if not np.isfinite(tot[t_idx]):
        return None
    cuts = []
    e = L
    for k in range(K, 1, -1):
        e = int(choice[k, e, t_idx])
        cuts.append(e)
    cuts.reverse()
    segments, lo = [], 1
    for c in cuts + [L]:
        segments.append((lo, c))
        lo = c + 1
    return segments


# ------------------------------------------------- round-trip (TR) pipelining
def _tr_valid_mask(K: int, L: int) -> np.ndarray:
    """Admissible dp end-layers per stage (the oracle's e ranges)."""
    valid = np.zeros((K, L + 1), dtype=bool)
    valid[0, 1:L - K + 2] = True  # stage 1: e in [1, L-K+1]
    for k in range(2, K):
        valid[k - 1, k:L - K + k + 1] = True
    if K > 1:
        valid[K - 1, :] = False
        valid[K - 1, L] = True  # stage K: e = L only
    return valid


def _pipe_dp_np(sfill: np.ndarray, ssmax: np.ndarray, valid: np.ndarray,
                taus: np.ndarray):
    """Reference NumPy pipelined segmentation DP on dense (K, L+1, L+1)
    transition tensors (sfill[k, e2, e] = fill of segment lo=e2+1..hi=e at
    stage k, ssmax its capped stage-time; +inf infeasible), vectorized over
    the candidate caps ``taus``.  First-strict-improvement updates, matching
    the jitted ``kseq_pipe_scan`` twin's first-occurrence argmin.  Returns
    (dp[K, L] over caps, choice lookup (k, e, t) -> e2)."""
    K, Lp1, _ = sfill.shape
    L = Lp1 - 1
    T = taus.size
    dp = np.full((K + 1, Lp1, T), INF)
    choice = np.full((K + 1, Lp1, T), -1, dtype=np.int32)
    for e in range(1, Lp1):
        if valid[0, e]:
            dp[1, e] = np.where(taus >= ssmax[0, 0, e], sfill[0, 0, e], INF)
    for k in range(2, K + 1):
        for e in range(1, Lp1):
            if not valid[k - 1, e]:
                continue
            for e2 in range(k - 1, e):
                sf = sfill[k - 1, e2, e]
                if sf == INF:
                    continue
                cand = dp[k - 1, e2] + np.where(taus >= ssmax[k - 1, e2, e],
                                                sf, INF)
                better = cand < dp[k, e]
                if better.any():
                    dp[k, e][better] = cand[better]
                    choice[k, e][better] = e2
    return dp[K, L], lambda k, e, t: int(choice[k, e, t])


def _run_k_seq_pipe_tr(K: int, L: int, c_bub: float, fill: np.ndarray,
                       sfmax: np.ndarray, sbmax: np.ndarray, run_pipe_dp):
    """Shared round-trip segmentation scan (docs/training.md): the control
    flow of `_k_seq_pipe_tr` and its jitted twin, parameterized only by the
    inner DP so the two stay bit-identical by construction.

    ``fill``/``sfmax``/``sbmax`` are (K, L+1, L+1) [lo, hi]-indexed per-stage
    fill costs and per-direction stage maxima (+inf infeasible).  The
    round-trip objective fill + (M-1)/M * (tau_fw + tau_bw) couples segments
    through *two* bottlenecks, so the cap-vectorized DP handles the backward
    caps while an outer scan enumerates candidate forward caps F ascending
    (segments with forward stage time > F masked +inf): the answer for a pair
    is dp[K, L][B] + c_bub * (F + B), any segmentation's exact (tau_fw,
    tau_bw) appears in the grid, and the incumbent bound
    min_fill + c_bub * (F + lb_bw) >= best stops the scan — exact for this
    block, like the 1D scan of `_k_seq_pipe`.

    ``run_pipe_dp(sfill, ssmax, valid, taus)`` returns (dp over caps at
    [K, L], choice lookup); any +inf cap padding it adds internally must keep
    the first ``len(taus)`` columns aligned.
    """
    feas = np.isfinite(fill)
    lb_f, lb_b = 0.0, 0.0
    f_vals: set[float] = set()
    b_vals: set[float] = set()
    for k in range(K):
        if not feas[k].any():
            return None
        lb_f = max(lb_f, float(sfmax[k][feas[k]].min()))
        lb_b = max(lb_b, float(sbmax[k][feas[k]].min()))
        f_vals.update(sfmax[k][feas[k]].tolist())
        b_vals.update(sbmax[k][feas[k]].tolist())
    cand_f = sorted(t for t in f_vals if t >= lb_f)
    taus_b = np.array(sorted(t for t in b_vals if t >= lb_b))
    if not cand_f or taus_b.size == 0:
        return None

    # dense e2-shift: d[k, e2, e] = grid[k, lo=e2+1, e]
    def shift(grid):
        d = np.full((K, L + 1, L + 1), INF)
        d[:, :L, :] = grid[:, 1:, :]
        return d

    fill_d, sfmax_d, sbmax_d = shift(fill), shift(sfmax), shift(sbmax)
    valid = _tr_valid_mask(K, L)

    def backtrack(choice_fn, t_idx):
        cuts = []
        e = L
        for k in range(K, 1, -1):
            e = choice_fn(k, e, t_idx)
            cuts.append(e)
        cuts.reverse()
        segments, lo = [], 1
        for c in cuts + [L]:
            segments.append((lo, c))
            lo = c + 1
        return segments

    # unconstrained pass: global fill lower bound + incumbent segmentation
    dp0, ch0 = run_pipe_dp(fill_d, sbmax_d, valid, taus_b)
    dp0 = np.asarray(dp0)[:taus_b.size]
    if not np.isfinite(dp0).any():
        return None
    fill_min = float(dp0[np.isfinite(dp0)].min())
    t0 = int(np.argmin(dp0 + c_bub * taus_b))
    best_segments = backtrack(ch0, t0)
    obj = 0.0
    tau_f = tau_b = 0.0
    for k, (lo, hi) in enumerate(best_segments):
        obj += float(fill[k, lo, hi])
        tau_f = max(tau_f, float(sfmax[k, lo, hi]))
        tau_b = max(tau_b, float(sbmax[k, lo, hi]))
    best_obj = obj + c_bub * (tau_f + tau_b)

    for F in cand_f:
        if fill_min + c_bub * (F + lb_b) >= best_obj:
            break
        dp, ch = run_pipe_dp(np.where(sfmax_d <= F, fill_d, INF), sbmax_d,
                             valid, taus_b)
        dp = np.asarray(dp)[:taus_b.size]
        tot = dp + c_bub * (F + taus_b)
        t_idx = int(np.argmin(tot))
        if not np.isfinite(tot[t_idx]):
            continue
        if tot[t_idx] < best_obj:
            best_segments = backtrack(ch, t_idx)
            best_obj = float(tot[t_idx])
    return best_segments


def _tr_stage_grids(net, profile, request, plan, ev):
    """Dense (K, L+1, L+1) [lo, hi] grids for the round-trip segmentation
    scan: fused fill cost plus per-direction stage-time maxima, +inf where
    capacity-infeasible — the oracle's exact cost values (EvalCache-served)."""
    K, L = plan.K, profile.L
    M = request.microbatches()
    inv_M = 1.0 / M
    b = request.batch_size
    placement, paths = plan.placement, plan.paths

    comp = np.full((K, L + 1, L + 1), INF)
    comp_fw = np.full((K, L + 1, L + 1), INF)
    comp_bw = np.full((K, L + 1, L + 1), INF)
    for k in range(K):
        node = placement[k]
        lo_min, hi_max = k + 1, L - (K - 1 - k)
        for lo in range(lo_min, hi_max + 1):
            for hi in range(lo, hi_max + 1):
                if ev.segment_fits(node, lo, hi):
                    comp[k, lo, hi] = ev.segment_comp_s(node, lo, hi)
                    comp_fw[k, lo, hi] = segment_comp_dir_s(ev, node, lo, hi,
                                                            FW)
                    comp_bw[k, lo, hi] = segment_comp_dir_s(ev, node, lo, hi,
                                                            BW)

    # per-subpath shipping: fused fill terms, per-direction slowest links
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
    return fill, sfmax, sbmax


def _k_seq_pipe_tr(
    net: PhysicalNetwork,
    profile: ModelProfile,
    request: ServiceChainRequest,
    plan: Plan,
    cache: EvalCache | None = None,
) -> list[tuple[int, int]] | None:
    """K-sequence segmentation under the round-trip training objective
    (docs/training.md): `_run_k_seq_pipe_tr` on the oracle grids with the
    reference NumPy DP."""
    K, L = plan.K, profile.L
    ev = PlanEvaluator(net, profile, request, cache=cache)
    M = request.microbatches()
    c_bub = (M - 1) / M
    fill, sfmax, sbmax = _tr_stage_grids(net, profile, request, plan, ev)
    return _run_k_seq_pipe_tr(K, L, c_bub, fill, sfmax, sbmax, _pipe_dp_np)
