"""Comparison schemes COMP-MS and COMM-MS (paper Sec. VI-A3).

Both are two-step: (1) choose the splitting y* minimizing only computation
(COMP-MS) or only communication (COMM-MS) overhead, ignoring placement and
chaining; (2) solve placement + chaining for the fixed y*.  Step 2 in the paper
is an ILP; given y the DFTS stage-DP is provably optimal (no link capacities), so
we use it — equivalent results, faster.
"""
from __future__ import annotations

import time

from .costmodel import PIPE, SEQ, ModelProfile, dirs_for_mode
from .dfts import dfts
from .engine import register_solver
from .network import PhysicalNetwork
from .plan import EvalCache, PlanEvaluator, ServiceChainRequest
from .problem import SolveResult

INF = float("inf")


def _dp_split(L: int, K: int, segcost) -> list[tuple[int, int]] | None:
    """Generic min-sum contiguous K-segmentation: segcost(k, lo, hi) -> float."""
    dp = [[INF] * (L + 1) for _ in range(K + 1)]
    choice = [[-1] * (L + 1) for _ in range(K + 1)]
    for e in range(1, L - K + 2):
        dp[1][e] = segcost(0, 1, e)
    for k in range(2, K + 1):
        e_vals = range(k, L - K + k + 1) if k < K else [L]
        for e in e_vals:
            for e2 in range(k - 1, e):
                if dp[k - 1][e2] == INF:
                    continue
                c = dp[k - 1][e2] + segcost(k - 1, e2 + 1, e)
                if c < dp[k][e]:
                    dp[k][e] = c
                    choice[k][e] = e2
    if dp[K][L] == INF:
        return None
    cuts, e = [], L
    for k in range(K, 1, -1):
        e = choice[k][e]
        cuts.append(e)
    cuts.reverse()
    segments, lo = [], 1
    for c in cuts + [L]:
        segments.append((lo, c))
        lo = c + 1
    return segments


def _fits_some_candidate(ev: PlanEvaluator, cand: list[str], lo: int, hi: int) -> bool:
    return any(ev.segment_fits(i, lo, hi) for i in cand)


def _balance_tiebreak(profile: ModelProfile, lo: int, hi: int) -> float:
    """Tiny secondary objective: both step-1 ILPs in the paper have massive tie
    sets (homogeneous GPUs + linear kappa / equal-size cut groups); Gurobi breaks
    them arbitrarily, we break them toward memory-balanced segments so step 2
    stays feasible (the paper's step 2 is feasible for every K it plots)."""
    frac = profile.seg_mem_bytes(lo, hi) / max(1.0, profile.seg_mem_bytes(1, profile.L))
    return 1e-9 * frac * frac


def comp_ms_split(
    net: PhysicalNetwork,
    profile: ModelProfile,
    request: ServiceChainRequest,
    K: int,
    candidates: list[list[str]],
) -> list[tuple[int, int]] | None:
    """Computation-oriented splitting: minimize total compute delay assuming each
    stage runs on its *fastest* candidate (the endpoints are pinned, so the
    source-CPU penalty is respected, reproducing the paper's 'only layer 1 on the
    CPU' behaviour).  Segments that fit no candidate of V^k are infeasible
    (constraints (14)-(15) are part of the paper's step-1 ILP)."""
    b = request.batch_size
    ev = PlanEvaluator(net, profile, request)

    def stage_comp(k: int, lo: int, hi: int) -> float:
        if not _fits_some_candidate(ev, candidates[k], lo, hi):
            return INF
        best = INF
        for i in candidates[k]:
            cm = net.nodes[i].compute
            c = sum(
                cm.comp_time_s(b, profile.seg_flops(lo, hi, d))
                for d in dirs_for_mode(request.mode)
            )
            best = min(best, c)
        return best + _balance_tiebreak(profile, lo, hi)

    return _dp_split(profile.L, K, stage_comp)


def comm_ms_split(
    profile: ModelProfile,
    request: ServiceChainRequest,
    K: int,
    net: PhysicalNetwork | None = None,
    candidates: list[list[str]] | None = None,
) -> list[tuple[int, int]] | None:
    """Communication-oriented splitting: minimize the cumulative smashed-data size
    over the K-1 cuts (FW, plus BW when training)."""
    ev = PlanEvaluator(net, profile, request) if net is not None else None

    def seg_comm(k: int, lo: int, hi: int) -> float:
        if ev is not None and candidates is not None:
            if not _fits_some_candidate(ev, candidates[k], lo, hi):
                return INF
        comm = 0.0
        if hi < profile.L:  # last segment ships nothing (psi_K = 0)
            comm = sum(profile.cut_bytes(hi, d) for d in dirs_for_mode(request.mode))
        return comm + _balance_tiebreak(profile, lo, hi)

    return _dp_split(profile.L, K, seg_comm)


def comp_balance_split(
    net: PhysicalNetwork,
    profile: ModelProfile,
    request: ServiceChainRequest,
    K: int,
    candidates: list[list[str]],
    cache: EvalCache | None = None,
) -> list[tuple[int, int]] | None:
    """Compute-balanced splitting: each stage costed at its *fastest* feasible
    candidate, with a quadratic penalty so the DP balances stage times instead
    of summing them — a minimax surrogate expressible in the min-sum DP.  Used
    as the pipelined BCD's second initialization: the pipeline bottleneck
    rewards balanced stages, which the even/min-sum splits don't target."""
    ev = PlanEvaluator(net, profile, request, cache=cache)

    def stage_cost(k: int, lo: int, hi: int) -> float:
        best = INF
        for i in candidates[k]:
            if ev.segment_fits(i, lo, hi):
                best = min(best, ev.segment_comp_s(i, lo, hi))
        if best == INF:
            return INF
        return best * best

    return _dp_split(profile.L, K, stage_cost)


def min_memory_split(
    profile: ModelProfile, request: ServiceChainRequest, K: int
) -> list[tuple[int, int]] | None:
    """Capacity-aware fallback initial split: minimize sum of per-segment memory
    loads (params + b * peak smashed), which spreads heavy segments."""

    def seg_mem(k: int, lo: int, hi: int) -> float:
        m = profile.seg_mem_bytes(lo, hi)
        m += request.batch_size * profile.seg_peak_smashed(lo, hi, request.mode)
        return m * m  # quadratic penalty balances instead of piling up

    return _dp_split(profile.L, K, seg_mem)


def _two_step(
    net: PhysicalNetwork,
    profile: ModelProfile,
    request: ServiceChainRequest,
    K: int,
    candidates: list[list[str]],
    segments: list[tuple[int, int]] | None,
    name: str,
    cache: EvalCache | None = None,
) -> SolveResult:
    t0 = time.perf_counter()
    if segments is None:
        return SolveResult(None, None, time.perf_counter() - t0, solver=name)
    plan = dfts(net, profile, request, segments, candidates, cache=cache)
    if plan is None:
        return SolveResult(None, None, time.perf_counter() - t0, solver=name)
    ev = PlanEvaluator(net, profile, request, cache=cache)
    return SolveResult(plan, ev.evaluate(plan), time.perf_counter() - t0, 1,
                       solver=name)


@register_solver("comp-ms", schedules=(SEQ, PIPE),
                 description="paper comparison scheme: computation-oriented "
                             "split, then schedule-aware DFTS")
def comp_ms_solve(net, profile, request, K, candidates,
                  cache: EvalCache | None = None) -> SolveResult:
    segs = comp_ms_split(net, profile, request, K, candidates)
    return _two_step(net, profile, request, K, candidates, segs, "comp-ms", cache)


@register_solver("comm-ms", schedules=(SEQ, PIPE),
                 description="paper comparison scheme: communication-oriented "
                             "split, then schedule-aware DFTS")
def comm_ms_solve(net, profile, request, K, candidates,
                  cache: EvalCache | None = None) -> SolveResult:
    segs = comm_ms_split(profile, request, K, net, candidates)
    return _two_step(net, profile, request, K, candidates, segs, "comm-ms", cache)
