"""Exact joint solver for splitting + placement + chaining.

Because the ILP (Sec. IV) has *no link-capacity constraints* (only per-node
memory/storage, which bind per sub-model), every inter-stage subpath is
independently a shortest path for its cut's smashed-data size.  The joint problem
therefore admits an exact dynamic program over states (segment k, end layer e,
host node i):

  dp[k][e][i] = min over (e' < e, j in V^{k-1}) of
      dp[k-1][e'][j] + sp_cost(j -> i; delta_{e'}) + comp(i, layers e'+1..e)

with sp_cost from per-cut-size Dijkstras.  dp[K][L][i] + tail(i -> d) attains the
ILP optimum (cross-checked against the HiGHS MILP in tests).  Complexity
O(L V (E log V)) precompute + O(K L^2 |V^k|^2) DP — this is our fast optimal
oracle for the latency grids where the MILP would be slow.
"""
from __future__ import annotations

import time

from .costmodel import BW, FW, PIPE, SEQ, TR, ModelProfile
from .dfts import _backtrack
from .engine import register_solver
from .network import PhysicalNetwork, transmission_time_s
from .plan import EvalCache, Plan, PlanEvaluator, ServiceChainRequest
from .problem import SolveResult
from .trainpipe import round_trip_taus, segment_comp_dir_s

INF = float("inf")


@register_solver("exact", schedules=(SEQ, PIPE), optimal=True,
                 description="ILP-equivalent joint DP (fast optimal oracle); "
                             "pipelined variant exact via bottleneck-cap scan")
def exact_solve(
    net: PhysicalNetwork,
    profile: ModelProfile,
    request: ServiceChainRequest,
    K: int,
    candidates: list[list[str]],
    cache: EvalCache | None = None,
) -> SolveResult:
    if request.schedule == PIPE and request.microbatches() > 1:
        if request.mode == TR:
            return _exact_pipe_tr(net, profile, request, K, candidates, cache)
        return _exact_pipe(net, profile, request, K, candidates, cache)
    t0 = time.perf_counter()
    L = profile.L
    ev = PlanEvaluator(net, profile, request, cache=cache)
    b = request.batch_size
    training = request.mode == TR

    # --- per-cut shortest-path tables between candidate nodes ------------------
    # sp[cut][j] = (dist map, parent map) from source j with the cut's link costs;
    # served from the network's frontier cache, shared across solver calls.
    sources = sorted({j for cand in candidates[:-1] for j in cand})
    sp: dict[tuple[int, str], tuple[dict[str, float], dict[str, str | None]]] = {}
    for cut in range(1, L):
        fw = b * profile.cut_bytes(cut, FW)
        bw = b * profile.cut_bytes(cut, BW) if training else None
        for j in sources:
            sp[(cut, j)] = net.sssp(j, fw, bw)

    # --- DP ---------------------------------------------------------------------
    # dp[k][e][i]; store parents for reconstruction.
    dp: list[dict[tuple[int, str], float]] = [dict() for _ in range(K + 1)]
    par: list[dict[tuple[int, str], tuple[int, str]]] = [dict() for _ in range(K + 1)]
    for e in range(1, L - K + 2):
        for i in candidates[0]:
            if ev.segment_fits(i, 1, e):
                dp[1][(e, i)] = ev.segment_comp_s(i, 1, e)
    for k in range(2, K + 1):
        e_vals = range(k, L - K + k + 1) if k < K else [L]
        for e in e_vals:
            for i in candidates[k - 1]:
                best, best_par = INF, None
                for (e2, j), prev in dp[k - 1].items():
                    if e2 >= e:
                        continue
                    if not ev.segment_fits(i, e2 + 1, e):
                        continue
                    d = sp[(e2, j)][0][i]
                    if d == INF:
                        continue
                    c = prev + d + ev.segment_comp_s(i, e2 + 1, e)
                    if c < best:
                        best, best_par = c, (e2, j)
                if best < INF:
                    dp[k][(e, i)] = best
                    par[k][(e, i)] = best_par  # type: ignore[assignment]

    # --- tail: placement of F^K -> destination, propagation only ---------------
    tail_bw = 0.0 if training else None
    best_total, best_state, tail_path = INF, None, []
    finals = {i: c for (e, i), c in dp[K].items() if e == L}
    if not finals:
        return SolveResult(None, None, time.perf_counter() - t0, solver="exact")
    dist, parent = net.dijkstra(dict(finals), 0.0, tail_bw)
    if dist[request.destination] == INF:
        return SolveResult(None, None, time.perf_counter() - t0, solver="exact")
    best_total = dist[request.destination]
    tail = _backtrack(parent, request.destination, set(finals))
    best_state = (L, tail[0])
    tail_path = tail if len(tail) > 1 else []

    # --- reconstruct ------------------------------------------------------------
    states = [best_state]
    for k in range(K, 1, -1):
        states.append(par[k][states[-1]])
    states.reverse()  # [(e_1, i_1), ..., (e_K=L, i_K)]
    segments, placement, paths = [], [], []
    lo = 1
    for (e, i) in states:
        segments.append((lo, e))
        placement.append(i)
        lo = e + 1
    for k in range(1, K):
        cut = segments[k - 1][1]
        j, i = placement[k - 1], placement[k]
        _, p = sp[(cut, j)]
        paths.append(_backtrack(p, i, {j}))
    plan = Plan(segments=segments, placement=placement, paths=paths,
                tail_path=tail_path)
    ev.check(plan)
    return SolveResult(plan, ev.evaluate(plan), time.perf_counter() - t0,
                       solver="exact")


def _joint_dp_capped(
    net: PhysicalNetwork,
    profile: ModelProfile,
    request: ServiceChainRequest,
    K: int,
    candidates: list[list[str]],
    ev: PlanEvaluator,
    cap: float | None,
    inv_M: float,
) -> Plan | None:
    """One bottleneck-capped run of the joint DP: minimize the pipeline *fill*
    (comp/M at hosts, trans/M + propagation along subpaths) over splitting +
    placement + chaining, with every stage — host compute and single-link
    transmission — at most ``cap``.  The capped/scaled shortest paths come from
    the network's frontier cache, so repeated caps are free."""
    L = profile.L
    b = request.batch_size
    training = request.mode == TR

    def comp_ok(i: str, lo: int, hi: int) -> float | None:
        if not ev.segment_fits(i, lo, hi):
            return None
        c = ev.segment_comp_s(i, lo, hi)
        if cap is not None and c > cap:
            return None
        return c

    sources = sorted({j for cand in candidates[:-1] for j in cand})
    sp: dict[tuple[int, str], tuple[dict[str, float], dict[str, str | None]]] = {}
    for cut in range(1, L):
        fw = b * profile.cut_bytes(cut, FW)
        bw = b * profile.cut_bytes(cut, BW) if training else None
        for j in sources:
            sp[(cut, j)] = net.sssp(j, fw, bw, cap, inv_M)

    dp: list[dict[tuple[int, str], float]] = [dict() for _ in range(K + 1)]
    par: list[dict[tuple[int, str], tuple[int, str]]] = [dict() for _ in range(K + 1)]
    for e in range(1, L - K + 2):
        for i in candidates[0]:
            c = comp_ok(i, 1, e)
            if c is not None:
                dp[1][(e, i)] = c * inv_M
    for k in range(2, K + 1):
        e_vals = range(k, L - K + k + 1) if k < K else [L]
        for e in e_vals:
            for i in candidates[k - 1]:
                best, best_par = INF, None
                for (e2, j), prev in dp[k - 1].items():
                    if e2 >= e:
                        continue
                    c = comp_ok(i, e2 + 1, e)
                    if c is None:
                        continue
                    d = sp[(e2, j)][0][i]
                    if d == INF:
                        continue
                    tot = prev + d + c * inv_M
                    if tot < best:
                        best, best_par = tot, (e2, j)
                if best < INF:
                    dp[k][(e, i)] = best
                    par[k][(e, i)] = best_par  # type: ignore[assignment]

    # FW-only tail propagation, matching the evaluator's psi_K = 0 convention
    # (keeps the cap-scan incumbent bound exact; see _capped_tour in dfts.py).
    tail_bw = None
    finals = {i: c for (e, i), c in dp[K].items() if e == L}
    if not finals:
        return None
    dist, parent = net.dijkstra(dict(finals), 0.0, tail_bw, cap, inv_M)
    if dist[request.destination] == INF:
        return None
    tail = _backtrack(parent, request.destination, set(finals))
    states = [(L, tail[0])]
    for k in range(K, 1, -1):
        states.append(par[k][states[-1]])
    states.reverse()
    segments, placement, paths = [], [], []
    lo = 1
    for (e, i) in states:
        segments.append((lo, e))
        placement.append(i)
        lo = e + 1
    for k in range(1, K):
        cut = segments[k - 1][1]
        j, i = placement[k - 1], placement[k]
        _, p = sp[(cut, j)]
        paths.append(_backtrack(p, i, {j}))
    return Plan(segments=segments, placement=placement, paths=paths,
                tail_path=tail if len(tail) > 1 else [])


def _exact_pipe(
    net: PhysicalNetwork,
    profile: ModelProfile,
    request: ServiceChainRequest,
    K: int,
    candidates: list[list[str]],
    cache: EvalCache | None = None,
) -> SolveResult:
    """Exact joint solver for the *pipelined* objective fill + (M-1)/M * tau.

    Like `_dfts_pipe` this scans candidate bottleneck caps — here every
    feasible (host, segment) compute time and every (link, cut) transmission
    time — running the capped joint DP per cap and keeping the best evaluated
    plan; the optimum's bottleneck is one of the candidates, so the scan is
    exact.  The incumbent bound (M-1)/M * tau + min_fill >= best prunes the
    scan.  Intended as the parity oracle for BCD-pipe on small instances: the
    scan multiplies the joint DP's cost by the candidate count, so keep L and
    |V^k| small (tests use L <= 10); the sweep suites use BCD for pipelined
    scenarios.
    """
    t0 = time.perf_counter()
    L = profile.L
    ev = PlanEvaluator(net, profile, request, cache=cache)
    b = request.batch_size
    training = request.mode == TR
    M = request.microbatches()
    inv_M = 1.0 / M
    c_bub = (M - 1) / M

    taus: set[float] = set()
    per_stage_min = []
    for k in range(K):
        best_k = INF
        hi_max = L - (K - 1 - k)
        for i in candidates[k]:
            for lo in range(k + 1, hi_max + 1):
                for hi in range(lo, hi_max + 1):
                    if ev.segment_fits(i, lo, hi):
                        c = ev.segment_comp_s(i, lo, hi)
                        taus.add(c)
                        best_k = min(best_k, c)
        if best_k == INF:
            return SolveResult(None, None, time.perf_counter() - t0,
                               solver="exact")
        per_stage_min.append(best_k)
    lb = max(per_stage_min)
    for cut in range(1, L):
        fw = b * profile.cut_bytes(cut, FW)
        bw = b * profile.cut_bytes(cut, BW) if training else None
        for (u, v) in net.links:
            taus.add(net.link_trans_s(u, v, fw, bw))
    cand_taus = sorted(t for t in taus if t >= lb)

    plan0 = _joint_dp_capped(net, profile, request, K, candidates, ev, None,
                             inv_M)
    if plan0 is None:
        return SolveResult(None, None, time.perf_counter() - t0, solver="exact")
    lb0 = ev.evaluate(plan0)
    best_plan, best_lat = plan0, lb0.total_s
    fill_min = lb0.computation_s + lb0.transmission_s + lb0.propagation_s
    tau0 = ev.bottleneck_s(plan0)

    for tau in cand_taus:
        if tau >= tau0 or fill_min + c_bub * tau >= best_lat:
            break
        plan_t = _joint_dp_capped(net, profile, request, K, candidates, ev,
                                  tau, inv_M)
        if plan_t is None:
            continue
        lat = ev.latency_s(plan_t)
        if lat < best_lat:
            best_plan, best_lat = plan_t, lat

    ev.check(best_plan)
    return SolveResult(best_plan, ev.evaluate(best_plan),
                       time.perf_counter() - t0, solver="exact")


def _joint_dp_capped_tr(
    net: PhysicalNetwork,
    profile: ModelProfile,
    request: ServiceChainRequest,
    K: int,
    candidates: list[list[str]],
    ev: PlanEvaluator,
    cap_fw: float,
    cap_bw: float,
    inv_M: float,
) -> Plan | None:
    """One per-direction-capped run of the joint DP (round-trip training):
    minimize the round-trip pipeline *fill* over splitting + placement +
    chaining with every forward stage <= cap_fw and every backward stage
    <= cap_bw — hosts pruned on their per-direction compute, links pruned per
    direction inside the capped shortest paths (docs/training.md)."""
    L = profile.L
    b = request.batch_size

    def comp_ok(i: str, lo: int, hi: int) -> float | None:
        if not ev.segment_fits(i, lo, hi):
            return None
        if (segment_comp_dir_s(ev, i, lo, hi, FW) > cap_fw
                or segment_comp_dir_s(ev, i, lo, hi, BW) > cap_bw):
            return None
        return ev.segment_comp_s(i, lo, hi)

    sources = sorted({j for cand in candidates[:-1] for j in cand})
    sp: dict[tuple[int, str], tuple[dict[str, float], dict[str, str | None]]] = {}
    for cut in range(1, L):
        fw = b * profile.cut_bytes(cut, FW)
        bw = b * profile.cut_bytes(cut, BW)
        for j in sources:
            sp[(cut, j)] = net.sssp(j, fw, bw, cap_fw, inv_M, cap_bw)

    dp: list[dict[tuple[int, str], float]] = [dict() for _ in range(K + 1)]
    par: list[dict[tuple[int, str], tuple[int, str]]] = [dict() for _ in range(K + 1)]
    for e in range(1, L - K + 2):
        for i in candidates[0]:
            c = comp_ok(i, 1, e)
            if c is not None:
                dp[1][(e, i)] = c * inv_M
    for k in range(2, K + 1):
        e_vals = range(k, L - K + k + 1) if k < K else [L]
        for e in e_vals:
            for i in candidates[k - 1]:
                best, best_par = INF, None
                for (e2, j), prev in dp[k - 1].items():
                    if e2 >= e:
                        continue
                    c = comp_ok(i, e2 + 1, e)
                    if c is None:
                        continue
                    d = sp[(e2, j)][0][i]
                    if d == INF:
                        continue
                    tot = prev + d + c * inv_M
                    if tot < best:
                        best, best_par = tot, (e2, j)
                if best < INF:
                    dp[k][(e, i)] = best
                    par[k][(e, i)] = best_par  # type: ignore[assignment]

    # psi_K = 0 tail: FW propagation only, matching the round-trip evaluator.
    tail_bw = None
    finals = {i: c for (e, i), c in dp[K].items() if e == L}
    if not finals:
        return None
    dist, parent = net.dijkstra(dict(finals), 0.0, tail_bw, cap_fw, inv_M)
    if dist[request.destination] == INF:
        return None
    tail = _backtrack(parent, request.destination, set(finals))
    states = [(L, tail[0])]
    for k in range(K, 1, -1):
        states.append(par[k][states[-1]])
    states.reverse()
    segments, placement, paths = [], [], []
    lo = 1
    for (e, i) in states:
        segments.append((lo, e))
        placement.append(i)
        lo = e + 1
    for k in range(1, K):
        cut = segments[k - 1][1]
        j, i = placement[k - 1], placement[k]
        _, p = sp[(cut, j)]
        paths.append(_backtrack(p, i, {j}))
    return Plan(segments=segments, placement=placement, paths=paths,
                tail_path=tail if len(tail) > 1 else [])


def _exact_pipe_tr(
    net: PhysicalNetwork,
    profile: ModelProfile,
    request: ServiceChainRequest,
    K: int,
    candidates: list[list[str]],
    cache: EvalCache | None = None,
) -> SolveResult:
    """Exact joint solver for the *round-trip* training objective
    fill_rt + (M-1)/M * (tau_fw + tau_bw) (docs/training.md).

    Like `_dfts_pipe_tr` this scans candidate per-direction cap pairs (F, B)
    — every feasible (host, segment) per-direction compute time and every
    (link, cut) per-direction transmission time — sorted by F + B ascending
    with the incumbent bound min_fill + (M-1)/M * (F + B) >= best, running
    the per-direction-capped joint DP per pair.  The optimum's exact
    (tau_fw, tau_bw) pair is in the grid, so the scan is exact.  The pair
    grid multiplies the joint DP's cost quadratically: this is the parity
    oracle for BCD-TR-pipe on *small* instances only (tests use L <= 10);
    the sweep suites use BCD for pipelined scenarios.
    """
    t0 = time.perf_counter()
    L = profile.L
    ev = PlanEvaluator(net, profile, request, cache=cache)
    b = request.batch_size
    M = request.microbatches()
    inv_M = 1.0 / M
    c_bub = (M - 1) / M

    fw_vals: set[float] = set()
    bw_vals: set[float] = set()
    lb_fw = lb_bw = 0.0
    for k in range(K):
        best_fw = best_bw = INF
        hi_max = L - (K - 1 - k)
        for i in candidates[k]:
            for lo in range(k + 1, hi_max + 1):
                for hi in range(lo, hi_max + 1):
                    if ev.segment_fits(i, lo, hi):
                        cf = segment_comp_dir_s(ev, i, lo, hi, FW)
                        cb = segment_comp_dir_s(ev, i, lo, hi, BW)
                        fw_vals.add(cf)
                        bw_vals.add(cb)
                        best_fw = min(best_fw, cf)
                        best_bw = min(best_bw, cb)
        if best_fw == INF:
            return SolveResult(None, None, time.perf_counter() - t0,
                               solver="exact")
        lb_fw = max(lb_fw, best_fw)
        lb_bw = max(lb_bw, best_bw)
    for cut in range(1, L):
        fw = b * profile.cut_bytes(cut, FW)
        bw = b * profile.cut_bytes(cut, BW)
        for (u, v), spec in net.links.items():
            fw_vals.add(transmission_time_s(fw, spec.bw_fw))
            bw_vals.add(transmission_time_s(bw, spec.bw_bw))
    cand_fw = sorted(t for t in fw_vals if t >= lb_fw)
    cand_bw = sorted(t for t in bw_vals if t >= lb_bw)

    plan0 = _joint_dp_capped(net, profile, request, K, candidates, ev, None,
                             inv_M)
    if plan0 is None:
        return SolveResult(None, None, time.perf_counter() - t0, solver="exact")
    lb0 = ev.evaluate(plan0)
    best_plan, best_lat = plan0, lb0.total_s
    fill_min = lb0.computation_s + lb0.transmission_s + lb0.propagation_s
    tau_fw0, tau_bw0 = round_trip_taus(ev, plan0)

    pairs = sorted(((F, B) for F in cand_fw for B in cand_bw),
                   key=lambda p: (p[0] + p[1], p[0]))
    for F, B in pairs:
        if fill_min + c_bub * (F + B) >= best_lat:
            break
        if F >= tau_fw0 and B >= tau_bw0:
            continue
        plan_t = _joint_dp_capped_tr(net, profile, request, K, candidates,
                                     ev, F, B, inv_M)
        if plan_t is None:
            continue
        lat = ev.latency_s(plan_t)
        if lat < best_lat:
            best_plan, best_lat = plan_t, lat

    ev.check(best_plan)
    return SolveResult(best_plan, ev.evaluate(best_plan),
                       time.perf_counter() - t0, solver="exact")
