"""DFTS — shortest path tour search for model placement + chaining given a fixed
splitting y (paper Sec. V-C, [22], [24]).

Implemented as the layered-graph / stage-wise search over the modified augmented
network: stage k expands every candidate i in V^k by charging the imaginary-link
cost c^k_{i, v_hat_ik} (compute, Eq. (17), FW + BW if training) and physical-link
costs c^k_{i,j} (Sec. V-C) that depend on the smashed-data size of the preceding
cut.  This attains the optimal placement + chaining for the given y because the
formulation has no link-capacity coupling between subpaths — each subpath is
independently a shortest path.

Stage relaxation is the min-composition of *cached* single-source frontiers
(`PhysicalNetwork.sssp`): dist_k(i) = min_{j in stage k-1} best[j] + sp_j(i),
which is exactly the multi-source Dijkstra result but lets every frontier be
reused across BCD iterations, schemes, seeds, and sweep grid points that share
the (network, smashed-data size) pair.  Complexity O((K+1) S E log V) cold with
S = |V^k| sources per stage (S <= 2 in the paper's scenarios), O((K+1) S V)
warm, matching the paper's Sec. V-D up to the candidate-set factor.
"""
from __future__ import annotations

import numpy as np

from .costmodel import BW, FW, PIPE, TR, ModelProfile
from .network import PhysicalNetwork, transmission_time_s
from .plan import EvalCache, Plan, PlanEvaluator, ServiceChainRequest
from .trainpipe import round_trip_taus, segment_comp_dir_s

INF = float("inf")


def _backtrack(parent: dict[str, str | None], end: str, sources: set[str]) -> list[str]:
    path, cur = [end], end
    while cur not in sources:
        cur = parent[cur]
        assert cur is not None, "broken parent chain"
        path.append(cur)
    return path[::-1]


def _relax_stage_scalar(
    net: PhysicalNetwork,
    best: dict[str, float],
    fw_bytes: float,
    bw_bytes: float | None,
    targets: list[str],
    trans_cap: float | None = None,
    trans_scale: float = 1.0,
    trans_cap_bw: float | None = None,
) -> dict[str, tuple[float, str]]:
    """Reference scalar relaxation: per-target min over cached frontier dicts.
    Kept as the equivalence oracle for `_relax_stage` (tests assert bit-for-bit
    agreement); the hot path below vectorizes the same min-plus composition."""
    frontiers = {s: net.sssp(s, fw_bytes, bw_bytes, trans_cap, trans_scale,
                             trans_cap_bw)
                 for s in best}
    out: dict[str, tuple[float, str]] = {}
    for t in targets:
        bd, bs = INF, None
        for s, d0 in best.items():
            d = d0 + frontiers[s][0][t]
            if d < bd:
                bd, bs = d, s
        if bs is not None:
            out[t] = (bd, bs)
    return out


def _relax_stage(
    net: PhysicalNetwork,
    best: dict[str, float],
    fw_bytes: float,
    bw_bytes: float | None,
    targets: list[str],
    trans_cap: float | None = None,
    trans_scale: float = 1.0,
    trans_cap_bw: float | None = None,
) -> dict[str, tuple[float, str]]:
    """target -> (dist, argmin source) as a vectorized min-plus composition.

    dist = (d0[:, None] + D)[.., targets].min(axis=0) over the network's dense
    [S, V] frontier matrix D (`PhysicalNetwork.frontier_matrix`), which is
    cached per (sources, smashed-data size) and therefore shared across every
    relaxation of an admission round / BCD iteration.  Bit-for-bit identical
    to `_relax_stage_scalar`: same additions in the same source order, and
    `argmin` picks the first minimal source exactly like the scalar scan.
    """
    if not targets:
        return {}
    srcs = tuple(best)
    D = net.frontier_matrix(srcs, fw_bytes, bw_bytes, trans_cap, trans_scale,
                            trans_cap_bw)
    idx = net.node_index()
    cols = [idx[t] for t in targets]
    comp = np.asarray([best[s] for s in srcs])[:, None] + D[:, cols]  # [S, T]
    amin = np.argmin(comp, axis=0)
    out: dict[str, tuple[float, str]] = {}
    for j, t in enumerate(targets):
        d = comp[amin[j], j]
        if d < INF:
            out[t] = (float(d), srcs[amin[j]])
    return out


def _stage_path(net: PhysicalNetwork, src: str, dst: str, fw_bytes: float,
                bw_bytes: float | None, trans_cap: float | None = None,
                trans_scale: float = 1.0,
                trans_cap_bw: float | None = None) -> list[str]:
    _, parent = net.sssp(src, fw_bytes, bw_bytes, trans_cap, trans_scale,
                         trans_cap_bw)
    return _backtrack(parent, dst, {src})


def dfts(
    net: PhysicalNetwork,
    profile: ModelProfile,
    request: ServiceChainRequest,
    segments: list[tuple[int, int]],
    candidates: list[list[str]],
    cache: EvalCache | None = None,
) -> Plan | None:
    """Optimal placement + chaining for fixed segments.  Returns None if every
    placement is capacity-infeasible (imaginary links pruned, Sec. V-C).

    Pipelined requests (schedule="pipe", M > 1) are routed to the
    bottleneck-capped tour search `_dfts_pipe`, which is exact for the
    pipelined objective fill + (M-1)*tau/M; pipelined *training* requests go
    through `_dfts_pipe_tr`, exact for the round-trip objective
    fill + (M-1)/M * (tau_fw + tau_bw) (docs/training.md)."""
    if request.schedule == PIPE and request.microbatches() > 1:
        if request.mode == TR:
            return _dfts_pipe_tr(net, profile, request, segments, candidates,
                                 cache)
        return _dfts_pipe(net, profile, request, segments, candidates, cache)
    K = len(segments)
    assert len(candidates) == K
    ev = PlanEvaluator(net, profile, request, cache=cache)
    b = request.batch_size
    training = request.mode == TR

    # stage 1: enter F^1 at each feasible candidate (subpath S_1 is uncharged in
    # Eq. (16); the paper pins V^1 = {s}).
    best: dict[str, float] = {}
    pred_node: list[dict[str, str]] = [dict() for _ in range(K)]
    cut_sizes: list[tuple[float, float | None]] = [(0.0, None)] * K
    lo, hi = segments[0]
    for i in candidates[0]:
        if ev.segment_fits(i, lo, hi):
            best[i] = ev.segment_comp_s(i, lo, hi)
    if not best:
        return None

    for k in range(1, K):
        cut = segments[k - 1][1]
        fw_bytes = b * profile.cut_bytes(cut, FW)
        bw_bytes = b * profile.cut_bytes(cut, BW) if training else None
        cut_sizes[k] = (fw_bytes, bw_bytes)
        lo, hi = segments[k]
        feas = [i for i in candidates[k] if ev.segment_fits(i, lo, hi)]
        reached = _relax_stage(net, best, fw_bytes, bw_bytes, feas)
        nxt: dict[str, float] = {}
        for i, (dist, src) in reached.items():
            if dist < INF:
                nxt[i] = dist + ev.segment_comp_s(i, segments[k][0], segments[k][1])
                pred_node[k][i] = src
        if not nxt:
            return None
        best = nxt

    # tail subpath S_{K+1}: psi_K = 0, propagation-only (FW + BW if training).
    tail_bw = 0.0 if training else None
    reached = _relax_stage(net, best, 0.0, tail_bw, [request.destination])
    if request.destination not in reached or reached[request.destination][0] == INF:
        return None
    tail_src = reached[request.destination][1]
    tail = _stage_path(net, tail_src, request.destination, 0.0, tail_bw)

    # backtrack placement and subpaths
    placement = [""] * K
    placement[K - 1] = tail_src
    for k in range(K - 1, 0, -1):
        placement[k - 1] = pred_node[k][placement[k]]
    paths = [
        _stage_path(net, placement[k - 1], placement[k], *cut_sizes[k])
        for k in range(1, K)
    ]
    tail_path = tail if len(tail) > 1 else []
    return Plan(segments=list(segments), placement=placement, paths=paths,
                tail_path=tail_path)


def _capped_tour(
    net: PhysicalNetwork,
    request: ServiceChainRequest,
    segments: list[tuple[int, int]],
    comp: list[dict[str, float]],
    cut_sizes: list[tuple[float, float | None]],
    cap: float | None,
    inv_M: float,
) -> Plan | None:
    """One bottleneck-capped tour: the sequential stage search with candidate
    nodes pruned to comp <= cap, links pruned to trans <= cap, and transmission
    scaled by 1/M — minimizes the pipeline *fill* among plans whose every stage
    fits under ``cap``."""
    K = len(segments)
    best = {i: c * inv_M for i, c in comp[0].items()
            if cap is None or c <= cap}
    if not best:
        return None
    pred_node: list[dict[str, str]] = [dict() for _ in range(K)]
    for k in range(1, K):
        fw_bytes, bw_bytes = cut_sizes[k]
        feas = [i for i, c in comp[k].items() if cap is None or c <= cap]
        reached = _relax_stage(net, best, fw_bytes, bw_bytes, feas, cap, inv_M)
        nxt: dict[str, float] = {}
        for i, (dist, src) in reached.items():
            if dist < INF:
                nxt[i] = dist + comp[k][i] * inv_M
                pred_node[k][i] = src
        if not nxt:
            return None
        best = nxt

    # The evaluator charges the psi_K = 0 tail in the FW direction only
    # (Eq. 16's S_{K+1}); the tour must use the same convention so its fill
    # equals the evaluator's and the cap-scan incumbent bound stays exact.
    tail_bw = None
    reached = _relax_stage(net, best, 0.0, tail_bw, [request.destination],
                           cap, inv_M)
    if request.destination not in reached:
        return None
    tail_src = reached[request.destination][1]
    tail = _stage_path(net, tail_src, request.destination, 0.0, tail_bw,
                       cap, inv_M)

    placement = [""] * K
    placement[K - 1] = tail_src
    for k in range(K - 1, 0, -1):
        placement[k - 1] = pred_node[k][placement[k]]
    paths = [
        _stage_path(net, placement[k - 1], placement[k], *cut_sizes[k],
                    cap, inv_M)
        for k in range(1, K)
    ]
    return Plan(segments=list(segments), placement=placement, paths=paths,
                tail_path=tail if len(tail) > 1 else [])


def _dfts_pipe(
    net: PhysicalNetwork,
    profile: ModelProfile,
    request: ServiceChainRequest,
    segments: list[tuple[int, int]],
    candidates: list[list[str]],
    cache: EvalCache | None = None,
) -> Plan | None:
    """Optimal placement + chaining for fixed segments under the *pipelined*
    objective fill + (M-1)/M * tau (docs/pipeline.md).

    The fill part is additive along the tour (comp/M imaginary links, trans/M +
    prop physical links) but the bottleneck tau = max stage time is not, so the
    search scans candidate bottleneck caps: for each cap tau, prune stages
    slower than tau and minimize fill with the sequential tour machinery; the
    optimum's bottleneck is one of the finitely many stage-time values, so
    taking the best evaluated plan over the scan is exact.  An incumbent bound
    prunes caps that can no longer contain the optimum's bottleneck
    ((M-1)/M * tau + min_fill >= best) and caps at or above the unconstrained
    plan's bottleneck (they reproduce the unconstrained plan).
    """
    K = len(segments)
    assert len(candidates) == K
    ev = PlanEvaluator(net, profile, request, cache=cache)
    b = request.batch_size
    training = request.mode == TR
    M = request.microbatches()
    inv_M = 1.0 / M
    c_bub = (M - 1) / M

    comp: list[dict[str, float]] = []
    for k, (lo, hi) in enumerate(segments):
        comp.append({i: ev.segment_comp_s(i, lo, hi) for i in candidates[k]
                     if ev.segment_fits(i, lo, hi)})
        if not comp[k]:
            return None

    cut_sizes: list[tuple[float, float | None]] = [(0.0, None)] * K
    for k in range(1, K):
        cut = segments[k - 1][1]
        fw = b * profile.cut_bytes(cut, FW)
        bw = b * profile.cut_bytes(cut, BW) if training else None
        cut_sizes[k] = (fw, bw)

    # Candidate bottleneck values: every stage time any plan can exhibit.
    lb = max(min(c.values()) for c in comp)
    taus = {v for c in comp for v in c.values()}
    for k in range(1, K):
        fw, bw = cut_sizes[k]
        for (u, v) in net.links:
            taus.add(net.link_trans_s(u, v, fw, bw))
    cand_taus = sorted(t for t in taus if t >= lb)

    plan0 = _capped_tour(net, request, segments, comp, cut_sizes, None, inv_M)
    if plan0 is None:
        return None
    best_plan, best_lb = plan0, ev.evaluate(plan0)
    best_lat = best_lb.total_s
    fill_min = (best_lb.computation_s + best_lb.transmission_s
                + best_lb.propagation_s)
    tau0 = ev.bottleneck_s(plan0)

    for tau in cand_taus:
        if tau >= tau0 or fill_min + c_bub * tau >= best_lat:
            break
        plan_t = _capped_tour(net, request, segments, comp, cut_sizes, tau,
                              inv_M)
        if plan_t is None:
            continue
        lat = ev.latency_s(plan_t)
        if lat < best_lat:
            best_plan, best_lat = plan_t, lat
    return best_plan


def _capped_tour_tr(
    net: PhysicalNetwork,
    request: ServiceChainRequest,
    segments: list[tuple[int, int]],
    comp: list[dict[str, float]],
    comp_fw: list[dict[str, float]],
    comp_bw: list[dict[str, float]],
    cut_sizes: list[tuple[float, float | None]],
    cap_fw: float,
    cap_bw: float,
    inv_M: float,
) -> Plan | None:
    """One per-direction-capped round-trip tour: candidates pruned to
    comp_fw <= cap_fw AND comp_bw <= cap_bw, links pruned per direction
    (activation occupancy <= cap_fw, gradient occupancy <= cap_bw), fused
    transmission scaled by 1/M — minimizes the round-trip *fill* (which is
    additive: both directions' t/M shares plus both propagation delays per
    link) among plans whose per-direction bottlenecks fit under the caps."""
    K = len(segments)
    best = {i: c * inv_M for i, c in comp[0].items()
            if comp_fw[0][i] <= cap_fw and comp_bw[0][i] <= cap_bw}
    if not best:
        return None
    pred_node: list[dict[str, str]] = [dict() for _ in range(K)]
    for k in range(1, K):
        fw_bytes, bw_bytes = cut_sizes[k]
        feas = [i for i in comp[k]
                if comp_fw[k][i] <= cap_fw and comp_bw[k][i] <= cap_bw]
        reached = _relax_stage(net, best, fw_bytes, bw_bytes, feas, cap_fw,
                               inv_M, cap_bw)
        nxt: dict[str, float] = {}
        for i, (dist, src) in reached.items():
            if dist < INF:
                nxt[i] = dist + comp[k][i] * inv_M
                pred_node[k][i] = src
        if not nxt:
            return None
        best = nxt

    # psi_K = 0 tail: FW-propagation-only, matching the round-trip evaluator
    # (zero bytes ship, so the caps never prune a tail link).
    tail_bw = None
    reached = _relax_stage(net, best, 0.0, tail_bw, [request.destination],
                           cap_fw, inv_M)
    if request.destination not in reached:
        return None
    tail_src = reached[request.destination][1]
    tail = _stage_path(net, tail_src, request.destination, 0.0, tail_bw,
                       cap_fw, inv_M)

    placement = [""] * K
    placement[K - 1] = tail_src
    for k in range(K - 1, 0, -1):
        placement[k - 1] = pred_node[k][placement[k]]
    paths = [
        _stage_path(net, placement[k - 1], placement[k], *cut_sizes[k],
                    cap_fw, inv_M, cap_bw)
        for k in range(1, K)
    ]
    return Plan(segments=list(segments), placement=placement, paths=paths,
                tail_path=tail if len(tail) > 1 else [])


def _dfts_pipe_tr(
    net: PhysicalNetwork,
    profile: ModelProfile,
    request: ServiceChainRequest,
    segments: list[tuple[int, int]],
    candidates: list[list[str]],
    cache: EvalCache | None = None,
) -> Plan | None:
    """Optimal placement + chaining for fixed segments under the *round-trip*
    training objective fill_rt + (M-1)/M * (tau_fw + tau_bw)
    (docs/training.md).

    The fill is additive along the tour exactly like the fused pipelined fill
    (both directions' transmission/M + both propagation delays per link), but
    the drain couples two bottlenecks — the slowest forward stage and the
    slowest backward stage.  The search therefore scans candidate cap *pairs*
    (F, B) over the per-direction stage-time value sets, sorted by F + B
    ascending: for each pair, prune stages to comp_fw <= F, comp_bw <= B and
    links per direction, then minimize fill with the sequential tour
    machinery.  Any plan's exact (tau_fw, tau_bw) pair is in the grid, so
    taking the best evaluated plan over the scan is exact.  The incumbent
    bound min_fill + (M-1)/M * (F + B) >= best prunes the tail of the sorted
    scan (every remaining pair's optimum is at least that), and pairs
    dominating the unconstrained plan's bottlenecks (F >= tau_fw0 and
    B >= tau_bw0) reproduce plans that cannot beat it.
    """
    K = len(segments)
    assert len(candidates) == K
    ev = PlanEvaluator(net, profile, request, cache=cache)
    b = request.batch_size
    M = request.microbatches()
    inv_M = 1.0 / M
    c_bub = (M - 1) / M

    comp: list[dict[str, float]] = []
    comp_fw: list[dict[str, float]] = []
    comp_bw: list[dict[str, float]] = []
    for k, (lo, hi) in enumerate(segments):
        feas = [i for i in candidates[k] if ev.segment_fits(i, lo, hi)]
        if not feas:
            return None
        comp.append({i: ev.segment_comp_s(i, lo, hi) for i in feas})
        comp_fw.append({i: segment_comp_dir_s(ev, i, lo, hi, FW)
                        for i in feas})
        comp_bw.append({i: segment_comp_dir_s(ev, i, lo, hi, BW)
                        for i in feas})

    cut_sizes: list[tuple[float, float | None]] = [(0.0, None)] * K
    for k in range(1, K):
        cut = segments[k - 1][1]
        cut_sizes[k] = (b * profile.cut_bytes(cut, FW),
                        b * profile.cut_bytes(cut, BW))

    # Per-direction candidate bottleneck values: every forward (resp.
    # backward) stage time any plan over these segments can exhibit.
    lb_fw = max(min(c.values()) for c in comp_fw)
    lb_bw = max(min(c.values()) for c in comp_bw)
    fw_vals = {v for c in comp_fw for v in c.values()}
    bw_vals = {v for c in comp_bw for v in c.values()}
    for k in range(1, K):
        fw_bytes, bw_bytes = cut_sizes[k]
        for (u, v), spec in net.links.items():
            fw_vals.add(transmission_time_s(fw_bytes, spec.bw_fw))
            bw_vals.add(transmission_time_s(bw_bytes, spec.bw_bw))
    cand_fw = sorted(t for t in fw_vals if t >= lb_fw)
    cand_bw = sorted(t for t in bw_vals if t >= lb_bw)

    plan0 = _capped_tour(net, request, segments, comp, cut_sizes, None, inv_M)
    if plan0 is None:
        return None
    best_plan, best_lb = plan0, ev.evaluate(plan0)
    best_lat = best_lb.total_s
    fill_min = (best_lb.computation_s + best_lb.transmission_s
                + best_lb.propagation_s)
    tau_fw0, tau_bw0 = round_trip_taus(ev, plan0)

    pairs = sorted(((F, B) for F in cand_fw for B in cand_bw),
                   key=lambda p: (p[0] + p[1], p[0]))
    for F, B in pairs:
        if fill_min + c_bub * (F + B) >= best_lat:
            break
        if F >= tau_fw0 and B >= tau_bw0:
            continue
        plan_t = _capped_tour_tr(net, request, segments, comp, comp_fw,
                                 comp_bw, cut_sizes, F, B, inv_M)
        if plan_t is None:
            continue
        lat = ev.latency_s(plan_t)
        if lat < best_lat:
            best_plan, best_lat = plan_t, lat
    return best_plan
