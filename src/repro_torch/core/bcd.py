"""Block Coordinate Descent heuristic (paper Alg. 1).

Alternates (1) model splitting via K-sequence segmentation DP and (2) model
placement + chaining via DFTS until the objective change is <= eps.  BCD is not
guaranteed to reach the global optimum (Sec. V-D) but converges monotonically:
each half-step is an exact minimization of its block with the other fixed.

Schedule-aware: for pipelined requests both blocks minimize the pipelined
objective (their dispatchers route to the capped-bottleneck variants), and the
result is *anchored* against the sequential-objective BCD solution — the
pipelined schedule can always execute the seq-optimized plan, so we return
whichever plan has the lower pipelined latency.  This guarantees
BCD-pipe latency <= pipe-eval(BCD-seq plan) <= BCD-seq latency for every
instance (the suite-level "pipe <= seq" invariant), even if the two heuristic
trajectories reach different coordinate-wise optima.
"""
from __future__ import annotations

import time
from dataclasses import replace

from .costmodel import PIPE, SEQ, ModelProfile, even_split
from .dfts import dfts
from .engine import register_solver
from .network import PhysicalNetwork
from .plan import (EvalCache, Plan, PlanEvaluator, ServiceChainRequest)
from .problem import SolveResult  # re-exported: legacy import site
from .segmentation import k_sequence_segmentation


def _alternate(
    net: PhysicalNetwork,
    profile: ModelProfile,
    request: ServiceChainRequest,
    candidates: list[list[str]],
    ev: PlanEvaluator,
    cache: EvalCache,
    segments: list[tuple[int, int]],
    eps: float,
    max_iters: int,
) -> tuple[Plan | None, float, list[float], int]:
    """One BCD trajectory (Alg. 1 lines 5-11) from the initial split
    ``segments``: DFTS for x_0, then alternate the two exact block
    minimizations.  Returns (plan, latency, history, iterations)."""
    plan = dfts(net, profile, request, segments, candidates, cache=cache)
    if plan is None:
        return None, float("inf"), [], 0
    prev = ev.latency_s(plan)
    history = [prev]
    iters = 0
    for iters in range(1, max_iters + 1):
        new_segments = k_sequence_segmentation(net, profile, request, plan,
                                               cache=cache)
        if new_segments is None:
            break
        new_plan = dfts(net, profile, request, new_segments, candidates,
                        cache=cache)
        if new_plan is None:
            break
        cur = ev.latency_s(new_plan)
        plan = new_plan
        history.append(cur)
        if abs(cur - prev) <= eps:
            prev = cur
            break
        prev = cur
    return plan, prev, history, iters


@register_solver("bcd", schedules=(SEQ, PIPE),
                 description="paper Alg. 1 heuristic: alternate K-seq "
                             "segmentation and DFTS; monotone, seq-anchored "
                             "under pipe")
def bcd_solve(
    net: PhysicalNetwork,
    profile: ModelProfile,
    request: ServiceChainRequest,
    K: int,
    candidates: list[list[str]],
    eps: float = 0.0,
    max_iters: int = 50,
    cache: EvalCache | None = None,
) -> SolveResult:
    t0 = time.perf_counter()
    cache = cache if cache is not None else EvalCache()
    ev = PlanEvaluator(net, profile, request, cache=cache)
    pipelined = request.schedule == PIPE and request.microbatches() > 1

    # initialization (Alg. 1 lines 1-4): even split y_0, then DFTS for x_0.
    segments = even_split(profile.L, K)
    plan, prev, history, iters = _alternate(net, profile, request, candidates,
                                            ev, cache, segments, eps, max_iters)
    if plan is None:
        # The even split y_0 may itself violate (14)-(15) everywhere.  Fall back
        # to a capacity-aware initial split: minimize the per-segment peak memory
        # (min over placements) via the same DP machinery with a greedy balance.
        from .baselines import min_memory_split  # local import avoids a cycle

        segments = min_memory_split(profile, request, K)
        if segments is not None:
            plan, prev, history, iters = _alternate(
                net, profile, request, candidates, ev, cache, segments, eps,
                max_iters)
    if plan is None:
        return SolveResult(None, None, time.perf_counter() - t0, 0)

    if pipelined:
        # Second start from a compute-balanced split: the pipeline bottleneck
        # rewards balanced stages, a shape the even split's trajectory often
        # cannot reach by coordinate descent alone.
        from .baselines import comp_balance_split  # local import avoids a cycle

        bal = comp_balance_split(net, profile, request, K, candidates,
                                 cache=cache)
        if bal is not None and bal != segments:
            plan2, prev2, history2, iters2 = _alternate(
                net, profile, request, candidates, ev, cache, bal, eps,
                max_iters)
            if plan2 is not None and prev2 < prev:
                plan, prev, history, iters = plan2, prev2, history2, iters2

        # Seq-anchor: the pipelined schedule can always run the plan the
        # sequential-objective BCD found; keep whichever is better under the
        # pipelined objective (see module docstring).
        seq_req = replace(request, schedule=SEQ, n_microbatches=1)
        seq_res = bcd_solve(net, profile, seq_req, K, candidates, eps=eps,
                            max_iters=max_iters, cache=cache)
        if seq_res.plan is not None:
            anchor = ev.latency_s(seq_res.plan)
            if anchor < prev:
                plan, prev = seq_res.plan, anchor
                history.append(anchor)

    return SolveResult(plan, ev.evaluate(plan), time.perf_counter() - t0, iters,
                       history, solver="bcd")
