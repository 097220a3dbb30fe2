"""Round-trip pipelined latency model for split *learning* (docs/training.md).

The fused evaluator (plan.py) models training as a per-stage FW+BW sum inside
the inference latency shape: good enough for the sequential schedule (where
only the per-stage totals matter) but wrong for pipelining, because the
backward pass is a *second wave* that traverses the placed chain in reverse —
gradients are their own smashed flow (``delta^BW`` sizes over the links'
backward channels), and the pipeline has two bottlenecks, one per direction.

This module is the round-trip model for ``mode=TR, schedule=pipe, M > 1``
(GPipe-style F-then-B, matching the tick semantics of ``msl/pipeline.py``):

* Every resource is *two* pipeline stages: a hosting node runs a forward pass
  (rho^FW flops) and later a backward pass (rho^BW flops); every physical link
  of subpath k carries ``b * delta^FW`` downstream on its forward channel and
  ``b * delta^BW`` upstream on its backward channel.
* A microbatch's round trip costs its share ``t/M`` of every stage in both
  directions, plus every link's propagation once per direction (the fill), and
  the tail subpath's forward propagation (psi_K = 0, as in Eq. 16).
* Steady state is dominated by the *sum* of the two per-direction bottlenecks:
  after warm-up the chain completes one microbatch round trip every
  ``tau_fw + tau_bw`` seconds (the bottleneck node must run one forward and
  one backward pass per microbatch; the bottleneck link ships one activation
  and one gradient), so the drain term is ``(M-1) * (tau_fw + tau_bw) / M``.

    T_rt = fill_rt + (M-1)/M * (tau_fw + tau_bw)
    fill_rt = sum(all per-direction stage times)/M + all propagation

Sanity anchors (tests/test_trainpipe.py): a uniform K-stage chain with
per-stage forward time f and backward time b reproduces the GPipe schedule
length (M + K - 1) * (f + b); T_rt is <= the sequential TR latency for every
plan (tau_fw <= sum of forward stages, tau_bw <= sum of backward stages); and
the fill equals the fused pipelined fill bit-for-bit-compatible in value, so
the round-trip model only *adds* the second bottleneck to the drain.

``seq``+TR and every IF path never reach this module — the dispatch in
``PlanEvaluator.evaluate`` routes here only for TR+pipe with M > 1, keeping
those anchors bit-for-bit unchanged.
"""
from __future__ import annotations

from .costmodel import BW, FW, TR
from .network import transmission_time_s


def segment_comp_dir_s(ev, node: str, lo: int, hi: int, direction: str) -> float:
    """Single-direction Eq. (17) compute time of sub-model [lo, hi] at node.

    Cached in the evaluator's EvalCache comp table under 8-tuple keys
    ``(node, lo, hi, direction, b, mode, schedule, M)`` — length-disjoint from
    the fused 7-tuple entries, so fused and per-direction values never alias
    even inside a shared cache.
    """
    key = (node, lo, hi, direction, *ev._ck)
    cache = ev.cache
    hit = cache.comp.get(key)
    if hit is not None:
        cache.hits += 1
        return hit
    cache.misses += 1
    cm = ev.net.nodes[node].compute
    t = cm.comp_time_s(ev.request.batch_size,
                       ev.profile.seg_flops(lo, hi, direction))
    cache.comp[key] = t
    return t


def round_trip_stage_times(ev, plan) -> tuple[list[float], list[float]]:
    """(forward, backward) full-batch occupancy of every pipeline resource:
    the K hosting nodes' per-direction compute, then each physical link of
    each inter-stage subpath (activation transfer on the forward channel,
    gradient transfer on the backward channel).  ``max`` of each list is the
    per-direction bottleneck (tau_fw, tau_bw)."""
    fw_times: list[float] = []
    bw_times: list[float] = []
    b = ev.request.batch_size
    for (lo, hi), node in zip(plan.segments, plan.placement):
        fw_times.append(segment_comp_dir_s(ev, node, lo, hi, FW))
        bw_times.append(segment_comp_dir_s(ev, node, lo, hi, BW))
    for k, path in enumerate(plan.paths):
        cut = plan.segments[k][1]
        fw_bytes = b * ev.profile.cut_bytes(cut, FW)
        bw_bytes = b * ev.profile.cut_bytes(cut, BW)
        for u, v in zip(path, path[1:]):
            link = ev.net.links[(u, v)]
            fw_times.append(transmission_time_s(fw_bytes, link.bw_fw))
            bw_times.append(transmission_time_s(bw_bytes, link.bw_bw))
    return fw_times, bw_times


def round_trip_taus(ev, plan) -> tuple[float, float]:
    """(tau_fw, tau_bw): the slowest forward and slowest backward stage."""
    fw_times, bw_times = round_trip_stage_times(ev, plan)
    return max(fw_times), max(bw_times)


def round_trip_bottleneck_s(ev, plan) -> float:
    """Steady-state round-trip period tau_fw + tau_bw: one microbatch
    completes per period once the pipeline is warm, so the serve layer's
    sustainable-rate clamp for a training chain is 1 / this."""
    tau_fw, tau_bw = round_trip_taus(ev, plan)
    return tau_fw + tau_bw


def evaluate_round_trip(ev, plan, n_microbatches: int):
    """Round-trip pipelined latency T_rt = fill_rt + (M-1)/M*(tau_fw+tau_bw).

    The forward wave charges each host's FW compute and each subpath link's
    activation transfer (t/M fill shares, full forward propagation, running
    tau_fw max); the backward wave charges BW compute and gradient transfers
    over the same links' backward channels (the reverse traversal visits the
    same link set, so fill sums iterate subpaths in forward order — the
    decomposition is order-independent).  The psi_K = 0 tail charges forward
    propagation only, exactly like the sequential evaluator.

    The batched twin (``torch_solvers._fast_evaluate``) mirrors this accumulation
    order operation-for-operation — bit parity, not closeness.
    """
    from .plan import LatencyBreakdown  # deferred: plan.py imports this module

    assert ev.request.mode == TR
    M = n_microbatches
    out = LatencyBreakdown()
    b = ev.request.batch_size
    tau_fw = tau_bw = 0.0
    # forward wave: activations flow source -> destination
    for (lo, hi), node in zip(plan.segments, plan.placement):
        t = segment_comp_dir_s(ev, node, lo, hi, FW)
        out.computation_s += t / M
        tau_fw = max(tau_fw, t)
    for k, path in enumerate(plan.paths):
        fw_bytes = b * ev.profile.cut_bytes(plan.segments[k][1], FW)
        for u, v in zip(path, path[1:]):
            link = ev.net.links[(u, v)]
            t = transmission_time_s(fw_bytes, link.bw_fw)
            out.transmission_s += t / M
            out.propagation_s += link.delay_fw
            tau_fw = max(tau_fw, t)
    if plan.tail_path:  # psi_K = 0: forward propagation only
        _, prop = ev.net.path_cost_breakdown(plan.tail_path, 0.0, None)
        out.propagation_s += prop
    # backward wave: gradients flow destination -> source over the reverse
    # subpaths, charged on the links' backward channels (R^BW convention)
    for (lo, hi), node in zip(plan.segments, plan.placement):
        t = segment_comp_dir_s(ev, node, lo, hi, BW)
        out.computation_s += t / M
        tau_bw = max(tau_bw, t)
    for k, path in enumerate(plan.paths):
        bw_bytes = b * ev.profile.cut_bytes(plan.segments[k][1], BW)
        for u, v in zip(path, path[1:]):
            link = ev.net.links[(u, v)]
            t = transmission_time_s(bw_bytes, link.bw_bw)
            out.transmission_s += t / M
            out.propagation_s += link.delay_bw
            tau_bw = max(tau_bw, t)
    out.bubble_s = (M - 1) * (tau_fw + tau_bw) / M
    return out
