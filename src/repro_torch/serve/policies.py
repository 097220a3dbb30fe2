"""Pluggable admission-order policies.

A policy maps (requests, estimates) to the order in which the planner tries
to admit them, where ``estimates[request_id]`` is the request's pre-solved
solo latency on the admission-round snapshot (``inf`` when even the
uncontended fabric has no feasible plan).  Every policy is a *total*
deterministic order — ties always fall back to (arrival, id) — so admission
outcomes are reproducible across runs and dict orderings.
"""
from __future__ import annotations

from .requests import ServeRequest

INF = float("inf")


def fcfs(requests: list[ServeRequest],
         estimates: dict[int, float]) -> list[ServeRequest]:
    """First come, first served: by arrival time, then request id."""
    return sorted(requests, key=lambda r: (r.arrival_s, r.request_id))


def latency_greedy(requests: list[ServeRequest],
                   estimates: dict[int, float]) -> list[ServeRequest]:
    """Shortest-job-first on the pre-solved solo latency: cheap chains are
    admitted before expensive ones, maximizing accepted count under load."""
    return sorted(requests, key=lambda r: (estimates.get(r.request_id, INF),
                                           r.arrival_s, r.request_id))


def batch_size_descending(requests: list[ServeRequest],
                          estimates: dict[int, float]) -> list[ServeRequest]:
    """Largest batch first: heavy chains grab capacity while the fabric is
    empty (bin-packing style), small ones fill the leftovers."""
    return sorted(requests, key=lambda r: (-r.batch_size, r.arrival_s,
                                           r.request_id))


POLICIES = {
    "fcfs": fcfs,
    "latency-greedy": latency_greedy,
    "batch-desc": batch_size_descending,
}

POLICY_NAMES = tuple(POLICIES)
