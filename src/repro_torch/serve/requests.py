"""Serve-layer requests: a service chain request with admission metadata.

The paper solves one R = (s, d, b, mode); the serve layer admits a *fleet* of
them onto one fabric.  A :class:`ServeRequest` adds what admission needs on
top of the paper's tuple: an id, an arrival time, the chain length K, the
candidate sets V^k, and a sustained execution rate (chain runs per second)
that converts the chain's smashed-data sizes into link-bandwidth demand.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass

from ..core import (IF, SCHEDULES, SEQ, TR, ModelProfile, PhysicalNetwork,
                        ProblemInstance, ServiceChainRequest, candidate_sets)

INF = float("inf")


@dataclass(frozen=True)
class ServeRequest:
    """One admission-layer request: the paper's R plus fleet metadata."""

    request_id: int
    source: str
    destination: str
    batch_size: int
    mode: str  # IF | TR
    K: int
    candidates: tuple[tuple[str, ...], ...]
    arrival_s: float = 0.0
    rate_rps: float = 1.0  # sustained chain executions per second
    model_id: str = "model"
    schedule: str = SEQ  # seq | pipe (see docs/pipeline.md)
    n_microbatches: int = 1
    # Holding time: how long an admitted chain occupies its reservation before
    # departing (docs/sim.md).  inf = holds forever, the static-admission
    # behaviour; the event-driven ServeSim releases the chain's exact demand
    # at arrival_s (admit time) + duration_s.
    duration_s: float = INF
    # High-availability flag (docs/failures.md): admission also pre-plans a
    # placement/path-disjoint standby for this chain, promoted on failure.
    ha: bool = False

    def __post_init__(self) -> None:
        assert self.mode in (IF, TR)
        assert len(self.candidates) == self.K
        assert self.rate_rps > 0
        assert self.schedule in SCHEDULES
        assert self.n_microbatches >= 1
        assert self.duration_s > 0

    def chain_request(self) -> ServiceChainRequest:
        return ServiceChainRequest(self.model_id, self.source, self.destination,
                                   self.batch_size, self.mode,
                                   schedule=self.schedule,
                                   n_microbatches=self.n_microbatches)

    def candidate_lists(self) -> list[list[str]]:
        return [list(c) for c in self.candidates]

    def problem(self, net: PhysicalNetwork,
                profile: ModelProfile) -> ProblemInstance:
        """The request's :class:`ProblemInstance` on a concrete fabric."""
        return ProblemInstance(net, profile, self.chain_request(), self.K,
                               self.candidates)

    def solve_key(self, net: PhysicalNetwork, profile: ModelProfile) -> str:
        """Requests sharing this key are the same planning problem — the
        planner pre-solves each distinct key once per admission round.
        Delegates to :meth:`ProblemInstance.content_hash`, the same identity
        ``ScenarioSpec.instance_key`` uses, so serve presolve dedup and sweep
        instance grouping can never disagree."""
        return self.problem(net, profile).content_hash()


# The deterministic batch-size spread applied across a generated fleet (cycled
# per request id) so batch-aware policies have heterogeneous work to order.
BATCH_SPREAD = (1, 2, 4)

ARRIVALS = ("batch", "poisson")

# Holding-time models for generated fleets: "none" keeps every chain forever
# (duration_s = inf, the static behaviour), "fixed" holds each chain exactly
# `hold_time_s`, "exp" draws seeded Exponential(mean=hold_time_s) durations.
HOLD_MODELS = ("none", "fixed", "exp")


def generate_fleet(
    net: PhysicalNetwork,
    n_requests: int,
    source: str,
    destination: str,
    batch_size: int,
    mode: str,
    K: int,
    seed: int = 0,
    arrival: str = "batch",
    arrival_rate_rps: float = 1.0,
    rate_rps: float = 1.0,
    candidates: list[list[str]] | None = None,
    candidates_per_stage: int = 2,
    model_id: str = "model",
    batch_spread: tuple[int, ...] = BATCH_SPREAD,
    schedule: str = SEQ,
    n_microbatches: int = 1,
    hold_model: str = "none",
    hold_time_s: float = INF,
    ha: bool = False,
    train_share: float = 0.0,
) -> list[ServeRequest]:
    """Deterministic seeded fleet of `n_requests` chains on one fabric.

    Request i gets batch size ``batch_size * batch_spread[i % len]``, its own
    seeded candidate sets (unless `candidates` pins them for every request),
    an arrival time — 0.0 for ``arrival="batch"`` or cumulative
    Exponential(arrival_rate_rps) inter-arrivals for ``"poisson"`` — and a
    holding time from `hold_model` (see :data:`HOLD_MODELS`).  Holding times
    are drawn from a *dedicated* seeded stream, so a churn fleet and its
    ``hold_model="none"`` counterpart share identical arrivals/candidates.

    ``train_share > 0`` mixes training into the fleet: each request is TR
    with that probability (IF otherwise), overriding `mode`, drawn from its
    own dedicated seeded stream — the arrival/holding/candidate streams are
    untouched, so a mixed fleet and its all-IF (``train_share=0``) twin see
    identical arrival processes, and raising the share only flips individual
    requests IF -> TR (per-request draws are share-monotone).
    """
    if arrival not in ARRIVALS:
        raise ValueError(f"arrival must be one of {ARRIVALS}, got {arrival!r}")
    if hold_model not in HOLD_MODELS:
        raise ValueError(
            f"hold_model must be one of {HOLD_MODELS}, got {hold_model!r}")
    if hold_model != "none" and not (hold_time_s > 0 and math.isfinite(hold_time_s)):
        raise ValueError(f"hold_model={hold_model!r} needs a positive finite "
                         f"hold_time_s, got {hold_time_s!r}")
    if not 0.0 <= train_share <= 1.0:
        raise ValueError(f"train_share must be in [0, 1], got {train_share!r}")
    rng = random.Random(seed)
    hold_rng = random.Random(seed * 7919 + 1)  # independent of the arrival stream
    mode_rng = random.Random(seed * 5557 + 3)  # independent mode-mixing stream
    nodes = sorted(net.nodes)
    fleet = []
    t = 0.0
    for i in range(n_requests):
        if arrival == "poisson":
            t += rng.expovariate(arrival_rate_rps)
        if hold_model == "none":
            duration = INF
        elif hold_model == "fixed":
            duration = hold_time_s
        else:  # "exp"
            duration = hold_rng.expovariate(1.0 / hold_time_s)
        req_mode = mode
        if train_share > 0.0:
            req_mode = TR if mode_rng.random() < train_share else IF
        if candidates is not None:
            cands = candidates
        else:
            cands = candidate_sets(K, seed * 10007 + i, nodes, source,
                                   destination, candidates_per_stage)
        fleet.append(ServeRequest(
            request_id=i,
            source=source,
            destination=destination,
            batch_size=batch_size * batch_spread[i % len(batch_spread)],
            mode=req_mode,
            K=K,
            candidates=tuple(tuple(c) for c in cands),
            arrival_s=t,
            rate_rps=rate_rps,
            model_id=model_id,
            schedule=schedule,
            n_microbatches=n_microbatches,
            duration_s=duration,
            ha=ha,
        ))
    return fleet
