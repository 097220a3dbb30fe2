"""PlanCache — warm snapshot-solve cache across the request stream (Layer 2).

The static round dedups snapshot solves *within one fleet* (first-seen
`ProblemInstance` content hashes share one ``solve_batch`` call).  A serving
gateway sees the same shapes recur across ticks for hours — this cache keys
full :class:`~repro_torch.core.problem.SolveOutcome` objects by that same engine-wide
content hash so a recurring shape skips the solver entirely, with LRU
eviction and hit/miss/eviction counters for the observability block
(``GatewayStats`` / ``ServeOutcome.solver_stats()``).

Soundness: solvers are deterministic functions of the instance *content*
(the hash covers network + profile + request + K + candidate sets), and
snapshot solves always run against the uncontended base network — so a cached
outcome is bit-identical to a fresh solve, and residual-capacity admission
still re-checks every cached plan against the live fabric before commit.
"""
from __future__ import annotations

from collections import OrderedDict

from ..core import SolveOutcome


class PlanCache:
    """LRU map: ProblemInstance content hash -> snapshot SolveOutcome."""

    __slots__ = ("capacity", "hits", "misses", "evictions", "_data")

    def __init__(self, capacity: int | None = None):
        if capacity is not None and capacity < 1:
            raise ValueError(f"capacity must be >= 1 or None, got {capacity}")
        self.capacity = capacity  # None = unbounded
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self._data: OrderedDict[str, SolveOutcome] = OrderedDict()

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def get(self, key: str) -> SolveOutcome | None:
        """Counted lookup: a hit refreshes the entry's LRU position."""
        out = self._data.get(key)
        if out is None:
            self.misses += 1
            return None
        self._data.move_to_end(key)
        self.hits += 1
        return out

    def put(self, key: str, outcome: SolveOutcome) -> None:
        self._data[key] = outcome
        self._data.move_to_end(key)
        if self.capacity is not None and len(self._data) > self.capacity:
            self._data.popitem(last=False)
            self.evictions += 1

    @property
    def hit_rate(self) -> float | None:
        total = self.hits + self.misses
        return self.hits / total if total else None

    def stats(self) -> dict:
        return {"size": len(self._data), "capacity": self.capacity,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions, "hit_rate": self.hit_rate}

    def clear(self) -> None:
        """Drop entries; counters keep accumulating (lifetime observability)."""
        self._data.clear()
