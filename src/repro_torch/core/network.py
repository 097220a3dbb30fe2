"""Physical network model G = (V, E) (paper Sec. III-C).

Directed links; each link (i, j) carries a forward-direction bandwidth/propagation
delay (used by activations flowing i->j) and a backward-direction pair (used by
gradients flowing back along the same subpath, i.e. j->i traffic charged on link
(i, j) per the paper's R^BW_{i,j} convention).
"""
from __future__ import annotations

import heapq
import json
from dataclasses import dataclass, field

import numpy as np

from .costmodel import FW, ComputeModel


@dataclass(frozen=True)
class NodeSpec:
    name: str
    compute: ComputeModel
    mem_capacity: float  # C_i^mem, bytes
    disk_capacity: float  # C_i^disk, bytes


@dataclass(frozen=True)
class LinkSpec:
    """R^FW/R^BW in bits/s, d^FW/d^BW in seconds."""

    bw_fw: float
    bw_bw: float
    delay_fw: float
    delay_bw: float

    def rate(self, direction: str) -> float:
        return self.bw_fw if direction == FW else self.bw_bw

    def delay(self, direction: str) -> float:
        return self.delay_fw if direction == FW else self.delay_bw


def transmission_time_s(size_bytes: float, rate_bps: float) -> float:
    """T^trans = b*psi / R  (Eq. 18); sizes in bytes, rates in bits/s."""
    return size_bytes * 8.0 / rate_bps


@dataclass
class PhysicalNetwork:
    nodes: dict[str, NodeSpec] = field(default_factory=dict)
    links: dict[tuple[str, str], LinkSpec] = field(default_factory=dict)
    # Cached single-source Dijkstra frontiers keyed (source, fw_bytes, bw_bytes);
    # invalidated whenever the topology mutates.  Shared by DFTS / the exact DP
    # across solver calls and across sweep grid points on the same network.
    _sssp_cache: dict = field(default_factory=dict, init=False, repr=False,
                              compare=False)
    # Dense [S, V] frontier matrices keyed (sources, fw_bytes, bw_bytes) and the
    # node -> column index; assembled from _sssp_cache rows for the vectorized
    # min-plus stage relaxation, invalidated together with it.
    _frontier_mats: dict = field(default_factory=dict, init=False, repr=False,
                                 compare=False)
    _node_idx: dict | None = field(default=None, init=False, repr=False,
                                   compare=False)
    # Canonical content serialization (ProblemInstance identity); computed
    # lazily, invalidated together with the routing caches on mutation.
    _content_key: str | None = field(default=None, init=False, repr=False,
                                     compare=False)

    def _invalidate(self) -> None:
        self._sssp_cache.clear()
        self._frontier_mats.clear()
        self._node_idx = None
        self._content_key = None

    def add_node(self, spec: NodeSpec) -> None:
        self.nodes[spec.name] = spec
        self._invalidate()

    def add_link(self, u: str, v: str, spec: LinkSpec) -> None:
        assert u in self.nodes and v in self.nodes
        self.links[(u, v)] = spec
        self._invalidate()

    def add_bidirectional(self, u: str, v: str, spec: LinkSpec) -> None:
        self.add_link(u, v, spec)
        self.add_link(v, u, spec)

    @property
    def node_names(self) -> list[str]:
        return list(self.nodes)

    def out_edges(self, u: str) -> list[tuple[str, LinkSpec]]:
        return [(v, s) for (a, v), s in self.links.items() if a == u]

    # ------------------------------------------------------------------ routing
    def link_trans_s(self, u: str, v: str, fw_bytes: float,
                     bw_bytes: float | None) -> float:
        """Transmission time only (no propagation) of one cut's smashed data on
        link (u, v) — the link's *occupancy* per batch, i.e. its pipeline-stage
        time in the pipelined execution model (docs/pipeline.md)."""
        link = self.links[(u, v)]
        t = transmission_time_s(fw_bytes, link.bw_fw)
        if bw_bytes is not None:
            t += transmission_time_s(bw_bytes, link.bw_bw)
        return t

    def link_trans_dir_s(self, u: str, v: str, size_bytes: float,
                         direction: str) -> float:
        """Single-direction transmission time of one cut's smashed data on
        link (u, v): the link's per-batch occupancy as a *forward* (activation)
        or *backward* (gradient) pipeline stage in the round-trip training
        model (docs/training.md)."""
        link = self.links[(u, v)]
        return transmission_time_s(size_bytes, link.rate(direction))

    def edge_cost(self, u: str, v: str, fw_bytes: float, bw_bytes: float | None,
                  trans_scale: float = 1.0) -> float:
        """Per-link chaining cost c^k_{i,j} (Sec. V-C): FW transfer (+ BW if
        training).  ``trans_scale`` multiplies only the transmission terms —
        the pipelined solvers route with scale 1/M (a microbatch's share of the
        fill cost) while propagation is charged in full."""
        link = self.links[(u, v)]
        cost = transmission_time_s(fw_bytes, link.bw_fw) * trans_scale + link.delay_fw
        if bw_bytes is not None:
            cost += (transmission_time_s(bw_bytes, link.bw_bw) * trans_scale
                     + link.delay_bw)
        return cost

    def dijkstra(
        self,
        sources: dict[str, float],
        fw_bytes: float,
        bw_bytes: float | None,
        trans_cap: float | None = None,
        trans_scale: float = 1.0,
        trans_cap_bw: float | None = None,
    ) -> tuple[dict[str, float], dict[str, str | None]]:
        """Multi-source Dijkstra with smashed-data-dependent link costs.

        `sources` maps node -> initial distance (enables the stage-wise shortest
        path *tour* with a single Dijkstra per stage, as in the DFTS layered
        search).  Returns (dist, parent).

        ``trans_cap`` excludes links whose per-batch transmission time
        (``link_trans_s``) exceeds the cap — the bottleneck-capped searches of
        the pipelined solvers; ``trans_scale`` scales transmission (not
        propagation) in the edge cost.  When ``trans_cap_bw`` is given
        (round-trip training searches, docs/training.md) the caps are
        *per-direction* instead: a link is excluded when its forward
        (activation) occupancy exceeds ``trans_cap`` or its backward
        (gradient) occupancy exceeds ``trans_cap_bw``; ``bw_bytes`` must then
        be a concrete size.  The defaults reproduce the sequential behaviour
        exactly (scaling by 1.0 is an IEEE identity).
        """
        adj: dict[str, list[tuple[str, float]]] = {n: [] for n in self.nodes}
        for (u, v), spec in self.links.items():
            if trans_cap_bw is not None:
                assert bw_bytes is not None
                if (transmission_time_s(fw_bytes, spec.bw_fw) > trans_cap
                        or transmission_time_s(bw_bytes, spec.bw_bw)
                        > trans_cap_bw):
                    continue
            elif (trans_cap is not None
                    and self.link_trans_s(u, v, fw_bytes, bw_bytes) > trans_cap):
                continue
            adj[u].append((v, self.edge_cost(u, v, fw_bytes, bw_bytes,
                                             trans_scale)))
        dist = {n: float("inf") for n in self.nodes}
        parent: dict[str, str | None] = {n: None for n in self.nodes}
        pq: list[tuple[float, str]] = []
        for s, d0 in sources.items():
            dist[s] = min(dist[s], d0)
            heapq.heappush(pq, (dist[s], s))
        while pq:
            d, u = heapq.heappop(pq)
            if d > dist[u]:
                continue
            for v, w in adj[u]:
                nd = d + w
                if nd < dist[v]:
                    dist[v] = nd
                    parent[v] = u
                    heapq.heappush(pq, (nd, v))
                elif nd == dist[v] and parent[v] is not None and u < parent[v]:
                    # Deterministic equal-cost tie-break: among all optimal
                    # predecessors take the lexicographically smallest, so the
                    # parent tree (and every reconstructed path) is independent
                    # of dict/heap iteration order.  Source nodes keep
                    # parent=None — they are roots of the tour stage.
                    parent[v] = u
        return dist, parent

    def sssp(
        self, source: str, fw_bytes: float, bw_bytes: float | None,
        trans_cap: float | None = None, trans_scale: float = 1.0,
        trans_cap_bw: float | None = None,
    ) -> tuple[dict[str, float], dict[str, str | None]]:
        """Cached single-source Dijkstra frontier for one smashed-data size.

        The (dist, parent) maps are memoized per (source, fw_bytes, bw_bytes,
        trans_cap, trans_scale); treat them as immutable.  Stage relaxations
        over a candidate *set* are the min-composition of these frontiers
        (dist_S(v) = min_s d0[s] + dist_s(v)), so one cache serves every
        multi-source tour query — including the capped/scaled frontiers of the
        pipelined solvers' bottleneck scans.
        """
        key = (source, fw_bytes, bw_bytes, trans_cap, trans_scale,
               trans_cap_bw)
        hit = self._sssp_cache.get(key)
        if hit is None:
            hit = self.dijkstra({source: 0.0}, fw_bytes, bw_bytes,
                                trans_cap, trans_scale, trans_cap_bw)
            self._sssp_cache[key] = hit
        return hit

    def clear_routing_cache(self) -> None:
        """Drop cached frontiers (needed only after mutating a LinkSpec in place)."""
        self._invalidate()

    def content_key(self) -> str:
        """Canonical serialization of the topology's *content* — every node
        spec (incl. its compute model constants) and every directed link.
        Two networks built independently from equal data produce equal keys;
        cached and invalidated with the routing caches on mutation."""
        if self._content_key is None:
            self._content_key = json.dumps({
                "nodes": {
                    n: [s.compute.name, [list(p) for p in s.compute.pieces],
                        s.compute.alpha_tau, s.compute.beta_tau,
                        s.mem_capacity, s.disk_capacity]
                    for n, s in sorted(self.nodes.items())
                },
                "links": [
                    [u, v, s.bw_fw, s.bw_bw, s.delay_fw, s.delay_bw]
                    for (u, v), s in sorted(self.links.items())
                ],
            }, sort_keys=True, separators=(",", ":"))
        return self._content_key

    def node_index(self) -> dict[str, int]:
        """Stable node -> dense-column index (sorted names; cached)."""
        if self._node_idx is None:
            self._node_idx = {n: i for i, n in enumerate(sorted(self.nodes))}
        return self._node_idx

    def frontier_matrix(
        self, sources: tuple[str, ...], fw_bytes: float, bw_bytes: float | None,
        trans_cap: float | None = None, trans_scale: float = 1.0,
        trans_cap_bw: float | None = None,
    ) -> np.ndarray:
        """Dense [S, V] matrix of cached single-source frontiers.

        Row r is the full Dijkstra distance frontier of ``sources[r]`` for the
        given smashed-data size, columns ordered by :meth:`node_index`.  The
        matrix is assembled once per (sources, size) key and shared by every
        min-plus stage relaxation that composes these frontiers — across BCD
        iterations, solver calls, and all requests of a serve admission round.
        Read-only; invalidated with the frontier cache on topology mutation.
        """
        key = (sources, fw_bytes, bw_bytes, trans_cap, trans_scale,
               trans_cap_bw)
        mat = self._frontier_mats.get(key)
        if mat is None:
            idx = self.node_index()
            mat = np.full((len(sources), len(idx)), float("inf"))
            for r, s in enumerate(sources):
                dist, _ = self.sssp(s, fw_bytes, bw_bytes, trans_cap,
                                    trans_scale, trans_cap_bw)
                for n, d in dist.items():
                    mat[r, idx[n]] = d
            mat.setflags(write=False)
            self._frontier_mats[key] = mat
        return mat

    def shortest_path(
        self, src: str, dst: str, fw_bytes: float, bw_bytes: float | None
    ) -> tuple[float, list[str]]:
        """Least-cost loop-free path src->dst for a given smashed-data size."""
        if src == dst:
            return 0.0, [src]
        dist, parent = self.dijkstra({src: 0.0}, fw_bytes, bw_bytes)
        if dist[dst] == float("inf"):
            raise ValueError(f"no path {src} -> {dst}")
        path, cur = [dst], dst
        while cur != src:
            cur = parent[cur]  # type: ignore[assignment]
            assert cur is not None
            path.append(cur)
        return dist[dst], path[::-1]

    def path_cost_breakdown(
        self, path: list[str], fw_bytes: float, bw_bytes: float | None
    ) -> tuple[float, float]:
        """(transmission_s, propagation_s) along a concrete path (FW + optional BW)."""
        trans = prop = 0.0
        for u, v in zip(path, path[1:]):
            link = self.links[(u, v)]
            trans += transmission_time_s(fw_bytes, link.bw_fw)
            prop += link.delay_fw
            if bw_bytes is not None:
                trans += transmission_time_s(bw_bytes, link.bw_bw)
                prop += link.delay_bw
        return trans, prop
