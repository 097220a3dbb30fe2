"""Service chain requests, plans (splitting + placement + chaining) and the latency
objective T(x, y, b, mode) with its computation / transmission / propagation
breakdown (paper Eqs. (1), (16)-(18); Figs. 8-9 breakdowns).

Two execution schedules are supported (see docs/pipeline.md):

* ``seq`` — the paper's model: stage k+1 starts only after stage k finished and
  its smashed data fully arrived; latency is the plain sum of Eq. (16).
* ``pipe`` — the batch is split into M microbatches that flow through the
  placed chain like a pipeline.  Each *resource* (a hosting node, or one
  physical link of a subpath) is a pipeline stage occupied ``t/M`` per
  microbatch, where ``t`` is its full-batch time; end-to-end latency is
  pipeline fill (sum of per-microbatch stage times + all propagation) plus the
  drain term ``(M-1) * max_stage / M`` recorded as ``bubble_s``.  With M = 1
  this is bit-for-bit the sequential sum.

Training requests (``mode=TR``) under ``pipe`` with M > 1 use the *round-trip*
model of ``trainpipe.py`` (docs/training.md): the backward pass is a second
pipeline wave over the reverse subpaths with its own ``delta^BW`` gradient
sizes and per-direction stage times, and the drain term is
``(M-1) * (tau_fw + tau_bw) / M``.  ``seq``+TR and every IF path are
unaffected by that dispatch.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .costmodel import (BW, FW, IF, PIPE, SCHEDULES, SEQ, TR, ModelProfile,
                        dirs_for_mode, effective_microbatches, validate_segments)
from .network import PhysicalNetwork


@dataclass(frozen=True)
class ServiceChainRequest:
    """R = (id, s, d, b, mode) — paper Sec. III-A — plus the execution
    schedule (``seq`` | ``pipe`` with ``n_microbatches``)."""

    model_id: str
    source: str
    destination: str
    batch_size: int
    mode: str  # IF | TR
    schedule: str = SEQ  # seq | pipe
    n_microbatches: int = 1

    def __post_init__(self) -> None:
        assert self.mode in (IF, TR)
        assert self.schedule in SCHEDULES, f"unknown schedule {self.schedule!r}"
        assert self.n_microbatches >= 1

    def microbatches(self) -> int:
        """Effective pipeline depth M: 1 under ``seq``, else clamped to [1, b]."""
        if self.schedule != PIPE:
            return 1
        return effective_microbatches(self.batch_size, self.n_microbatches)


@dataclass
class LatencyBreakdown:
    computation_s: float = 0.0
    transmission_s: float = 0.0
    propagation_s: float = 0.0
    bubble_s: float = 0.0  # pipeline drain (M-1)*max_stage/M; 0 under seq

    @property
    def total_s(self) -> float:
        return (self.computation_s + self.transmission_s + self.propagation_s
                + self.bubble_s)

    def __add__(self, other: "LatencyBreakdown") -> "LatencyBreakdown":
        return LatencyBreakdown(
            self.computation_s + other.computation_s,
            self.transmission_s + other.transmission_s,
            self.propagation_s + other.propagation_s,
            self.bubble_s + other.bubble_s,
        )


@dataclass
class Plan:
    """A complete solution: y (segments), placement, and chaining subpaths.

    segments:   K 1-indexed inclusive layer ranges [lo, hi].
    placement:  node name hosting each sub-model F^k.
    paths:      K-1 physical node paths; paths[k] carries the smashed data of the
                cut after segment k (placement[k] -> placement[k+1]).
    tail_path:  physical path placement[K-1] -> destination (subpath S_{K+1};
                psi_K = 0 so only propagation is charged, per Eq. (16)).
    """

    segments: list[tuple[int, int]]
    placement: list[str]
    paths: list[list[str]]
    tail_path: list[str] = field(default_factory=list)

    @property
    def K(self) -> int:
        return len(self.segments)

    def cuts(self) -> list[int]:
        return [hi for (_, hi) in self.segments[:-1]]


class EvalCache:
    """Memo tables for per-(node, segment) compute time and capacity checks.

    Entries are batch-size-, mode- and schedule-dependent, so all are part of
    the memo key: a single instance is safe to share across heterogeneous
    requests of one (network, profile) — the serve layer admits whole fleets
    against one cache that way, and the sweep runner keys shared instances per
    problem cell.  (Full-batch stage times are in fact schedule-invariant;
    keeping the schedule in the key keeps seq/pipe entries disjoint by design
    so schedule-specific tables can be added without aliasing.)  Solvers that
    receive no cache build a private one per call, which still collapses the
    repeated segment queries inside their own DP loops.

    `fits` additionally depends on node capacities, so a cache must never be
    shared across *networks* (e.g. residual-capacity views); `comp` depends
    only on the node compute models and may be (see :meth:`fork_fits`).

    ``hits`` / ``misses`` count lookups across both tables — the serve layer
    surfaces them per admission round (``ServeOutcome.solver_stats()``);
    forked caches count their own traffic even though the comp table is
    shared.
    """

    __slots__ = ("comp", "fits", "hits", "misses")

    def __init__(self) -> None:
        # keys: (node, lo, hi, batch_size, mode, schedule, n_microbatches);
        # per-direction round-trip entries (trainpipe.segment_comp_dir_s) use
        # 8-tuples (node, lo, hi, direction, ...) — disjoint by length.
        self.comp: dict[tuple, float] = {}
        self.fits: dict[tuple, bool] = {}
        self.hits = 0
        self.misses = 0

    def fork_fits(self) -> "EvalCache":
        """A cache sharing this one's compute table but with fresh fit tables —
        for residual-capacity views of the same network (same compute models,
        different node capacities).  Counters start fresh: the fork counts its
        own traffic."""
        out = EvalCache()
        out.comp = self.comp
        return out

    @property
    def hit_rate(self) -> float | None:
        total = self.hits + self.misses
        return self.hits / total if total else None

    def stats(self) -> dict:
        """Counter snapshot for observability blocks (JSON-able)."""
        return {"hits": self.hits, "misses": self.misses,
                "hit_rate": self.hit_rate,
                "n_comp": len(self.comp), "n_fits": len(self.fits)}


class PlanEvaluator:
    """Evaluates T(x, y, b, mode) and checks constraints for concrete plans."""

    def __init__(self, net: PhysicalNetwork, profile: ModelProfile,
                 request: ServiceChainRequest, cache: EvalCache | None = None):
        self.net = net
        self.profile = profile
        self.request = request
        self.cache = cache if cache is not None else EvalCache()
        # memo-key suffix: EvalCache entries are batch/mode/schedule-dependent
        self._ck = (request.batch_size, request.mode, request.schedule,
                    request.n_microbatches)

    # ------------------------------------------------------------- feasibility
    def segment_fits(self, node: str, lo: int, hi: int) -> bool:
        """Constraints (14) disk and (15) memory for sub-model [lo, hi] at node."""
        key = (node, lo, hi, *self._ck)
        hit = self.cache.fits.get(key)
        if hit is not None:
            self.cache.hits += 1
            return hit
        self.cache.misses += 1
        spec = self.net.nodes[node]
        ok = self.profile.seg_disk_bytes(lo, hi) <= spec.disk_capacity
        if ok:
            mem = self.profile.seg_mem_bytes(lo, hi)
            mem += (self.request.batch_size
                    * self.profile.seg_peak_smashed(lo, hi, self.request.mode))
            ok = mem <= spec.mem_capacity
        self.cache.fits[key] = ok
        return ok

    def check(self, plan: Plan) -> None:
        validate_segments(plan.segments, self.profile.L)
        assert len(plan.placement) == plan.K and len(plan.paths) == plan.K - 1
        for (lo, hi), node in zip(plan.segments, plan.placement):
            if not self.segment_fits(node, lo, hi):
                raise ValueError(f"segment [{lo},{hi}] violates capacity at {node}")
        for k, path in enumerate(plan.paths):
            assert path[0] == plan.placement[k] and path[-1] == plan.placement[k + 1]
            for u, v in zip(path, path[1:]):
                assert (u, v) in self.net.links, f"missing link {u}->{v}"

    # ------------------------------------------------------------------ latency
    def segment_comp_s(self, node: str, lo: int, hi: int) -> float:
        """T^comp for sub-model [lo, hi] at node, FW (+BW if training) — Eq. (17)."""
        key = (node, lo, hi, *self._ck)
        hit = self.cache.comp.get(key)
        if hit is not None:
            self.cache.hits += 1
            return hit
        self.cache.misses += 1
        cm = self.net.nodes[node].compute
        b = self.request.batch_size
        total = 0.0
        for d in dirs_for_mode(self.request.mode):
            total += cm.comp_time_s(b, self.profile.seg_flops(lo, hi, d))
        self.cache.comp[key] = total
        return total

    def cut_transfer_s(self, path: list[str], cut_after: int) -> tuple[float, float]:
        """(transmission, propagation) shipping delta_cut along `path`, FW (+BW)."""
        b = self.request.batch_size
        fw_bytes = b * self.profile.cut_bytes(cut_after, FW)
        bw_bytes = (b * self.profile.cut_bytes(cut_after, BW)
                    if self.request.mode == TR else None)
        return self.net.path_cost_breakdown(path, fw_bytes, bw_bytes)

    def _cut_sizes(self, cut_after: int) -> tuple[float, float | None]:
        b = self.request.batch_size
        fw = b * self.profile.cut_bytes(cut_after, FW)
        bw = (b * self.profile.cut_bytes(cut_after, BW)
              if self.request.mode == TR else None)
        return fw, bw

    def plan_stage_times(self, plan: Plan) -> list[float]:
        """Full-batch occupancy time of every pipeline *resource* of the plan:
        the K hosting nodes (Eq. 17 compute) and each physical link of each
        inter-stage subpath (transmission only — propagation occupies no
        resource).  ``max(...)`` of these is the pipeline bottleneck tau."""
        times = [self.segment_comp_s(node, lo, hi)
                 for (lo, hi), node in zip(plan.segments, plan.placement)]
        for k, path in enumerate(plan.paths):
            fw, bw = self._cut_sizes(plan.segments[k][1])
            for u, v in zip(path, path[1:]):
                times.append(self.net.link_trans_s(u, v, fw, bw))
        return times

    def bottleneck_s(self, plan: Plan) -> float:
        """tau: the slowest full-batch pipeline stage (node or link) of the plan."""
        return max(self.plan_stage_times(plan))

    def evaluate_pipelined(self, plan: Plan, n_microbatches: int) -> LatencyBreakdown:
        """Pipelined latency (docs/pipeline.md): fill + (M-1)*tau/M.

        Fill charges every stage its per-microbatch share t/M plus full
        propagation on every link; the drain/bubble term is (M-1) steady-state
        steps of the bottleneck stage.  With M = 1 every division is by 1 and
        the bubble is exactly 0.0, so the result is bit-for-bit equal to the
        sequential :meth:`evaluate`.
        """
        M = n_microbatches
        out = LatencyBreakdown()
        tau = 0.0
        for (lo, hi), node in zip(plan.segments, plan.placement):
            t = self.segment_comp_s(node, lo, hi)
            out.computation_s += t / M
            tau = max(tau, t)
        for k, path in enumerate(plan.paths):
            cut = plan.segments[k][1]
            trans, prop = self.cut_transfer_s(path, cut)
            out.transmission_s += trans / M
            out.propagation_s += prop
            fw, bw = self._cut_sizes(cut)
            for u, v in zip(path, path[1:]):
                tau = max(tau, self.net.link_trans_s(u, v, fw, bw))
        if plan.tail_path:  # psi_K = 0: propagation only, reserves no stage
            _, prop = self.net.path_cost_breakdown(plan.tail_path, 0.0, None)
            out.propagation_s += prop
        out.bubble_s = (M - 1) * tau / M
        return out

    def evaluate(self, plan: Plan) -> LatencyBreakdown:
        if self.request.schedule == PIPE:
            M = self.request.microbatches()
            if self.request.mode == TR and M > 1:
                # round-trip training pipeline (docs/training.md); M = 1
                # stays on the fused path below — bit-equal to seq.
                from .trainpipe import evaluate_round_trip

                return evaluate_round_trip(self, plan, M)
            return self.evaluate_pipelined(plan, M)
        out = LatencyBreakdown()
        for (lo, hi), node in zip(plan.segments, plan.placement):
            out.computation_s += self.segment_comp_s(node, lo, hi)
        for k, path in enumerate(plan.paths):
            cut = plan.segments[k][1]
            trans, prop = self.cut_transfer_s(path, cut)
            out.transmission_s += trans
            out.propagation_s += prop
        if plan.tail_path:  # psi_K = 0: propagation only
            _, prop = self.net.path_cost_breakdown(plan.tail_path, 0.0, None)
            out.propagation_s += prop
        return out

    def latency_s(self, plan: Plan) -> float:
        return self.evaluate(plan).total_s
