"""Comparison / Pareto reporting over sweep results.

Scenarios sharing a :meth:`ScenarioSpec.group_key` are one problem instance
solved by several schemes; within each group we measure every scheme against
the best optimal-class solver present (``exact`` or ``ilp``, else the group's
best latency): optimality gap in % and wall-time speedup.  A scheme is on the
group's Pareto front if no other scheme is at least as good on both latency
and solver wall time and strictly better on one.

Scenarios sharing a :meth:`ScenarioSpec.schedule_key` (same instance, same
solver, different execution schedule) are additionally paired seq-vs-pipe:
each pipelined scenario gets its sequential counterpart's latency and the
speedup ``seq / pipe`` — the headline number of the pipelined execution model
(docs/pipeline.md), which is >= 1 by construction (the pipelined schedule can
always execute the sequential plan).
"""
from __future__ import annotations

from collections import defaultdict

from .runner import ScenarioResult

# Name-based fallback for results recorded before the engine stamped a solve
# status (schema < 4); current results carry SolveOutcome.status directly.
OPTIMAL_SOLVERS = ("exact", "ilp")


def _is_optimal(r: ScenarioResult) -> bool:
    """Optimal-class reference test: the engine-stamped status when present
    (covers e.g. a portfolio whose winning member is optimal), else the
    legacy solver-name convention."""
    if r.status is not None:
        return r.status == "optimal"
    return r.spec.solver in OPTIMAL_SOLVERS


def schedule_pairs(results: list[ScenarioResult]) -> dict[str, dict]:
    """Map each *pipe* scenario id to its seq counterpart's latency + speedup.

    Pairing key is :meth:`ScenarioSpec.schedule_key` — only feasible
    single-chain pairs are reported.  Returned rows carry
    ``seq_latency_s`` / ``pipe_latency_s`` / ``speedup`` plus labels.
    """
    seq_by_key: dict[str, ScenarioResult] = {}
    for r in results:
        if r.spec.schedule == "seq" and r.spec.n_requests == 1 and r.feasible:
            seq_by_key[r.spec.schedule_key()] = r
    pairs: dict[str, dict] = {}
    for r in results:
        if r.spec.schedule != "pipe" or r.spec.n_requests != 1 or not r.feasible:
            continue
        seq = seq_by_key.get(r.spec.schedule_key())
        if seq is None or not seq.latency_s:
            continue
        pairs[r.spec.scenario_id()] = {
            "cell": r.spec.tags.get("cell", ""),
            "solver": r.spec.solver,
            "n_microbatches": r.spec.n_microbatches,
            "seq_latency_s": seq.latency_s,
            "pipe_latency_s": r.latency_s,
            "bubble_s": r.bubble_s,
            "speedup": seq.latency_s / r.latency_s,
        }
    return pairs


def churn_pairs(results: list[ScenarioResult]) -> dict[str, dict]:
    """Map each dynamic (*sim* churn or *gateway* stream) scenario id to its
    static counterpart's acceptance, pairing on
    :meth:`ScenarioSpec.churn_key` — identical fleet, solver, and policy;
    only the churn/gateway knobs differ.  ``uplift`` is
    ``dynamic acceptance - static acceptance`` (in ratio points): the
    headline of the event-driven serving model, >= 0 whenever departures
    free capacity that the one-shot round holds forever."""
    static_by_key: dict[str, ScenarioResult] = {}
    for r in results:
        if (r.spec.n_requests > 1 and not r.spec.sim and not r.spec.gateway
                and r.error is None and r.acceptance_ratio is not None):
            static_by_key[r.spec.churn_key()] = r
    pairs: dict[str, dict] = {}
    for r in results:
        if not (r.spec.sim or r.spec.gateway):
            continue
        if r.error is not None or r.acceptance_ratio is None:
            continue
        static = static_by_key.get(r.spec.churn_key())
        if static is None:
            continue
        pairs[r.spec.scenario_id()] = {
            "cell": r.spec.tags.get("cell", ""),
            "driver": "gateway" if r.spec.gateway else "sim",
            "solver": r.spec.solver,
            "policy": r.spec.policy,
            "n_requests": r.spec.n_requests,
            "static_accepted": static.n_accepted,
            "churn_accepted": r.n_accepted,
            "static_acceptance": static.acceptance_ratio,
            "churn_acceptance": r.acceptance_ratio,
            "uplift": r.acceptance_ratio - static.acceptance_ratio,
            "blocking_probability": r.blocking_probability,
            "peak_concurrent": r.peak_concurrent,
        }
    return pairs


def training_rows(results: list[ScenarioResult]) -> list[dict]:
    """One train/inference contention row per mixed training fleet
    (``spec.train_share > 0``, docs/training.md): the per-mode acceptance and
    latency percentiles recorded by the run, plus — when the suite also swept
    the ``train_share=0`` twin (identical arrivals/candidates by stream
    construction, pairing on :meth:`ScenarioSpec.training_key`) — the all-IF
    acceptance and the contention cost ``if_acceptance_delta`` (how many
    acceptance-ratio points the *inference* side lost to sharing the fabric
    with training chains)."""
    twin_by_key: dict[str, ScenarioResult] = {}
    for r in results:
        if (r.spec.n_requests > 1 and r.spec.train_share == 0.0
                and r.error is None and r.acceptance_ratio is not None):
            twin_by_key[r.spec.training_key()] = r
    rows = []
    for r in results:
        s = r.spec
        if s.train_share <= 0.0 or r.error is not None:
            continue
        split = r.mode_split or {}
        row = {
            "scenario_id": s.scenario_id(),
            "cell": s.tags.get("cell", ""),
            "profile": s.profile,
            "arch": (s.profile_kwargs or {}).get("arch", s.profile),
            "solver": s.solver,
            "train_share": s.train_share,
            "n_requests": s.n_requests,
            "acceptance_ratio": r.acceptance_ratio,
            "mode_split": split,
        }
        twin = twin_by_key.get(s.training_key())
        if twin is not None:
            row["all_if_acceptance"] = twin.acceptance_ratio
            if_split = split.get("IF")
            if if_split is not None and twin.acceptance_ratio is not None:
                row["if_acceptance_delta"] = (if_split["acceptance_ratio"]
                                              - twin.acceptance_ratio)
        rows.append(row)
    return rows


def failure_rows(results: list[ScenarioResult]) -> list[dict]:
    """One survivability row per failure-injected scenario (docs/failures.md):
    how many committed chains a substrate event took down, how many came back
    (migrated or promoted standbys), the restoration-latency tail, and the
    bytes the migrations moved.  Rate-0 anchors are excluded — they carry no
    failure schedule and pair through :func:`churn_pairs` instead."""
    rows = []
    for r in results:
        s = r.spec
        if not (s.sim or s.gateway) or r.error is not None:
            continue
        if s.failure_rate <= 0 and s.failures is None:
            continue
        n_failed = r.n_failed or 0
        n_restored = r.n_restored or 0
        rows.append({
            "scenario_id": s.scenario_id(),
            "cell": s.tags.get("cell", ""),
            "variant": s.tags.get("variant", ""),
            "failure_rate": s.failure_rate,
            "ha": s.ha,
            "solver": s.solver,
            "n_requests": s.n_requests,
            "acceptance_ratio": r.acceptance_ratio,
            "n_failed": n_failed,
            "n_restored": n_restored,
            "n_killed": n_failed - n_restored,
            "survivability": (n_restored / n_failed) if n_failed else None,
            "restore_p95_s": r.restore_p95_s,
            "moved_bytes": r.moved_bytes,
        })
    return rows


def _pareto(points: list[tuple[str, float, float]]) -> set[str]:
    front = set()
    for name, lat, wall in points:
        dominated = any(
            (l2 <= lat and w2 <= wall) and (l2 < lat or w2 < wall)
            for n2, l2, w2 in points if n2 != name
        )
        if not dominated:
            front.add(name)
    return front


def comparison_report(results: list[ScenarioResult]) -> dict:
    groups: dict[str, list[ScenarioResult]] = defaultdict(list)
    for r in results:
        groups[r.spec.group_key()].append(r)

    per_group = []
    agg: dict[str, dict] = defaultdict(
        lambda: {"n": 0, "n_feasible": 0, "n_errors": 0, "gap_pct_sum": 0.0,
                 "gap_pct_max": 0.0, "n_gap": 0, "speedup_sum": 0.0,
                 "n_speedup": 0, "pareto_count": 0, "accept_sum": 0.0,
                 "n_accept": 0})

    for key, rs in sorted(groups.items()):
        feas = [r for r in rs if r.feasible]
        ref = None
        for r in feas:
            if _is_optimal(r):
                if ref is None or r.latency_s < ref.latency_s:
                    ref = r
        if ref is None and feas:
            ref = min(feas, key=lambda r: r.latency_s)

        entry = {"group": rs[0].spec.tags.get("cell", key[:48]),
                 "tags": rs[0].spec.tags,
                 "reference_solver": ref.spec.solver if ref else None,
                 "solvers": {}}
        points = []
        for r in rs:
            a = agg[r.spec.solver]
            a["n"] += 1
            row: dict = {"feasible": r.feasible,
                         "status": r.status,
                         "wall_time_s": r.wall_time_s,
                         "iterations": r.iterations}
            if r.error is not None:  # crashed scenario (status="error")
                row["error"] = r.error
                a["n_errors"] += 1
                entry["solvers"][r.spec.solver] = row
                continue
            if r.acceptance_ratio is not None:  # serve (fleet) scenario
                # gap/speedup/Pareto compare one plan against the optimum;
                # a fleet's mean latency averages a *different accepted set*
                # per scheme, so fleets compare on acceptance ratio instead.
                row["n_requests"] = r.spec.n_requests
                row["n_accepted"] = r.n_accepted
                row["acceptance_ratio"] = r.acceptance_ratio
                row["latency_mean_s"] = r.latency_s
                row["latency_p50_s"] = r.latency_p50_s
                row["latency_p95_s"] = r.latency_p95_s
                row["latency_p99_s"] = r.latency_p99_s
                if r.eval_cache_hit_rate is not None:
                    row["eval_cache_hit_rate"] = r.eval_cache_hit_rate
                if r.plan_cache_hit_rate is not None:
                    row["plan_cache_hit_rate"] = r.plan_cache_hit_rate
                if r.spec.sim or r.spec.gateway:  # event-driven scenario
                    row["sim"] = True
                    row["blocking_probability"] = r.blocking_probability
                    row["peak_concurrent"] = r.peak_concurrent
                    row["n_retried"] = r.n_retried
                if r.spec.gateway:  # streaming gateway (docs/gateway.md)
                    row["gateway"] = True
                    if r.gateway:
                        row["gateway_stats"] = r.gateway
                a["accept_sum"] += r.acceptance_ratio
                a["n_accept"] += 1
                if r.feasible:
                    a["n_feasible"] += 1
                entry["solvers"][r.spec.solver] = row
                continue
            if r.feasible:
                a["n_feasible"] += 1
                row["latency_s"] = r.latency_s
                if ref is not None and ref.latency_s > 0:
                    gap = (r.latency_s - ref.latency_s) / ref.latency_s * 100.0
                    row["gap_pct"] = gap
                    a["gap_pct_sum"] += gap
                    a["gap_pct_max"] = max(a["gap_pct_max"], gap)
                    a["n_gap"] += 1
                if ref is not None and r.wall_time_s > 0:
                    row["speedup_vs_ref"] = ref.wall_time_s / r.wall_time_s
                    a["speedup_sum"] += row["speedup_vs_ref"]
                    a["n_speedup"] += 1
                points.append((r.spec.solver, r.latency_s, r.wall_time_s))
            entry["solvers"][r.spec.solver] = row
        front = _pareto(points)
        entry["pareto_front"] = sorted(front)
        for s in front:
            agg[s]["pareto_count"] += 1
        per_group.append(entry)

    summary = {}
    for solver, a in sorted(agg.items()):
        summary[solver] = {
            "n": a["n"],
            "n_feasible": a["n_feasible"],
            "n_errors": a["n_errors"],
            "mean_gap_pct": a["gap_pct_sum"] / a["n_gap"] if a["n_gap"] else None,
            "max_gap_pct": a["gap_pct_max"] if a["n_gap"] else None,
            "mean_speedup_vs_ref": (a["speedup_sum"] / a["n_speedup"]
                                    if a["n_speedup"] else None),
            "pareto_count": a["pareto_count"],
            "mean_acceptance_ratio": (a["accept_sum"] / a["n_accept"]
                                      if a["n_accept"] else None),
        }

    pairs = schedule_pairs(results)
    schedule_cmp = None
    if pairs:
        sp = [p["speedup"] for p in pairs.values()]
        schedule_cmp = {
            "n_pairs": len(sp),
            "mean_speedup": sum(sp) / len(sp),
            "min_speedup": min(sp),
            "max_speedup": max(sp),
            "pairs": pairs,
        }
    cpairs = churn_pairs(results)
    churn_cmp = None
    if cpairs:
        up = [p["uplift"] for p in cpairs.values()]
        churn_cmp = {
            "n_pairs": len(up),
            "mean_uplift": sum(up) / len(up),
            "min_uplift": min(up),
            "max_uplift": max(up),
            "pairs": cpairs,
        }
    frows = failure_rows(results)
    failure_cmp = None
    if frows:
        n_failed = sum(row["n_failed"] for row in frows)
        n_restored = sum(row["n_restored"] for row in frows)
        p95s = [row["restore_p95_s"] for row in frows
                if row["restore_p95_s"] is not None]
        failure_cmp = {
            "n_scenarios": len(frows),
            "n_failed": n_failed,
            "n_restored": n_restored,
            "n_killed": n_failed - n_restored,
            "survivability": (n_restored / n_failed) if n_failed else None,
            "worst_restore_p95_s": max(p95s) if p95s else None,
            "moved_bytes": sum(row["moved_bytes"] or 0.0 for row in frows),
            "rows": frows,
        }
    trows = training_rows(results)
    training_cmp = None
    if trows:
        def _mode_totals(mode: str) -> tuple[int, int]:
            n = sum(row["mode_split"].get(mode, {}).get("n_requests", 0)
                    for row in trows)
            acc = sum(row["mode_split"].get(mode, {}).get("n_accepted", 0)
                      for row in trows)
            return n, acc

        n_tr, acc_tr = _mode_totals("TR")
        n_if, acc_if = _mode_totals("IF")
        training_cmp = {
            "n_scenarios": len(trows),
            "n_train_requests": n_tr,
            "train_acceptance": (acc_tr / n_tr) if n_tr else None,
            "n_inference_requests": n_if,
            "inference_acceptance": (acc_if / n_if) if n_if else None,
            "rows": trows,
        }
    return {"n_groups": len(per_group), "summary": summary,
            "schedule_comparison": schedule_cmp,
            "churn_comparison": churn_cmp,
            "failure_survivability": failure_cmp,
            "training_contention": training_cmp, "groups": per_group}


def format_report(report: dict) -> str:
    lines = [f"comparison over {report['n_groups']} scenario groups",
             f"{'solver':<10} {'feas':>9} {'mean gap%':>10} {'max gap%':>10} "
             f"{'speedup':>9} {'pareto':>7} {'accept':>7}"]
    for solver, s in report["summary"].items():
        gap = "-" if s["mean_gap_pct"] is None else f"{s['mean_gap_pct']:.2f}"
        mgap = "-" if s["max_gap_pct"] is None else f"{s['max_gap_pct']:.2f}"
        spd = ("-" if s["mean_speedup_vs_ref"] is None
               else f"{s['mean_speedup_vs_ref']:.1f}x")
        acc = ("-" if s.get("mean_acceptance_ratio") is None
               else f"{s['mean_acceptance_ratio']:.2f}")
        lines.append(f"{solver:<10} {s['n_feasible']:>4}/{s['n']:<4} {gap:>10} "
                     f"{mgap:>10} {spd:>9} {s['pareto_count']:>7} {acc:>7}")
    n_err = sum(s.get("n_errors", 0) for s in report["summary"].values())
    if n_err:
        lines.append(f"! {n_err} scenario(s) crashed (status=error) — see "
                     f"per-group rows for messages")
    sc = report.get("schedule_comparison")
    if sc:
        lines.append(
            f"seq-vs-pipe: {sc['n_pairs']} pairs, speedup "
            f"mean {sc['mean_speedup']:.2f}x, min {sc['min_speedup']:.2f}x, "
            f"max {sc['max_speedup']:.2f}x")
        by_m: dict[int, list[float]] = {}
        for p in sc["pairs"].values():
            by_m.setdefault(p["n_microbatches"], []).append(p["speedup"])
        for m in sorted(by_m):
            sp = by_m[m]
            lines.append(f"  M={m:<4} {len(sp):>3} pairs, "
                         f"mean speedup {sum(sp) / len(sp):.2f}x")
    cc = report.get("churn_comparison")
    if cc:
        lines.append(
            f"static-vs-churn: {cc['n_pairs']} pairs, acceptance uplift "
            f"mean {cc['mean_uplift']:+.2f}, min {cc['min_uplift']:+.2f}, "
            f"max {cc['max_uplift']:+.2f}")
        for sid, p in sorted(cc["pairs"].items(), key=lambda kv: kv[1]["cell"]):
            lines.append(
                f"  {p['cell']:<16} {p['driver']:<7} {p['solver']:<8} "
                f"static {p['static_accepted']}/{p['n_requests']} -> churn "
                f"{p['churn_accepted']}/{p['n_requests']} "
                f"(uplift {p['uplift']:+.2f}, peak {p['peak_concurrent']} "
                f"concurrent)")
    fc = report.get("failure_survivability")
    if fc:
        surv = ("-" if fc["survivability"] is None
                else f"{fc['survivability']:.2f}")
        p95 = ("-" if fc["worst_restore_p95_s"] is None
               else f"{fc['worst_restore_p95_s']:.2f}s")
        lines.append(
            f"failures: {fc['n_scenarios']} scenarios, "
            f"{fc['n_failed']} chains hit, {fc['n_restored']} restored, "
            f"{fc['n_killed']} killed (survivability {surv}), worst restore "
            f"p95 {p95}, moved {fc['moved_bytes'] / 1e6:.1f} MB")
        for row in sorted(fc["rows"],
                          key=lambda x: (x["cell"], x["variant"])):
            sv = ("-" if row["survivability"] is None
                  else f"{row['survivability']:.2f}")
            lines.append(
                f"  {row['cell']:<16} {row['variant']:<10} "
                f"rate {row['failure_rate']:<5} "
                f"{'ha ' if row['ha'] else '   '}"
                f"hit {row['n_failed']:>2} restored {row['n_restored']:>2} "
                f"killed {row['n_killed']:>2} (surv {sv})")
    tc = report.get("training_contention")
    if tc:
        ta = ("-" if tc["train_acceptance"] is None
              else f"{tc['train_acceptance']:.2f}")
        ia = ("-" if tc["inference_acceptance"] is None
              else f"{tc['inference_acceptance']:.2f}")
        lines.append(
            f"training contention: {tc['n_scenarios']} mixed fleets, "
            f"TR accept {ta} ({tc['n_train_requests']} reqs), "
            f"IF accept {ia} ({tc['n_inference_requests']} reqs)")
        for row in sorted(tc["rows"],
                          key=lambda x: (x["cell"], x["train_share"])):
            parts = []
            for m in ("TR", "IF"):
                ms = row["mode_split"].get(m)
                if ms is None:
                    continue
                p95 = ms.get("latency_p95_s")
                p95s = "-" if p95 is None else f"{p95 * 1e3:.1f}ms"
                parts.append(f"{m} {ms['n_accepted']}/{ms['n_requests']} "
                             f"p95 {p95s}")
            delta = row.get("if_acceptance_delta")
            tail = "" if delta is None else f" (IF delta {delta:+.2f})"
            lines.append(f"  {row['cell']:<20} share {row['train_share']:<4} "
                         + ", ".join(parts) + tail)
    return "\n".join(lines)
