"""Structured sweep artifacts: one JSON document per suite run plus a flat CSV.

The JSON artifact is self-contained — every record embeds its full
ScenarioSpec, so ``load_artifact`` can rebuild and re-verify any plan without
the code that generated it (see ``runner.verify_result``).
"""
from __future__ import annotations

import csv
import json
import time
from pathlib import Path

from .report import churn_pairs, comparison_report, schedule_pairs
from .runner import ScenarioResult
from .spec import SUITE_SCHEMA_VERSION

CSV_FIELDS = [
    "scenario_id", "suite", "figure", "cell", "topology", "profile", "mode",
    "K", "batch_size", "schedule", "n_microbatches", "solver",
    "candidate_seed", "feasible", "status", "error", "latency_s",
    "computation_s", "transmission_s", "propagation_s", "bubble_s",
    # seq-vs-pipe pairing (pipe rows with a feasible seq counterpart only)
    "seq_latency_s", "pipe_speedup",
    "wall_time_s", "iterations", "from_cache",
    # serve-layer (fleet) columns; empty for single-chain scenarios
    "n_requests", "policy", "arrival", "n_accepted", "acceptance_ratio",
    "latency_p50_s", "latency_p95_s", "latency_p99_s",
    # event-driven sim columns (docs/sim.md); empty for static scenarios
    "sim", "hold_model", "duration_s", "retry",
    "blocking_probability", "peak_concurrent", "n_retried",
    # static-vs-churn pairing (sim/gateway rows with a static counterpart)
    "static_acceptance", "churn_uplift",
    # streaming gateway columns (docs/gateway.md); empty otherwise
    "gateway", "batch_window_s", "max_queue", "slo_latency_s",
    # cache observability (serve scenarios): hit rates over the run
    "eval_cache_hit_rate", "plan_cache_hit_rate",
    # substrate failures + live migration (docs/failures.md); empty otherwise
    "failure_rate", "ha", "n_failed", "n_restored", "restore_p95_s",
    "moved_bytes",
    # mixed training fleets (docs/training.md); empty for pure-mode fleets
    "train_share", "tr_n_requests", "tr_n_accepted", "tr_acceptance_ratio",
    "tr_latency_p50_s", "tr_latency_p95_s", "tr_latency_p99_s",
    "if_n_requests", "if_n_accepted", "if_acceptance_ratio",
    "if_latency_p50_s", "if_latency_p95_s", "if_latency_p99_s",
]


def _opt(v):
    return "" if v is None else v


def write_artifacts(out_dir: str | Path, suite_name: str,
                    results: list[ScenarioResult],
                    meta: dict | None = None) -> dict[str, Path]:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    report = comparison_report(results)
    doc = {
        "schema_version": SUITE_SCHEMA_VERSION,
        "suite": suite_name,
        "created_unix": time.time(),
        "meta": meta or {},
        "report": report,
        "results": [r.to_dict() for r in results],
    }
    json_path = out / f"{suite_name}.json"
    json_path.write_text(json.dumps(doc, indent=1))

    csv_path = out / f"{suite_name}.csv"
    pairs = schedule_pairs(results)
    cpairs = churn_pairs(results)
    with csv_path.open("w", newline="") as fh:
        w = csv.DictWriter(fh, fieldnames=CSV_FIELDS)
        w.writeheader()
        for r in results:
            s = r.spec
            pair = pairs.get(s.scenario_id())
            cpair = cpairs.get(s.scenario_id())
            w.writerow({
                "scenario_id": s.scenario_id(),
                "suite": s.tags.get("suite", suite_name),
                "figure": s.tags.get("figure", ""),
                "cell": s.tags.get("cell", ""),
                "topology": s.topology,
                "profile": s.profile,
                "mode": s.mode,
                "K": s.K,
                "batch_size": s.batch_size,
                "schedule": s.schedule,
                "n_microbatches": s.n_microbatches,
                "solver": s.solver,
                "candidate_seed": s.candidate_seed,
                "feasible": r.feasible,
                "status": _opt(r.status),
                "error": _opt(r.error),
                "latency_s": r.latency_s,
                "computation_s": r.computation_s,
                "transmission_s": r.transmission_s,
                "propagation_s": r.propagation_s,
                "bubble_s": _opt(r.bubble_s),
                "seq_latency_s": _opt(pair["seq_latency_s"] if pair else None),
                "pipe_speedup": _opt(pair["speedup"] if pair else None),
                "wall_time_s": r.wall_time_s,
                "iterations": r.iterations,
                "from_cache": r.from_cache,
                "n_requests": s.n_requests if s.n_requests > 1 else "",
                "policy": s.policy if s.n_requests > 1 else "",
                "arrival": s.arrival if s.n_requests > 1 else "",
                "n_accepted": _opt(r.n_accepted),
                "acceptance_ratio": _opt(r.acceptance_ratio),
                "latency_p50_s": _opt(r.latency_p50_s),
                "latency_p95_s": _opt(r.latency_p95_s),
                "latency_p99_s": _opt(r.latency_p99_s),
                "sim": s.sim if s.n_requests > 1 else "",
                "hold_model": s.hold_model if (s.sim or s.gateway) else "",
                "duration_s": _opt(s.duration_s if (s.sim or s.gateway)
                                   else None),
                "retry": s.retry if (s.sim or s.gateway) else "",
                "blocking_probability": _opt(r.blocking_probability),
                "peak_concurrent": _opt(r.peak_concurrent),
                "n_retried": _opt(r.n_retried),
                "static_acceptance": _opt(
                    cpair["static_acceptance"] if cpair else None),
                "churn_uplift": _opt(cpair["uplift"] if cpair else None),
                "gateway": s.gateway if s.n_requests > 1 else "",
                "batch_window_s": _opt(s.batch_window_s if s.gateway
                                       else None),
                "max_queue": _opt(s.max_queue if s.gateway else None),
                "slo_latency_s": _opt(s.slo_latency_s if s.gateway else None),
                "eval_cache_hit_rate": _opt(r.eval_cache_hit_rate),
                "plan_cache_hit_rate": _opt(r.plan_cache_hit_rate),
                "failure_rate": _opt(s.failure_rate if (s.sim or s.gateway)
                                     else None),
                "ha": s.ha if (s.sim or s.gateway) else "",
                "n_failed": _opt(r.n_failed),
                "n_restored": _opt(r.n_restored),
                "restore_p95_s": _opt(r.restore_p95_s),
                "moved_bytes": _opt(r.moved_bytes),
                "train_share": _opt(s.train_share if s.n_requests > 1
                                    else None),
                **{f"{m.lower()}_{col}": _opt(
                    (r.mode_split or {}).get(m, {}).get(col))
                   for m in ("TR", "IF")
                   for col in ("n_requests", "n_accepted", "acceptance_ratio",
                               "latency_p50_s", "latency_p95_s",
                               "latency_p99_s")},
            })
    return {"json": json_path, "csv": csv_path}


def load_artifact(path: str | Path) -> tuple[dict, list[ScenarioResult]]:
    """Read a suite JSON artifact back into (meta document, results)."""
    doc = json.loads(Path(path).read_text())
    results = [ScenarioResult.from_dict(d) for d in doc["results"]]
    meta = {k: v for k, v in doc.items() if k != "results"}
    return meta, results
