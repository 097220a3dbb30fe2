"""Scenario-sweep engine of the port: declarative scenario specs, named
suites, a cached runner with a spawned worker pool, and structured artifacts
+ comparison reports.

The paper's evaluation (Sec. VI, Figs. 4-11) is a grid of scenarios —
topology x model profile x request mode x cut count K x solver.  This package
turns each grid point into a serializable :class:`ScenarioSpec`, groups them
into named suites (``repro_torch.sweep.suites.SUITES``, which sweep the BCD
scheme as ``bcd_torch``), executes them through :class:`SweepRunner` (the
solvers on its device, the card by default; shared ``EvalCache`` /
Dijkstra-frontier tables, a batched presolve, an on-disk result cache) and
emits JSON/CSV artifacts with a BCD-vs-optimal comparison and Pareto report.

CLI:  ``PYTHONPATH=src python -m repro_torch.sweep --suite nsfnet_paper --quick``
(``--device cpu`` without a card)
"""
from .report import churn_pairs, comparison_report, format_report, schedule_pairs
from .runner import ScenarioResult, SweepRunner, run_scenario, verify_result
from .spec import (SUITE_SCHEMA_VERSION, ScenarioSpec, apply_faults,
                   build_profile, build_topology, candidate_sets)
from .suites import SUITES

__all__ = [
    "SUITE_SCHEMA_VERSION", "ScenarioSpec", "ScenarioResult", "SweepRunner",
    "SUITES", "apply_faults", "build_profile", "build_topology",
    "candidate_sets", "churn_pairs", "comparison_report", "format_report",
    "run_scenario", "schedule_pairs", "verify_result",
]
