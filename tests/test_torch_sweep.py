"""The port's sweep engine (``repro_torch.sweep``) on the CPU: the JAX
package's ``tests/test_sweep.py``, case for case, with ``bcd_torch``
where that file sweeps ``bcd`` and every runner on ``device="cpu"``; then
what the port adds: the runner and the CLI on the card by default (and
raising, or exiting 2, without one), the worker pool spawned, the batched
presolve taking every ``bcd_torch`` scenario it may, and the CLI's solver
list naming the port's registry.

The suites' parity with the JAX package is in
``tests/test_torch_sweep_suites.py`` and ``tests/test_torch_sweep_fleets.py``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import random

import pytest
import torch

import chip_smoke as cs
import repro_torch.core as T
import repro_torch.sweep as W
from repro_torch.core import IF, TR, EvalCache, LayerProfile, ModelProfile
from repro_torch.sweep import (
    SUITES,
    ScenarioSpec,
    SweepRunner,
    apply_faults,
    comparison_report,
    run_scenario,
    verify_result,
)
from repro_torch.sweep import runner as WR
from repro_torch.sweep.artifacts import load_artifact, write_artifacts
from repro_torch.sweep.runner import clear_context
from repro_torch.sweep.spec import build_topology
from repro_torch.sweep.suites import BCD

CPU = "cpu"
pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture
def one_thread():
    """torch on one thread for the test: a sweep on the CPU is many small
    tensor operations, and in a parallel test run the workers' intra-op
    thread pools oversubscribe the cores (a 6 s test here took 370 s in
    each of six processes at once; 12 s on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _spec(**kw) -> ScenarioSpec:
    base = dict(topology="nsfnet", topology_kwargs={"source": "v4"},
                profile="resnet101", source="v4", destination="v13",
                batch_size=2, mode=IF, K=3, solver=BCD,
                candidates=[["v4"], ["v7", "v11"], ["v13"]],
                tags={"suite": "test"})
    base.update(kw)
    return ScenarioSpec(**base)


# ------------------------------------------------------------------ spec schema
def test_spec_dict_round_trip():
    spec = _spec(drop_links=[("v4", "v5")], solver_kwargs={})
    d = spec.to_dict()
    json.loads(json.dumps(d))  # JSON-able
    clone = ScenarioSpec.from_dict(d)
    assert clone == spec
    assert clone.key() == spec.key()
    assert clone.spec_hash() == spec.spec_hash()


def test_spec_hash_ignores_labels_but_not_solve_fields():
    a, b = _spec(), _spec(name="renamed", tags={"x": "1"})
    assert a.spec_hash() == b.spec_hash()
    assert a.group_key() == _spec(solver="exact").group_key()
    assert a.spec_hash() != _spec(batch_size=4).spec_hash()


def test_spec_validation():
    with pytest.raises(ValueError):
        _spec(mode="XX")
    with pytest.raises(ValueError):
        _spec(solver="magic")
    with pytest.raises(KeyError):
        ScenarioSpec(topology="nope").build_network()


def test_fault_injection_removes_nodes_and_links():
    net = build_topology("nsfnet", {"source": "v4"})
    faulted = apply_faults(net, drop_nodes=["v7"], drop_links=[("v4", "v5")])
    assert "v7" not in faulted.nodes
    assert all("v7" not in e for e in faulted.links)
    assert ("v4", "v5") not in faulted.links
    assert ("v5", "v4") not in faulted.links
    assert ("v4", "v2") in faulted.links  # the rest of the fabric survives


# ------------------------------------------------------- cache-hit equivalence
def test_profile_prefix_sums_match_naive():
    rng = random.Random(0)
    layers = [LayerProfile(f"l{i}", rng.uniform(1e6, 1e9), rng.uniform(1e6, 1e9),
                           rng.uniform(1e3, 1e6), rng.uniform(1e3, 1e6),
                           rng.uniform(1e3, 1e8), rng.uniform(1e3, 1e8))
              for i in range(12)]
    prof = ModelProfile("rand", layers)
    for lo in range(1, 13):
        for hi in range(lo, 13):
            assert math.isclose(prof.seg_flops(lo, hi, "FW"),
                                sum(l.flops_fw for l in layers[lo - 1:hi]),
                                rel_tol=1e-12)
            assert math.isclose(prof.seg_mem_bytes(lo, hi),
                                sum(l.mem_bytes for l in layers[lo - 1:hi]),
                                rel_tol=1e-12)


@pytest.mark.parametrize("solver", ["exact", BCD, "comp-ms", "comm-ms"])
def test_cached_vs_uncached_identical(solver):
    spec = _spec(solver=solver, mode=TR, batch_size=128)
    cold = run_scenario(spec, use_context_cache=False, device=CPU)
    clear_context()
    warm1 = run_scenario(spec, device=CPU)  # populates the context caches
    warm2 = run_scenario(spec, device=CPU)  # served from the warm caches
    for warm in (warm1, warm2):
        assert warm.feasible == cold.feasible
        assert warm.latency_s == pytest.approx(cold.latency_s, rel=1e-12)
        assert warm.segments == cold.segments
        assert warm.placement == cold.placement
        assert warm.paths == cold.paths


def test_eval_cache_shared_across_seeds_matches_private():
    """The shared EvalCache of the runner's context, through the solver
    that uses it: the host ``bcd`` (``bcd_torch`` keeps its tables on the
    device and takes no cache)."""
    shared = EvalCache()
    spec_a = _spec(candidates=None, candidate_seed=0)
    spec_b = _spec(candidates=None, candidate_seed=1)
    net, prof = spec_a.build_network(), spec_a.build_profile()
    from repro_torch.core.bcd import bcd_solve

    lat_private = [
        bcd_solve(net, prof, s.request(), s.K, s.build_candidates(net)).latency_s
        for s in (spec_a, spec_b)
    ]
    lat_shared = [
        bcd_solve(net, prof, s.request(), s.K, s.build_candidates(net),
                  cache=shared).latency_s
        for s in (spec_a, spec_b)
    ]
    assert lat_shared == pytest.approx(lat_private, rel=1e-12)
    assert shared.comp  # the shared tables were actually used


# -------------------------------------------------- artifacts + disk cache
def test_run_artifact_reload_round_trip(tmp_path):
    specs = [_spec(solver=s) for s in ("exact", BCD)]
    results = SweepRunner(workers=0, device=CPU).run(specs)
    paths = write_artifacts(tmp_path, "unit", results, meta={"quick": True})
    meta, reloaded = load_artifact(paths["json"])
    assert meta["suite"] == "unit" and meta["meta"]["quick"] is True
    assert len(reloaded) == len(results)
    for orig, back in zip(results, reloaded):
        assert back.spec == orig.spec
        assert back.latency_s == orig.latency_s
        # reconstruct the plan from the artifact and re-evaluate it
        assert verify_result(back)
    assert paths["csv"].read_text().count("\n") == len(results) + 1


def test_runner_without_context_cache_matches():
    specs = [_spec(solver=BCD), _spec(solver="exact")]
    warm = SweepRunner(workers=0, device=CPU).run(specs)
    cold = SweepRunner(workers=0, use_context_cache=False,
                       device=CPU).run(specs)
    for w, c in zip(warm, cold):
        assert c.latency_s == pytest.approx(w.latency_s, rel=1e-12)
        assert c.segments == w.segments and c.placement == w.placement


def test_workers_mapping_is_explicit():
    """0/1 -> serial in-process, n>=2 -> n processes, None/negative -> all
    cores (the documented contract of SweepRunner/the --workers flag)."""
    import os

    cpus = os.cpu_count() or 1
    assert SweepRunner.resolve_workers(0) == 0
    assert SweepRunner.resolve_workers(1) == 1
    assert SweepRunner.resolve_workers(4) == 4
    assert SweepRunner.resolve_workers(None) == cpus
    assert SweepRunner.resolve_workers(-1) == cpus
    assert SweepRunner(workers=0, device=CPU).workers == 0  # serial default
    assert SweepRunner(workers=None, device=CPU).workers == cpus


def test_disk_cache_serves_second_run(tmp_path):
    specs = [_spec(solver=s) for s in ("exact", BCD, "comm-ms")]
    runner = SweepRunner(cache_dir=tmp_path / "cache", workers=0, device=CPU)
    cold = runner.run(specs)
    assert runner.last_stats["n_solved"] == 3
    warm = runner.run(specs)
    assert runner.last_stats["n_cache_hits"] == 3
    assert runner.last_stats["n_solved"] == 0
    for c, w in zip(cold, warm):
        assert w.from_cache and not c.from_cache
        assert w.latency_s == c.latency_s
        assert w.segments == c.segments


# ---------------------------------------------------------- error robustness
def _crashing_spec():
    """K=9 on 14-node NSFNET: candidate_sets needs 14 intermediates but only
    12 exist — raises at fleet/candidate construction inside the scenario."""
    return ScenarioSpec(topology="nsfnet", topology_kwargs={"source": "v4"},
                        profile="resnet101", source="v4", destination="v13",
                        batch_size=2, mode=IF, K=9, solver=BCD,
                        tags={"suite": "test"})


@pytest.mark.parametrize("workers", [0, 2])
def test_one_crashing_scenario_does_not_lose_the_sweep(workers, tmp_path):
    specs = [_spec(solver="exact"), _crashing_spec(), _spec(solver=BCD)]
    runner = SweepRunner(cache_dir=tmp_path / "cache", workers=workers,
                         device=CPU)
    results = runner.run(specs)
    assert len(results) == 3
    assert results[0].feasible and results[2].feasible
    bad = results[1]
    assert not bad.feasible and bad.status == "error"
    assert "candidate_sets" in bad.error and "K=9" in bad.error
    assert runner.last_stats["n_errors"] == 1
    assert runner.last_stats["n_solved"] == 2
    assert bad.spec.scenario_id() in runner.last_stats["errors"]
    assert not verify_result(bad)  # a crashed scenario is never verifiable
    # completed results were stored; the errored one is retried next run
    warm = runner.run(specs)
    assert runner.last_stats["n_cache_hits"] == 2
    assert runner.last_stats["n_errors"] == 1
    assert warm[0].from_cache and warm[2].from_cache


def test_error_results_survive_artifacts_and_report(tmp_path):
    results = SweepRunner(workers=0, device=CPU).run(
        [_spec(solver=BCD), _crashing_spec()])
    report = comparison_report(results)
    assert report["summary"][BCD]["n_errors"] == 1
    paths = write_artifacts(tmp_path, "unit_err", results)
    _, reloaded = load_artifact(paths["json"])
    assert reloaded[1].status == "error" and "candidate_sets" in reloaded[1].error
    assert "error" in paths["csv"].read_text().splitlines()[0]


# ------------------------------------------------- serve status threading
def test_serve_scenario_populates_status_and_solver_stats():
    """Regression: serve rows used to report status=None despite the engine
    dispatch — the planner's solve outcomes must reach the artifact."""
    spec = ScenarioSpec(topology="nsfnet", topology_kwargs={"source": "v4"},
                        profile="resnet101", source="v4", destination="v13",
                        batch_size=2, mode=IF, K=3, solver="exact",
                        n_requests=4, policy="fcfs", tags={"suite": "test"})
    result = run_scenario(spec, use_context_cache=False, device=CPU)
    assert result.feasible
    assert result.status == "optimal"  # every accepted solve was the exact DP
    stats = result.solver_stats
    assert stats["n_presolved"] >= 1
    assert sum(stats["statuses"].values()) == 4
    bcd = run_scenario(ScenarioSpec.from_dict(
        {**spec.to_dict(), "solver": BCD}), use_context_cache=False,
        device=CPU)
    assert bcd.status == "feasible"  # heuristic solves are never optimal


# ----------------------------------------------------------------- suite smoke
def test_nsfnet_paper_quick_suite_smoke():
    specs = SUITES["nsfnet_paper"](quick=True, modes=(IF,),
                                   schemes=("exact", BCD))
    results = SweepRunner(workers=0, device=CPU).run(specs)
    assert len(results) == len(specs)
    assert all(r.feasible for r in results)
    report = comparison_report(results)
    # the exact DP is the optimality reference: BCD can never beat it
    assert report["summary"][BCD]["mean_gap_pct"] >= -1e-6
    assert report["summary"]["exact"]["max_gap_pct"] == pytest.approx(0.0, abs=1e-9)
    for r in results:
        assert verify_result(r)


def test_all_suites_build():
    for name, fn in SUITES.items():
        specs = fn(quick=True)
        assert specs, name
        for s in specs:
            assert ScenarioSpec.from_dict(s.to_dict()) == s


# ------------------------------------------------ mixed training fleets (v8)
def test_train_share_validation_and_twin_key():
    serve = dict(n_requests=6, arrival="poisson", policy="fcfs")
    with pytest.raises(ValueError):
        _spec(train_share=1.5, **serve)
    with pytest.raises(ValueError):
        _spec(train_share=0.5)  # single-chain scenario has no fleet to mix
    mixed = _spec(train_share=0.5, **serve)
    twin = _spec(train_share=0.0, **serve)
    # training_key pairs a mixed fleet with its all-IF twin and nothing else
    assert mixed.training_key() == twin.training_key()
    assert mixed.spec_hash() != twin.spec_hash()
    assert mixed.training_key() != _spec(
        train_share=0.5, n_requests=8, arrival="poisson",
        policy="fcfs").training_key()
    clone = ScenarioSpec.from_dict(mixed.to_dict())
    assert clone == mixed and clone.train_share == 0.5


def test_mixed_training_suite_pairs_every_cell_with_if_twin():
    specs = SUITES["nsfnet_mixed_training"](quick=True)
    assert specs
    by_key: dict[str, set[float]] = {}
    for s in specs:
        assert s.schedule == "pipe" and s.n_microbatches > 1
        by_key.setdefault(s.training_key(), set()).add(s.train_share)
    for shares in by_key.values():
        assert 0.0 in shares and len(shares) > 1  # every cell has its twin


def test_training_contention_report_and_csv_columns(tmp_path):
    from repro_torch.sweep.report import training_rows

    serve = dict(n_requests=6, arrival="poisson", policy="fcfs",
                 schedule="pipe", n_microbatches=4, candidate_seed=1,
                 candidates=None)
    specs = [_spec(train_share=s, name=f"mix{s}", **serve)
             for s in (0.0, 0.5)]
    results = SweepRunner(workers=0, device=CPU).run(specs)
    mixed = next(r for r in results if r.spec.train_share == 0.5)
    assert mixed.mode_split and set(mixed.mode_split) <= {"IF", "TR"}
    rows = training_rows(results)
    assert len(rows) == 1 and rows[0]["train_share"] == 0.5
    assert rows[0]["all_if_acceptance"] is not None  # twin was paired
    report = comparison_report(results)
    tc = report["training_contention"]
    assert tc["n_scenarios"] == 1
    assert (tc["n_train_requests"] + tc["n_inference_requests"]) == 6
    # artifacts: per-mode columns land in the CSV, JSON reloads bit-equal
    paths = write_artifacts(tmp_path, "mix", results)
    header = paths["csv"].read_text().splitlines()[0].split(",")
    for col in ("train_share", "tr_acceptance_ratio", "if_acceptance_ratio",
                "tr_latency_p95_s", "if_latency_p95_s"):
        assert col in header
    _, loaded = load_artifact(paths["json"])
    reloaded = next(r for r in loaded if r.spec.train_share == 0.5)
    assert reloaded.mode_split == mixed.mode_split


# ------------------------------------------------- what the port adds: device
def test_runner_without_a_card_raises_naming_the_cpu(monkeypatch):
    """The runner resolves its device when it is built: the card by
    default, and without one it raises unless ``device="cpu"``."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SweepRunner()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_scenario(_spec())  # a bcd_torch spec on the default card
    assert SweepRunner(device=CPU).device == torch.device("cpu")
    # host solvers take no device: their specs run under any runner device
    assert run_scenario(_spec(solver="exact")).feasible


def test_a_device_named_by_the_spec_is_kept(monkeypatch):
    """A device in a spec's ``solver_kwargs`` wins over the runner's; the
    spec's key and hash name no runner device, so one disk-cache entry
    serves both devices."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = _spec(solver_kwargs={"device": "cpu"})
    assert run_scenario(spec, device="cuda").feasible
    assert "device" not in _spec().key()
    assert (run_scenario(_spec(), device=CPU).latency_s
            == run_scenario(spec, device=CPU).latency_s)


def test_cli_without_a_card_exits_2_naming_the_cpu(monkeypatch, capsys,
                                                   tmp_path):
    from repro_torch.sweep.__main__ import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        main(["--suite", "nsfnet_faults", "--quick", "--out", str(tmp_path)])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "no CUDA device" in err and "--device cpu" in err
    assert main(["--suite", "nsfnet_faults", "--quick", "--device", "cpu",
                 "--no-cache", "--out", str(tmp_path)]) == 0
    doc = json.loads((tmp_path / "nsfnet_faults.json").read_text())
    assert {r["spec"]["solver"] for r in doc["results"]} == {"exact", BCD}


def test_cli_lists_the_ports_solvers(capsys):
    from repro_torch.core.engine import solver_names
    from repro_torch.sweep.__main__ import main

    assert main(["--list-solvers"]) == 0
    listed = [ln.split()[0] for ln in capsys.readouterr().out.splitlines()[1:]]
    assert listed == list(solver_names())
    assert {"bcd_torch", "dfts_torch", "bcd", "exact", "ilp"} <= set(listed)


# ---------------------------------------------- what the port adds: the pool
def test_the_pool_is_spawned_and_matches_the_serial_run(monkeypatch,
                                                        tmp_path):
    """``workers=2`` runs in spawned processes (a forked child cannot
    initialise CUDA again) and gives the serial run's results; a crashing
    spec is still captured as an error."""
    methods = []

    class Recording(WR.ProcessPoolExecutor):
        def __init__(self, *args, mp_context=None, **kw):
            methods.append(mp_context.get_start_method())
            super().__init__(*args, mp_context=mp_context, **kw)

    monkeypatch.setattr(WR, "ProcessPoolExecutor", Recording)
    specs = [_spec(solver=BCD), _spec(solver="exact"), _crashing_spec(),
             _spec(solver=BCD, mode=TR, batch_size=128),
             _spec(solver=BCD, n_requests=4, policy="fcfs", candidates=None)]
    pooled = SweepRunner(workers=2, device=CPU).run(specs)
    serial = SweepRunner(workers=0, device=CPU).run(specs)
    assert methods == ["spawn"]
    assert [r.status for r in pooled][2] == "error"
    assert pooled[2].error == serial[2].error
    assert (cs.sweep_view(W, pooled, tmp_path / "pool")
            == cs.sweep_view(W, serial, tmp_path / "serial"))


# ---------------------------------------- what the port adds: the presolve
def test_presolve_takes_every_eligible_bcd_torch_spec(monkeypatch):
    """Every single-chain ``bcd_torch`` spec of a group of two or more is
    in a map ``_batch_presolve`` returned, and the run then solves none of
    them one by one; a group of one and the fleets are solved in
    ``run_scenario``."""
    specs = SUITES["nsfnet_paper"](quick=True, modes=(IF,),
                                   schemes=("exact", BCD))
    lone = _spec(solver=BCD, solver_kwargs={"max_iters": 40})
    fleet = _spec(solver=BCD, n_requests=4, policy="fcfs", candidates=None)
    scalar = []
    solve = WR.solve

    def counted(problem, solver, **kw):
        scalar.append(solver)
        return solve(problem, solver, **kw)

    monkeypatch.setattr(WR, "solve", counted)
    with cs.presolved_maps(WR) as (maps, _):
        results = SweepRunner(workers=0, device=CPU).run(
            specs + [lone, fleet])
    eligible = cs.presolve_eligible(T, specs + [lone, fleet])
    assert eligible == [s for s in specs if s.solver == BCD]
    assert cs._check_presolved(T, WR, specs + [lone, fleet], maps) == len(
        eligible)
    assert scalar.count(BCD) == 1  # the lone spec
    assert scalar.count("exact") == len(specs) - len(eligible)
    assert all(r.feasible for r in results)


def test_presolve_gate_sees_a_failing_batch_entry(monkeypatch):
    """A batch entry that raises falls back to the scalar loop, which hides
    it from the results; the presolve gate does not let it pass."""
    info = T.get_solver(BCD)

    def broken(problems, **kw):
        raise RuntimeError("batch entry fault")

    monkeypatch.setitem(T.engine._REGISTRY, BCD,
                        dataclasses.replace(info, batch_fn=broken))
    specs = [s for s in SUITES["nsfnet_paper"](quick=True, modes=(IF,),
                                               schemes=(BCD,)) if s.K == 3]
    assert len({s.spec_hash() for s in specs}) >= T.engine.SOLVE_BATCH_MIN_BATCH
    with cs.presolved_maps(WR) as (maps, _):
        results = SweepRunner(workers=0, device=CPU).run(specs)
    assert all(r.feasible for r in results)
    with pytest.raises(AssertionError, match="solved one by one"):
        cs._check_presolved(T, WR, specs, maps)
