"""The port's serving control plane (``repro_torch.serve``) against the JAX
package's ``repro.serve``, record for record, and the port's serve CLI.

Each package builds the same fleet on its own NSFNET x ResNet-101 (source
v4, destination v13) from the same seeds, drives it through the same entry
class, and the outcomes are compared through ``chip_smoke.serve_view``:
every served record (request, decision, latency, plan, reason, status,
admit and depart times, migrations), the summary, the event timeline and
the gateway's per-tick counts, wall-clock fields, the engine's EvalCache
counters and the solver's name aside.  The port's solvers run with
``solver_kwargs={"device": "cpu"}``: its ``bcd`` and ``bcd_torch`` against
the JAX package's ``bcd``, its ``dfts_torch`` against ``dfts_np``.

The scenario schema: ``ScenarioSpec.spec_hash()``, the built topology and
profile and, for single-chain specs, the instance key are ``==`` across
the packages for every spec of the JAX package's suites, quick and full.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from dataclasses import asdict
from pathlib import Path

import pytest
import torch

import chip_smoke as cs
import repro.core as R
import repro.serve as RS
import repro_torch.core as T
import repro_torch.ft as TF
import repro_torch.serve as S
from repro.sweep import spec as ref_spec
from repro.sweep.suites import SUITES
from repro_torch.sweep import spec as port_spec

REPO = Path(__file__).resolve().parents[1]
PAIRS = [("bcd", "bcd"), ("bcd_torch", "bcd"), ("dfts_torch", "dfts_np")]
_REF = (R.nsfnet(source="v4"), R.resnet101_profile())
_PORT = (T.nsfnet(source=T.SOURCE), T.resnet101_profile())


def _kwargs(solver):
    return {"device": "cpu"} if solver.endswith("_torch") else None


def _fleets(**kw):
    """The same fleet of each package: (reference, port)."""
    args = dict(source="v4", destination="v13", batch_size=2, mode="IF",
                K=3, seed=0, model_id="resnet101")
    args.update(kw)
    ref = RS.generate_fleet(_REF[0], **args)
    port = S.generate_fleet(_PORT[0], **args)
    assert ([S.ServedRequest(r, False).to_dict() for r in port]
            == [RS.ServedRequest(r, False).to_dict() for r in ref])
    return ref, port


def _failures(fleet, pkg, net, hold_s, seed):
    horizon = max(r.arrival_s for r in fleet) + hold_s
    return pkg.generate_failures(net, rate_per_s=0.2, horizon_s=horizon,
                                 seed=seed, mean_downtime_s=2 * hold_s,
                                 protect=("v4", "v13"))


def _run(pkg, drive):
    """``drive()``'s outcome and the solver outcomes the serve package
    ``pkg`` got on the way (``chip_smoke.stack_solves``)."""
    with cs.stack_solves(pkg) as solves:
        return drive(), solves


def _check(got, want, got_ticks=(), want_ticks=()):
    (got, got_solves), (want, want_solves) = got, want
    assert (cs.serve_view(got, got_ticks, got_solves)
            == cs.serve_view(want, want_ticks, want_solves))
    assert got.n_requests > 0 and got_solves
    return got, want


@pytest.mark.parametrize("solver,oracle", PAIRS)
@pytest.mark.parametrize("policy", S.POLICY_NAMES)
def test_admit_matches_the_reference(policy, solver, oracle):
    """A static round of 16 chains arriving together, K 5, a quarter of
    them TR, so that the fabric fills and later chains are blocked or,
    through ``bcd``, replanned."""
    ref, port = _fleets(n_requests=16, K=5, candidates_per_stage=4,
                        train_share=0.25)
    want = _run(RS, lambda: RS.ServePlanner(*_REF, solver=oracle).admit(
        ref, policy=policy))
    got = _run(S, lambda: S.ServePlanner(
        *_PORT, solver=solver, solver_kwargs=_kwargs(solver)).admit(
            port, policy=policy))
    got, want = _check(got, want)
    assert want.n_accepted < want.n_requests
    assert want.n_replanned > 0 or oracle == "dfts_np"
    assert S.replay_verify(*_PORT, got.served)


@pytest.mark.parametrize("solver,oracle", PAIRS)
@pytest.mark.parametrize("failures", [False, True], ids=["churn", "failures"])
def test_sim_matches_the_reference(failures, solver, oracle):
    """``ServeSim`` on a Poisson fleet of 16 with exponential holds and the
    retry queue; with failures, the ``nsfnet_failures`` quick tier's cell
    (holds of mean 6 s, failures at 0.2/s recovering after 12 s) at seed 2,
    the first whose failures hit chains of both oracles."""
    hold, seed = (6.0, 2) if failures else (4.0, 0)
    ref, port = _fleets(n_requests=16, arrival="poisson", hold_model="exp",
                        hold_time_s=hold, seed=seed)
    ref_f = _failures(ref, RS, _REF[0], hold, seed) if failures else None
    port_f = _failures(port, S, _PORT[0], hold, seed) if failures else None
    if failures:
        assert [asdict(e) for e in port_f] == [asdict(e) for e in ref_f]
    want = _run(RS, lambda: RS.ServeSim(*_REF, solver=oracle, retry=True).run(
        ref, failures=ref_f))
    got = _run(S, lambda: S.ServeSim(
        *_PORT, solver=solver, retry=True,
        solver_kwargs=_kwargs(solver)).run(port, failures=port_f))
    got, want = _check(got, want)
    if failures:
        assert want.failure_summary()["n_restored"] > 0
    assert S.replay_verify_sim(*_PORT, got.served, port_f)


@pytest.mark.parametrize("solver,oracle", PAIRS)
@pytest.mark.parametrize("window", [None, 0.0, 0.5],
                         ids=["single-tick", "window-0", "window-0.5"])
def test_gateway_matches_the_reference(window, solver, oracle):
    """``ServeGateway``: a Poisson fleet of 32 with exponential holds of
    mean 4 s and the retry queue, either submitted at once and admitted in
    one tick, or streamed at batch windows 0 and 0.5 s (the
    ``nsfnet_gateway`` quick tier)."""
    ref, port = _fleets(n_requests=32, arrival="poisson", hold_model="exp",
                        hold_time_s=4.0)
    config = dict(batch_window_s=window or 0.0, retry=True)
    want_gw = RS.ServeGateway(*_REF, solver=oracle,
                              config=RS.GatewayConfig(**config))
    got_gw = S.ServeGateway(*_PORT, solver=solver,
                            config=S.GatewayConfig(**config),
                            solver_kwargs=_kwargs(solver))

    def drive(gw, fleet):
        if window is not None:
            return gw.run_stream(fleet)
        gw.submit(fleet)
        gw.tick()
        return gw.drain()

    want = _run(RS, lambda: drive(want_gw, ref))
    got = _run(S, lambda: drive(got_gw, port))
    got, want = _check(got, want, got_gw.stats.ticks, want_gw.stats.ticks)
    assert got_gw.stats.n_ticks == (1 if window is None else
                                    want_gw.stats.n_ticks)
    assert S.replay_verify_sim(*_PORT, got.served)


@pytest.mark.parametrize("suite", sorted(SUITES))
def test_scenario_specs_build_the_reference_instances(suite):
    topologies, profiles, instances = {}, {}, {}
    for quick in (True, False):
        for spec in SUITES[suite](quick=quick):
            port = port_spec.ScenarioSpec.from_dict(spec.to_dict())
            assert port.spec_hash() == spec.spec_hash()
            topo = (spec.topology, json.dumps(spec.topology_kwargs),
                    json.dumps(spec.drop_nodes), json.dumps(spec.drop_links))
            if topo not in topologies:
                topologies[topo] = port.build_network().content_key()
                assert topologies[topo] == spec.build_network().content_key()
            prof = (spec.profile, json.dumps(spec.profile_kwargs))
            if prof not in profiles:
                profiles[prof] = port.build_profile().content_key()
                assert profiles[prof] == spec.build_profile().content_key()
            key = spec.group_key()
            if spec.n_requests == 1 and key not in instances:
                instances[key] = port.instance_key()
                assert instances[key] == spec.instance_key()
    assert ref_spec.SUITE_SCHEMA_VERSION == port_spec.SUITE_SCHEMA_VERSION


def _cli(*args, package="repro_torch"):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", f"{package}.serve", *args],
                          capture_output=True, text=True, env=env,
                          cwd=REPO, timeout=300)


def test_cli_prints_the_reference_json(tmp_path):
    """``--device cpu --n-requests 8`` with the default ``bcd_torch``: the
    same table and the same JSON as the JAX package's CLI with its default
    ``bcd``, wall time and solver name aside."""
    got = _cli("--device", "cpu", "--n-requests", "8", "--json",
               str(tmp_path / "port.json"))
    want = _cli("--n-requests", "8", "--json", str(tmp_path / "ref.json"),
                package="repro")
    assert (got.returncode, want.returncode) == (0, 0), got.stderr
    assert got.stdout == want.stdout
    port, ref = (json.loads((tmp_path / f"{n}.json").read_text())
                 for n in ("port", "ref"))
    assert (port["summary"]["solver"], ref["summary"]["solver"]) == (
        "bcd_torch", "bcd")
    assert cs._without(port, cs.STACK_UNCOMPARED) == cs._without(
        ref, cs.STACK_UNCOMPARED)


def test_cli_with_exact_admits_every_chain():
    got = _cli("--device", "cpu", "--n-requests", "8", "--solver", "exact")
    assert got.returncode == 0, got.stderr
    assert "(ratio 1.00)" in got.stderr


def test_cli_without_a_card_names_it_and_exits_nonzero():
    got = _cli("--n-requests", "8")
    assert got.returncode != 0
    assert "no CUDA device" in got.stderr and "--device cpu" in got.stderr
    assert got.stdout == ""


def _ft_controller(**kw):
    req = T.ServiceChainRequest("resnet101", "v4", "v13", 8, T.TR)
    ctl = TF.ElasticPlanController(*_PORT, req, 3,
                                   [["v4"], ["v7", "v11"], ["v13"]], **kw)
    return ctl._core.planner


ENTRIES = {
    "ServePlanner": lambda **kw: S.ServePlanner(*_PORT, **kw),
    "ServeSim": lambda **kw: S.ServeSim(*_PORT, **kw).planner,
    "ServeGateway": lambda **kw: S.ServeGateway(*_PORT, **kw).planner,
    "ElasticPlanController": _ft_controller,
}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_entry_classes_plan_on_the_card_unless_asked(entry):
    """Every entry class defaults to ``bcd_torch`` on the card: without one
    it raises the solvers' "no CUDA device" error and never falls back to
    the CPU; ``solver_kwargs={"device": "cpu"}`` is the only way there, and
    a host solver's kwargs get no device."""
    build = ENTRIES[entry]
    if torch.cuda.is_available():
        planner = build()
        assert planner.solver_kwargs["device"].type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build()
    planner = build(solver_kwargs={"device": "cpu"})
    assert planner.solver_name == "bcd_torch"
    assert planner.solver_kwargs == {"device": torch.device("cpu")}
    assert build(solver="bcd").solver_kwargs == {}
