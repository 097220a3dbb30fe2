"""Bit parity of the port's batched planner with the JAX package.

``repro_torch``'s ``dfts_torch`` / ``bcd_torch`` run here with
``device="cpu"`` (the min-plus product then takes its plain version) and are
held with ``==`` against the JAX package's NumPy oracles ``dfts_np`` / ``bcd``
and against ``dfts_jax`` / ``bcd_jax`` with the Pallas kernel in interpret
mode, on the grids of ``tests/test_jax_solvers.py``.  Instances are built
independently in each package from the same parameters; plans are objects of
two packages, so they are compared as plain tuples.  The batch-engine
properties (ragged padding, dedup, hash stability, memo keys, ``min_batch``
routing) are held on the port itself.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.experimental
import pytest

import repro.core as R
import repro_torch.core as T
from repro.sweep.spec import candidate_sets as ref_candidate_sets
from repro_torch.core import engine as engine_mod
from repro_torch.core import torch_solvers as ts

CPU = {"device": "cpu"}


@pytest.fixture
def jax_x64(monkeypatch):
    """The JAX package reaches ``jax.experimental.enable_x64``, which this
    JAX no longer has: alias it to ``jax.enable_x64`` for one test, then
    remove the alias and drop the reference's cached jitted scans, so that
    nothing of it reaches the reference's own tests in the same worker."""
    from repro.core import jax_solvers

    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)
    yield
    monkeypatch.undo()
    jax_solvers._jx.cache_clear()


_REF_NET = R.nsfnet(source="v4")
_REF_PROF = R.resnet101_profile()
_NET = T.nsfnet(source=T.SOURCE)
_PROF = T.resnet101_profile()


def _pair(mode="IF", K=3, b=2, seed=0, schedule="seq", M=1, per_stage=2):
    """The same instance built by each package: (reference, port)."""
    ref_cands = ref_candidate_sets(K, seed, [f"v{i}" for i in range(1, 15)],
                                   "v4", "v13", per_stage=per_stage)
    ref = R.ProblemInstance(
        _REF_NET, _REF_PROF,
        R.ServiceChainRequest(_REF_PROF.model_id, "v4", "v13", batch_size=b,
                              mode=mode, schedule=schedule, n_microbatches=M),
        K, ref_cands)
    cands = T.candidate_sets(K, seed, T.NSFNET_NODES, T.SOURCE, T.DEST,
                             per_stage=per_stage)
    port = T.ProblemInstance(
        _NET, _PROF,
        T.ServiceChainRequest(_PROF.model_id, T.SOURCE, T.DEST, batch_size=b,
                              mode=mode, schedule=schedule, n_microbatches=M),
        K, cands)
    assert port.content_hash() == ref.content_hash()
    return ref, port


def _problem(**kw):
    return _pair(**kw)[1]


def _plain(out) -> tuple:
    """An outcome of either package as plain values: feasibility, plan
    (segments, placement, paths, tail path) and breakdown fields."""
    if out.plan is None:
        return (out.feasible, None, None)
    p, lb = out.plan, out.latency
    plan = (tuple(tuple(s) for s in p.segments), tuple(p.placement),
            tuple(tuple(x) for x in p.paths), tuple(p.tail_path))
    return (out.feasible, plan, (lb.computation_s, lb.transmission_s,
                                 lb.propagation_s, lb.bubble_s))


def _check_cell(ref, port, bcd=True):
    want = _plain(R.solve(ref, "dfts_np", cache=R.EvalCache()))
    assert _plain(R.solve(ref, "dfts_jax", use_pallas=True)) == want
    assert _plain(T.solve(port, "dfts_np", cache=T.EvalCache())) == want
    assert _plain(T.solve(port, "dfts_torch", **CPU)) == want
    if bcd:
        want = _plain(R.solve(ref, "bcd", cache=R.EvalCache()))
        assert _plain(R.solve(ref, "bcd_jax", use_pallas=True)) == want
        assert _plain(T.solve(port, "bcd", cache=T.EvalCache())) == want
        assert _plain(T.solve(port, "bcd_torch", **CPU)) == want


# --------------------------------------------------- quick-tier parity grids
_PAPER_CELLS = [(mode, K, b, seed) for mode in ("IF", "TR") for K in (2, 3, 5)
                for b in (2, 128) for seed in range(3)]


@pytest.mark.parametrize("mode,K,b,seed", _PAPER_CELLS)
def test_parity_nsfnet_paper_quick(jax_x64, mode, K, b, seed):
    _check_cell(*_pair(mode=mode, K=K, b=b, seed=seed))


_PIPELINE_CELLS = [(mode, b, M) for mode, b in (("IF", 32), ("TR", 128))
                   for M in (1, 4, 16)]


@pytest.mark.parametrize("mode,b,M", _PIPELINE_CELLS)
def test_parity_nsfnet_pipeline_quick(jax_x64, mode, b, M):
    _check_cell(*_pair(mode=mode, K=3, b=b, seed=0, schedule="pipe", M=M))


# --------------------------------------------- padded batch == singleton loop
def _ragged() -> list[tuple]:
    """Mixed K / candidate-set size / mode / schedule, so both the S axis and
    the power-of-two batch axis are padded in one call."""
    return [
        _pair(mode="IF", K=2, b=2, seed=0),
        _pair(mode="TR", K=3, b=128, seed=1),
        _pair(mode="IF", K=5, b=8, seed=2, per_stage=4),
        _pair(mode="TR", K=3, b=32, seed=3, per_stage=6),
        _pair(mode="IF", K=3, b=32, seed=4, schedule="pipe", M=4),
        _pair(mode="IF", K=2, b=2, seed=5),
        _pair(mode="TR", K=5, b=128, seed=6, per_stage=4),
    ]


@pytest.mark.parametrize("solver,oracle", [("dfts_torch", "dfts_np"),
                                           ("bcd_torch", "bcd")])
def test_ragged_batch_equals_singleton_loop_and_oracle(solver, oracle):
    pairs = _ragged()
    problems = [port for _, port in pairs]
    batched = T.solve_batch(problems, solver, dedup=False, **CPU)
    singles = [T.solve(p, solver, **CPU) for p in problems]
    assert len(batched) == len(problems)
    for (ref, _), got, want in zip(pairs, batched, singles):
        assert _plain(got) == _plain(want)
        assert got.status == want.status
        assert _plain(got) == _plain(R.solve(ref, oracle))


def test_batch_dedup_shares_outcomes():
    a, b = _problem(seed=0), _problem(seed=0)  # equal content, new objects
    assert a.content_hash() == b.content_hash()
    out = T.solve_batch([a, b, _problem(seed=1)], "dfts_torch", **CPU)
    assert out[0] is out[1]
    assert out[0].plan == T.solve(a, "dfts_torch", **CPU).plan


def test_batch_empty_and_singleton():
    assert T.solve_batch([], "dfts_torch", **CPU) == []
    p = _problem(seed=0)
    outs = T.solve_batch([p], "dfts_torch", **CPU)
    assert len(outs) == 1 and outs[0].feasible
    assert outs[0].plan == T.solve(p, "dfts_torch", **CPU).plan


def test_hash_stable_results_across_padding():
    """Equal instances give bit-identical results wherever they land in a
    padded batch."""
    base, twin = _problem(mode="TR", K=3, b=128, seed=1), \
        _problem(mode="TR", K=3, b=128, seed=1)
    fillers = [_problem(mode="IF", K=2, b=2, seed=s) for s in range(4)]
    o1 = T.solve_batch([base] + fillers, "dfts_torch", dedup=False, **CPU)[0]
    o2 = T.solve_batch(fillers + [twin], "dfts_torch", dedup=False, **CPU)[-1]
    assert base.content_hash() == twin.content_hash()
    assert o1.plan == o2.plan and o1.latency == o2.latency


def test_memo_keys_distinguish_schedule_and_microbatches():
    """seq / pipe-M4 / pipe-M16 variants of one cell hash apart, and solving
    them interleaved over shared memos gives what each gives cold."""
    variants = [_problem(mode="IF", K=3, b=32, seed=0),
                _problem(mode="IF", K=3, b=32, seed=0, schedule="pipe", M=4),
                _problem(mode="IF", K=3, b=32, seed=0, schedule="pipe", M=16)]
    assert len({p.content_hash() for p in variants}) == len(variants)
    memos = (ts._ENCODE_MEMO, ts._GRID_MEMO, ts._SHIP_MEMO, ts._PATH_MEMO,
             ts._PATHCOST_MEMO, ts._NODEVEC_MEMO, ts._PROFILE_MEMO,
             ts._PLAN_MEMO)
    cold = []
    for p in variants:
        for memo in memos:
            memo.clear()
        cold.append(T.solve(p, "dfts_torch", **CPU))
    for _ in range(2):
        for p, ref in zip(variants, cold):
            got = T.solve(p, "dfts_torch", **CPU)
            assert got.plan == ref.plan and got.latency == ref.latency


def test_memos_hold_no_tensors():
    T.solve_batch([_problem(seed=s) for s in range(4)], "bcd_torch", **CPU)
    import torch

    for memo in (ts._ENCODE_MEMO, ts._PLAN_MEMO):
        for key, val in memo.items():
            for x in (*key, *(vars(val).values() if hasattr(val, "__dict__")
                              else val)):
                assert not isinstance(x, torch.Tensor)


def test_min_batch_threshold_routes_tiny_batches_to_scalar_loop():
    """Below ``min_batch`` unique instances solve_batch takes the scalar
    loop; either side of the threshold the outcomes are identical."""
    problems = [_problem(seed=0), _problem(seed=1)]
    calls = {"batch": 0}
    info = engine_mod.get_solver("dfts_torch")
    orig = info.batch_fn

    def counting_batch_fn(unique, *, cache=None, **kw):
        calls["batch"] += 1
        return orig(unique, cache=cache, **kw)

    engine_mod._REGISTRY["dfts_torch"] = dataclasses.replace(
        info, batch_fn=counting_batch_fn)
    try:
        assert engine_mod.SOLVE_BATCH_MIN_BATCH == 4
        via_loop = T.solve_batch(problems, "dfts_torch", dedup=False, **CPU)
        assert calls["batch"] == 0
        via_kernel = T.solve_batch(problems, "dfts_torch", dedup=False,
                                   min_batch=1, **CPU)
        assert calls["batch"] == 1
        T.solve_batch(problems * 3, "dfts_torch", dedup=False, min_batch=100,
                      **CPU)
        assert calls["batch"] == 1
    finally:
        engine_mod._REGISTRY["dfts_torch"] = info
    for a, b in zip(via_loop, via_kernel):
        assert _plain(a) == _plain(b) and a.status == b.status


# ----------------------------------------------------- engine / registry
def test_registered_with_capabilities():
    names = T.solver_names()
    for required in ("dfts_np", "bcd", "comp-ms", "comm-ms", "dfts_torch",
                     "bcd_torch", "portfolio"):
        assert required in names
    for name in ("dfts_torch", "bcd_torch"):
        caps = engine_mod.get_solver(name).capabilities()
        assert caps["batched"] is True
        assert set(caps["schedules"]) == {"seq", "pipe"}
    assert engine_mod.get_solver("dfts_np").capabilities()["batched"] is False


def test_comparison_schemes_match_reference():
    ref, port = _pair(mode="TR", K=3, b=128, seed=2)
    for name in ("comp-ms", "comm-ms"):
        assert _plain(T.solve(port, name)) == _plain(R.solve(ref, name))


# ------------------------------------------------------ carrying state over
@pytest.mark.parametrize("kw", [dict(mode="IF", K=3, b=2, seed=0),
                                dict(mode="TR", K=5, b=128, seed=1,
                                     per_stage=4),
                                dict(mode="TR", K=3, b=128, seed=0,
                                     schedule="pipe", M=4),
                                dict(mode="IF", K=3, b=1, seed=0,
                                     schedule="pipe", M=4)])
def test_from_content_key_carries_the_instance(kw):
    """An instance rebuilt from the reference's content key hashes equal and
    solves to the reference's plan."""
    ref, _ = _pair(**kw)
    port = T.ProblemInstance.from_content_key(ref.content_key())
    assert port.content_key() == ref.content_key()
    assert port.content_hash() == ref.content_hash()
    assert _plain(T.solve(port, "dfts_torch", **CPU)) == \
        _plain(R.solve(ref, "dfts_np"))
