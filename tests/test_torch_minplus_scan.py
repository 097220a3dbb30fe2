"""The port's fused DFTS scan and its lockstep tour waves, held against the
JAX package on the CPU.

``repro_torch.kernels.minplus.minplus_scan`` runs the whole tour relaxation
of N tours in one launch of its CUDA kernel on CUDA tensors, and its plain
version ``minplus_scan_reference`` on CPU tensors.  Here the plain version
is held with ``==`` against the JAX package's jitted ``dfts_scan``, with the
Pallas product in interpret mode (``use_pallas=True``) and without it, in
float64, on the same numpy inputs from a seed.  The kernel itself is held
against the plain version on the card by ``tests/test_torch_cuda.py``.

``dfts_torch`` runs the tours of all the instances of a batch in lockstep
waves (``torch_solvers._run_tours``): each instance must run exactly the
tours it runs alone, with the same outcome as ``dfts_np``, in far fewer
scans.
"""
from __future__ import annotations

import jax
import jax.experimental
import numpy as np
import pytest
import torch

import chip_smoke as cs
import repro.core as R
import repro_torch.core as T
from repro.core import jax_solvers
from repro.sweep.spec import candidate_sets as ref_candidate_sets
from repro_torch.core import torch_solvers as ts
from repro_torch.kernels import minplus as mp

INF = np.inf
CPU = {"device": "cpu"}


@pytest.fixture
def jax_x64(monkeypatch):
    """The JAX package reaches ``jax.experimental.enable_x64``, which this
    JAX no longer has: alias it to ``jax.enable_x64`` for one test, then
    remove the alias and drop the reference's cached jitted scans, so that
    nothing of it reaches the reference's own tests in the same worker."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64,
                        raising=False)
    yield
    monkeypatch.undo()
    jax_solvers._jx.cache_clear()


def _rand(rng, shape, p_inf=0.2):
    """Cost-like values: non-negative floats with +inf holes."""
    x = rng.uniform(0.0, 10.0, size=shape)
    x[rng.uniform(size=shape) < p_inf] = INF
    return x


def _ties(rng, shape, p_inf=0.2):
    """Small integers, so that many sums tie."""
    x = rng.integers(0, 3, size=shape).astype(np.float64)
    x[rng.uniform(size=shape) < p_inf] = INF
    return x


def _operands(make, shape, seed):
    """(comp, D, tail) at (N, K, S), with an all-+inf first tour where
    N > 1."""
    N, K, S = shape
    rng = np.random.default_rng(seed)
    comp, D, tail = (make(rng, s) for s in ((N, K, S), (N, K - 1, S, S),
                                              (N, S)))
    if N > 1:
        comp[0] = INF
    return comp, D, tail


def _scan(comp, D, tail, **kw):
    return mp.minplus_scan(*(torch.from_numpy(x) for x in (comp, D, tail)),
                           **kw)


# (N, K, S): one step and none, S off a warp's tours and past a warp
_SHAPES = [(1, 1, 4), (1, 2, 4), (3, 5, 4), (8, 3, 8), (5, 4, 16), (2, 3, 33)]


@pytest.mark.parametrize("use_pallas", [True, False],
                         ids=["pallas", "plain"])
@pytest.mark.parametrize("make", [_rand, _ties], ids=["random", "ties"])
@pytest.mark.parametrize("shape", _SHAPES, ids=str)
def test_scan_matches_jax_dfts_scan(jax_x64, shape, make, use_pallas):
    """``minplus_scan_reference`` == the JAX package's ``dfts_scan`` in all
    three outputs and their shapes.  Types: the port's are float64, int64
    and int32 srcs (an empty int64 at K = 1), the Pallas scan's srcs int32
    too (its argmin int64 without the Pallas product)."""
    comp, D, tail = _operands(make, shape, seed=sum(shape))
    got = mp.minplus_scan_reference(
        *(torch.from_numpy(x) for x in (comp, D, tail)))
    J = jax_solvers._jx()
    with jax.enable_x64():
        want = J.dfts_scan(J.jnp.asarray(comp), J.jnp.asarray(D),
                           J.jnp.asarray(tail), use_pallas=use_pallas)
        want = [np.asarray(w) for w in want]
    N, K, S = shape
    assert [tuple(g.shape) for g in got] == [(N,), (N,), (K - 1, N, S)]
    assert [g.dtype for g in got] == [
        torch.float64, torch.int64, torch.int32 if K > 1 else torch.int64]
    assert want[0].dtype == np.float64 and want[1].dtype == np.int64
    if use_pallas and K > 1:
        assert want[2].dtype == np.int32
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)
    if N > 1:
        assert got[0][0] == INF and got[1][0] == 0


def test_scan_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    comp, D, tail = _operands(_ties, (6, 3, 8), seed=3)
    before = mp.scan_launch_count
    got = _scan(comp, D, tail)
    want = mp.minplus_scan_reference(
        *(torch.from_numpy(x) for x in (comp, D, tail)))
    out = (torch.empty(6, dtype=torch.float64),
           torch.empty(6, dtype=torch.int64),
           torch.empty((2, 6, 8), dtype=torch.int32))
    written = _scan(comp, D, tail, out=out)
    assert mp.scan_launch_count == before
    assert all(w is o for w, o in zip(written, out))
    for g, o, w in zip(got, out, want):
        assert torch.equal(g, w) and torch.equal(o, w)


def test_scan_rejects_what_it_does_not_take():
    z = torch.zeros
    f64 = torch.float64
    with pytest.raises(ValueError, match="comp must be"):
        mp.minplus_scan(z(2, 0, 4, dtype=f64), z(2, 0, 4, 4, dtype=f64),
                        z(2, 4, dtype=f64))
    with pytest.raises(ValueError, match="D must be"):
        mp.minplus_scan(z(2, 3, 4, dtype=f64), z(2, 3, 4, 4, dtype=f64),
                        z(2, 4, dtype=f64))
    with pytest.raises(ValueError, match="D must be"):
        mp.minplus_scan(z(2, 3, 4, dtype=f64), z(2, 2, 4, 4, dtype=f64),
                        z(3, 4, dtype=f64))
    with pytest.raises(ValueError, match="out must be"):
        mp.minplus_scan(z(2, 3, 4, dtype=f64), z(2, 2, 4, 4, dtype=f64),
                        z(2, 4, dtype=f64),
                        out=(z(2, dtype=f64), z(2, dtype=torch.int64),
                             z(2, 2, 4, dtype=torch.int64)))
    with pytest.raises(ValueError, match="cuda or cpu"):
        mp.minplus_scan(torch.empty(1, 2, 2, device="meta"),
                        torch.empty(1, 1, 2, 2, device="meta"),
                        torch.empty(1, 2, device="meta"))


def test_inf_padding_rows_absorb():
    """All-+inf tours appended to a batch (`_run_tours` pads N to a power
    of two) leave the real tours' outputs as they were."""
    comp, D, tail = _operands(_rand, (5, 4, 8), seed=9)
    got = _scan(comp, D, tail)
    pad = ((0, 3),) + ((0, 0),) * 2
    padded = _scan(np.pad(comp, pad, constant_values=INF),
                   np.pad(D, pad + ((0, 0),), constant_values=INF),
                   np.pad(tail, pad[:2], constant_values=INF))
    assert torch.equal(padded[0][:5], got[0])
    assert torch.equal(padded[1][:5], got[1])
    assert torch.equal(padded[2][:, :5], got[2])
    assert torch.all(torch.isinf(padded[0][5:])) and not padded[1][5:].any()


def test_run_dfts_scan_packs_one_copy_each_way():
    """The host side of a scan: the operands in one packed buffer, the
    outputs back in one, equal to the scan of the same tensors."""
    for shape in [(4, 3, 8), (2, 1, 4), (1, 5, 4)]:
        comp, D, tail = _operands(_ties, shape, seed=len(shape) + shape[1])
        got = ts._run_dfts_scan(comp, D, tail, torch.device("cpu"))
        want = _scan(comp, D, tail)
        assert [g.dtype for g in got] == [np.float64, np.int64,
                                          np.int32 if shape[1] > 1
                                          else np.int64]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w.numpy())


# ------------------------------------------------------ lockstep waves ---
@pytest.fixture
def counted(monkeypatch):
    """Counts of the scans (``minplus_scan`` calls) and of the tours built
    (``_tour_operands`` calls) in torch_solvers."""
    counts = {"scans": 0, "tours": 0}
    scan, build = ts.minplus_scan, ts._tour_operands

    def counting_scan(*args, **kw):
        counts["scans"] += 1
        return scan(*args, **kw)

    def counting_build(*args, **kw):
        counts["tours"] += 1
        return build(*args, **kw)

    monkeypatch.setattr(ts, "minplus_scan", counting_scan)
    monkeypatch.setattr(ts, "_tour_operands", counting_build)
    return counts


def _plain(out) -> tuple:
    return cs._plain(out)


def _lockstep_equals_alone_and_oracle(problems, counted) -> tuple[int, int]:
    """dfts_torch over the batch == each instance alone == dfts_np, and
    the batch builds exactly the tours the instances build alone.  Returns
    (scans of the batch, tours of the batch)."""
    alone, tours_alone = [], 0
    for p in problems:
        counted["tours"] = 0
        alone.append(T.solve(p, "dfts_torch", **CPU))
        tours_alone += counted["tours"]
    counted["scans"] = counted["tours"] = 0
    batch = T.solve_batch(problems, "dfts_torch", dedup=False, min_batch=1,
                          **CPU)
    scans, tours = counted["scans"], counted["tours"]
    assert tours == tours_alone
    for p, got, one in zip(problems, batch, alone):
        want = T.solve(p, "dfts_np", cache=T.EvalCache())
        assert _plain(got) == _plain(one) == _plain(want)
        assert got.status == one.status
    return scans, tours


def test_lockstep_over_the_32_tr_pipe_instances(counted):
    """The 32 TR-pipe instances of chip_smoke's population take 1, 2 or 6
    tours each, 80 in all, each once its own scan: in lockstep they take at
    most 6 waves of 2 (K, S) groups."""
    problems = [p for p in cs.build_population(T)
                if p.request.schedule == "pipe"]
    assert len(problems) == 32
    scans, tours = _lockstep_equals_alone_and_oracle(problems, counted)
    assert tours == 80
    assert scans <= 12


_PIPELINE_CELLS = [("IF", 32, 4), ("IF", 32, 16), ("TR", 128, 4),
                   ("TR", 128, 16)]


def _pair(mode, b, M, K=3, seed=0, per_stage=2):
    """The same pipelined instance built by each package: (ref, port)."""
    ref_net, ref_prof = R.nsfnet(source="v4"), R.resnet101_profile()
    ref = R.ProblemInstance(ref_net, ref_prof, R.ServiceChainRequest(
        ref_prof.model_id, "v4", "v13", batch_size=b, mode=mode,
        schedule="pipe", n_microbatches=M), K, ref_candidate_sets(
            K, seed, [f"v{i}" for i in range(1, 15)], "v4", "v13",
            per_stage=per_stage))
    prof = T.resnet101_profile()
    port = T.ProblemInstance(T.nsfnet(source=T.SOURCE), prof,
                             T.ServiceChainRequest(
                                 prof.model_id, T.SOURCE, T.DEST,
                                 batch_size=b, mode=mode, schedule="pipe",
                                 n_microbatches=M), K,
                             T.candidate_sets(K, seed, T.NSFNET_NODES,
                                              T.SOURCE, T.DEST,
                                              per_stage=per_stage))
    assert port.content_hash() == ref.content_hash()
    return ref, port


def test_lockstep_over_the_nsfnet_pipeline_quick_cells(counted):
    """The pipelined cells of the nsfnet_pipeline quick grid in one batch:
    == alone == the port's dfts_np == the JAX package's dfts_np."""
    pairs = [_pair(mode, b, M) for mode, b, M in _PIPELINE_CELLS]
    _lockstep_equals_alone_and_oracle([port for _, port in pairs], counted)
    batch = T.solve_batch([port for _, port in pairs], "dfts_torch",
                          dedup=False, min_batch=1, **CPU)
    for (ref, _), got in zip(pairs, batch):
        want = R.solve(ref, "dfts_np", cache=R.EvalCache())
        assert _plain(got) == _plain(want)


def test_lockstep_runs_the_min_memory_fallback_inside_a_generator(counted):
    """At b 1024, K 5 the even split fits nowhere and the min-memory split
    does: sequential and pipelined (IF and TR) instances take their
    fallback tours in later waves, beside instances that need none."""
    def problem(mode, schedule, M, b=1024, K=5, seed=0):
        cands = T.candidate_sets(K, seed, T.NSFNET_NODES, T.SOURCE, T.DEST,
                                 per_stage=4)
        req = T.ServiceChainRequest("resnet101", T.SOURCE, T.DEST,
                                    batch_size=b, mode=mode,
                                    schedule=schedule, n_microbatches=M)
        return T.ProblemInstance(T.nsfnet(source=T.SOURCE),
                                 T.resnet101_profile(), req, K, cands)

    problems = [problem("IF", "seq", 1), problem("TR", "pipe", 4),
                problem("IF", "pipe", 4, seed=1), problem("TR", "seq", 1),
                problem("IF", "seq", 1, b=8), problem("TR", "pipe", 4, b=8)]
    _lockstep_equals_alone_and_oracle(problems, counted)
    assert all(o.feasible for o in T.solve_batch(problems, "dfts_torch",
                                                 dedup=False, min_batch=1,
                                                 **CPU))


def test_batch_time_is_each_instance_share():
    problems = [p for p in cs.build_population(T)][60:68]
    out = T.solve_batch(problems, "dfts_torch", dedup=False, min_batch=1,
                        **CPU)
    assert len({o.wall_time_s for o in out}) == 1
    assert out[0].wall_time_s > 0.0
