"""The port's optimal solvers ``exact`` and ``ilp`` against the JAX
package's, ``==``: objective, plan and status.

Two grids, each instance built once by the JAX package and carried into the
port by its content key (``ProblemInstance.from_content_key``), or built by
each package from the same parameters (``test_torch_solvers._pair``):

* the random instances of ``tests/test_core_solvers.py`` (6 nodes, 6
  layers, K 3, IF or TR, seeds 0-7 for ``exact``, 0-5 for ``ilp``);
* the ``nsfnet_paper`` quick grid: NSFNET x ResNet-101, IF/TR, K 2/3/5,
  b 2/128, candidate seeds 0-2; ``ilp`` on K <= 3 only, as the JAX
  package's sweep runs it (each MILP takes up to a few seconds).

On every case the port's ``exact`` is also at most ``bcd_torch``'s
objective on the CPU, within the 1e-12 that the JAX package's own test
allows the two for summing the same terms in other orders.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import pytest

import repro.core as R
import repro_torch.core as T
from test_core_solvers import _random_instance
from test_torch_solvers import _pair, _plain


def _random_pair(seed):
    net, prof, req, K, cands = _random_instance(seed)
    ref = R.ProblemInstance(net, prof, req, K, cands)
    port = T.ProblemInstance.from_content_key(ref.content_key())
    assert port.content_hash() == ref.content_hash()
    return ref, port


def _same(ref, port, solver, **kw):
    # the two packages' solves side by side: HiGHS releases the GIL, which
    # halves the time of the MILPs
    with ThreadPoolExecutor(2) as pool:
        want = pool.submit(R.solve, ref, solver, **kw)
        got = pool.submit(T.solve, port, solver, **kw)
        want, got = want.result(), got.result()
    assert (got.objective, got.status) == (want.objective, want.status)
    assert _plain(got) == _plain(want)
    return got


def test_registered_with_the_reference_capabilities():
    names = T.solver_names()
    assert "exact" in names and "ilp" in names
    for name in ("exact", "ilp"):
        got, want = T.get_solver(name), R.get_solver(name)
        assert (got.schedules, got.optimal) == (want.schedules, want.optimal)


_PAPER = [(mode, K, b, seed) for mode in ("IF", "TR") for K in (2, 3, 5)
          for b in (2, 128) for seed in range(3)]
_CASES = ([("random", seed) for seed in range(8)]
          + [("nsfnet_paper", cell) for cell in _PAPER])


@pytest.mark.parametrize("grid,cell", _CASES, ids=str)
def test_exact_and_ilp_match_the_reference(grid, cell):
    if grid == "random":
        ref, port = _random_pair(cell)
        with_ilp = cell < 6
    else:
        mode, K, b, seed = cell
        ref, port = _pair(mode=mode, K=K, b=b, seed=seed)
        with_ilp = K <= 3
    got = _same(ref, port, "exact")
    assert got.status == ("optimal" if got.feasible else "infeasible")
    bcd = T.solve(port, "bcd_torch", device="cpu")
    assert bcd.feasible == got.feasible
    if got.feasible:
        assert got.objective <= bcd.objective + 1e-12
    if with_ilp:
        ilp = _same(ref, port, "ilp", time_limit_s=120)
        assert ilp.feasible == got.feasible
        if got.feasible:
            assert ilp.objective == pytest.approx(got.objective, rel=1e-6)


def test_ilp_refuses_pipelined_requests_like_the_reference():
    ref, port = _pair(mode="IF", K=3, b=32, seed=0, schedule="pipe", M=4)
    for solve, problem in ((R.solve, ref), (T.solve, port)):
        with pytest.raises(ValueError, match="models schedule"):
            solve(problem, "ilp")
