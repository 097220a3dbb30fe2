"""The port's suites against the JAX package's, one case per suite: the
single-chain suites here, the fleet suites in
``tests/test_torch_sweep_fleets.py`` (two files, so that the runner's
share of a test run spreads over two workers).

Each case runs the suite's quick tier three times: through the JAX
package's ``repro.sweep``; through ``repro_torch.sweep`` on the same
specs, its BCD scheme the host ``bcd`` as in the reference; and the
port's own suite, whose BCD scheme is ``bcd_torch``, on the CPU.  Both
port runs must give the reference's results, comparison report and CSV
rows (``chip_smoke.sweep_view``), wall clocks and what the report derives
from them aside (``SWEEP_WALL``).  The first, run with the reference's
host solvers in a fresh context as the reference is, must also give its
EvalCache counters.  The second must give the rest once ``bcd_torch`` and
its scenario ids are mapped to ``bcd``'s: ``bcd_torch`` takes no
EvalCache, and it runs in the context that the first run warmed
(``SWEEP_UNCOMPARED``).
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import pytest

import chip_smoke as cs
import repro.sweep as RS
import repro_torch.sweep as W
from repro.sweep import runner as RR
from repro_torch.sweep import runner as WR
from repro_torch.sweep import suites as WS
from test_torch_sweep import one_thread  # noqa: F401  (a fixture)

pytestmark = pytest.mark.usefixtures("one_thread")
SINGLE_CHAIN = ("nsfnet_paper", "exec_time_k", "random_scaling", "tpu_pod",
                "nsfnet_faults", "nsfnet_pipeline")
FLEETS = ("nsfnet_multirequest", "nsfnet_churn", "nsfnet_failures",
          "nsfnet_gateway", "nsfnet_mixed_training", "random_load_scaling")


def check_suite(name: str, tmp_path) -> list:
    """The three runs of ``name``'s quick tier, compared; the reference's
    results."""
    ref_specs = RS.SUITES[name](quick=True)
    same = [W.ScenarioSpec.from_dict(s.to_dict()) for s in ref_specs]
    own = WS.SUITES[name](quick=True)
    assert ([cs._renamed(s.to_dict(), {WS.BCD: "bcd"}) for s in own]
            == [cs._renamed(s.to_dict(), {}) for s in ref_specs])
    assert any(s.solver == WS.BCD for s in own)
    RR.clear_context()
    WR.clear_context()
    # the reference in a thread of its own: the packages share no state,
    # and HiGHS releases the GIL, so their MILPs overlap
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(RS.SweepRunner(workers=0).run, ref_specs)
        got = W.SweepRunner(workers=0, device="cpu").run(same)
        mine = W.SweepRunner(workers=0, device="cpu").run(own)
        want = ref.result()
    assert (cs.sweep_view(W, got, tmp_path / "port", uncompared=cs.SWEEP_WALL)
            == cs.sweep_view(RS, want, tmp_path / "reference",
                             uncompared=cs.SWEEP_WALL))
    assert (cs.sweep_view(W, mine, tmp_path / "own", cs.sweep_names(mine))
            == cs.sweep_view(RS, want, tmp_path / "reference"))
    assert all(r.error is None for r in want)
    return want


@pytest.mark.parametrize("name", SINGLE_CHAIN)
def test_single_chain_suite_matches_the_reference(name, tmp_path):
    want = check_suite(name, tmp_path)
    assert all(r.spec.n_requests == 1 for r in want)
    assert any(r.feasible for r in want)


def test_the_suites_are_split_between_the_two_files():
    assert sorted(SINGLE_CHAIN + FLEETS) == sorted(RS.SUITES) == sorted(
        WS.SUITES)
