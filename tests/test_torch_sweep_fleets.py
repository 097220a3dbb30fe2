"""The port's fleet suites (``n_requests > 1``: static rounds, ``ServeSim``
churn and failures, the ``ServeGateway`` streams, mixed training) against
the JAX package's, one case per suite, as
``tests/test_torch_sweep_suites.py`` compares the single-chain ones."""
from __future__ import annotations

import pytest

from test_torch_sweep import one_thread  # noqa: F401  (a fixture)
from test_torch_sweep_suites import FLEETS, check_suite

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("name", FLEETS)
def test_fleet_suite_matches_the_reference(name, tmp_path):
    want = check_suite(name, tmp_path)
    assert all(r.spec.n_requests > 1 for r in want)
    assert any(r.n_accepted for r in want)
