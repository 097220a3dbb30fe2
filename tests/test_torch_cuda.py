"""The port on the card: the CUDA min-plus kernel against its plain version,
and ``dfts_torch`` / ``bcd_torch`` on ``cuda`` against the NumPy oracles.

Every test here is marked ``cuda`` and skips without a card.  The file
imports nothing of JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import repro_torch.core as T
from repro_torch.kernels import minplus as mp
from repro_torch.kernels.minplus import minplus_matmul, minplus_reference

INF = np.inf
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """The card, or a skip: decided when the test runs, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _costs(rng, shape, ties=False, p_inf=0.2):
    x = (rng.integers(0, 3, size=shape).astype(np.float64) if ties
         else rng.uniform(0.0, 10.0, size=shape))
    x[rng.uniform(size=shape) < p_inf] = INF
    return x


def test_torch_argmin_is_first_occurrence_on_cuda(cuda):
    """Pin the tie rule the solvers rely on, on the card: the first minimum
    wins, and an all-+inf row gives index 0."""
    x = torch.tensor([[2.0, 1.0, 1.0, 3.0], [INF, INF, INF, INF],
                      [0.0, 0.0, 0.0, 0.0], [5.0, INF, 5.0, 4.0]],
                     dtype=torch.float64, device=cuda)
    assert x.argmin(dim=1).tolist() == [1, 0, 0, 3]
    assert x.min(dim=1).indices.tolist() == [1, 0, 0, 3]
    assert x.T.argmin(dim=0).tolist() == [1, 0, 0, 3]
    big = torch.zeros((1 << 20,), dtype=torch.float64, device=cuda)
    assert int(big.argmin()) == 0


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("shape", [((), 1, 1, 1), ((2, 3), 3, 17, 33),
                                   ((5,), 33, 16, 17), ((1,), 1, 4, 4),
                                   ((1,), 1, 8, 8), ((512,), 1, 4, 4),
                                   ((512,), 1, 8, 8), ((1024,), 1, 16, 16)])
def test_kernel_matches_plain(cuda, ties, shape):
    batch, m, k, n = shape
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(_costs(rng, batch + (m, k), ties)).to(cuda)
    b = torch.from_numpy(_costs(rng, batch + (k, n), ties)).to(cuda)
    if m > 1:
        a[..., 0, :] = INF  # an all-+inf row: each of its outputs takes idx 0
    before = mp.launch_count
    val, idx = minplus_matmul(a, b)
    torch.cuda.synchronize()
    assert mp.launch_count == before + 1
    rval, ridx = minplus_reference(a, b)
    assert torch.equal(val, rval) and torch.equal(idx, ridx)


def test_kernel_rejects_what_it_does_not_take(cuda):
    a = torch.zeros((4, 3, 2), dtype=torch.float64, device=cuda)
    b = torch.zeros((4, 2, 3), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        minplus_matmul(a[:, :, :1], b[:, :1, :])
    with pytest.raises(TypeError, match="float64"):
        minplus_matmul(a.float(), b.float())
    with pytest.raises(ValueError, match="devices"):
        minplus_matmul(a, b.cpu())


def _problem(mode, K, b, seed, schedule="seq", M=1, per_stage=2):
    cands = T.candidate_sets(K, seed, T.NSFNET_NODES, T.SOURCE, T.DEST,
                             per_stage=per_stage)
    req = T.ServiceChainRequest("resnet101", T.SOURCE, T.DEST, batch_size=b,
                                mode=mode, schedule=schedule,
                                n_microbatches=M)
    return T.ProblemInstance(T.nsfnet(source=T.SOURCE),
                             T.resnet101_profile(), req, K, cands)


def _plain(out) -> tuple:
    if out.plan is None:
        return (False,)
    p, lb = out.plan, out.latency
    return (True, tuple(map(tuple, p.segments)), tuple(p.placement),
            tuple(map(tuple, p.paths)), tuple(p.tail_path),
            (lb.computation_s, lb.transmission_s, lb.propagation_s,
             lb.bubble_s))


def test_solvers_on_cuda_match_numpy_oracles(cuda):
    problems = [_problem("IF", 3, 2, 0), _problem("TR", 5, 128, 1, per_stage=4),
                _problem("IF", 3, 32, 0, "pipe", 4),
                _problem("TR", 3, 128, 0, "pipe", 4, per_stage=6)]
    before = mp.launch_count
    dfts = T.solve_batch(problems, "dfts_torch", dedup=False, min_batch=1)
    bcd = T.solve_batch(problems, "bcd_torch", dedup=False, min_batch=1)
    assert mp.launch_count > before
    for p, got_d, got_b in zip(problems, dfts, bcd):
        assert _plain(got_d) == _plain(T.solve(p, "dfts_np"))
        assert _plain(got_b) == _plain(T.solve(p, "bcd"))
