"""The port's executed MSL round trip on the CPU against the JAX package's:
``ChainSimulator.round_trip`` on ``tests/test_torch_simulator.py``'s
instances (reduced models deepened to four pattern groups, a TR request on
a TPU-pod topology, the port's ``bcd_torch`` plan == the JAX package's
``bcd``), and the event replay ``executed_round_trip_s`` on NSFNET plans.

Both simulators run the same plan on the same weights and tokens: the
traces come in the order FW (chain order), BW (reverse chain order) in
both, their charges (``compute_s_predicted``, ``transfer_s_charged``,
``smashed_bytes``) are ``==``, and the destination's hidden state and the
gradient handed back to the source agree to 1e-5 of their largest
magnitude in float32 compute and to 5e-2 in bf16 (the bound of a stack of
blocks, ``tests/test_torch_models.py``), route-aware for MoE.  The replay
gives the JAX package's makespan exactly, and ``trainpipe``'s closed form
to 1e-9 relative, as ``tests/test_trainpipe.py`` holds the reference.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as C
from repro.msl.simulator import ChainSimulator as JaxChainSimulator
from repro.msl.simulator import executed_round_trip_s as jax_replay
from repro.models import transformer as JT
from repro.sweep.spec import candidate_sets as jax_candidate_sets
from repro.sweep.suites import DEST, NSFNET_NODES, SOURCE
from repro_torch.core.plan import PlanEvaluator
from repro_torch.core.trainpipe import evaluate_round_trip
from repro_torch.models import convert
from repro_torch.msl import ChainSimulator, executed_round_trip_s
from test_torch_models import recorded_routes, route_aware_err
from test_torch_simulator import (
    TOL,
    B,
    S,
    _configs,
    _instances,
    _plan,
)

# float32 for one model of each block family (attention, SSD, MoE, and
# RG-LRU with local attention); bf16, the card's type, for qwen2-1.5b and
# mamba2-370m.  (recurrentgemma-9b's bf16 backward through its 12
# reduced layers lay 7.9e-2 from the JAX package's, past the forward's
# 5e-2: bf16 rounding amplified by the backward; its float32 round trip
# agrees to 1e-5.  On the card its bf16 round trip and train step go
# through the RG-LRU backward kernel and are held to the CPU's plain
# versions instead: chip_smoke.py's path 4, tests/test_torch_cuda.py.)
CASES = [(a, "float32") for a in ("qwen2-1.5b", "mamba2-370m",
                                  "qwen3-moe-30b-a3b",
                                  "recurrentgemma-9b")] + [
    (a, "bfloat16") for a in ("qwen2-1.5b", "mamba2-370m")]


def _rel(got, want) -> float:
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("arch,compute_dtype", CASES)
def test_round_trip_matches_jax(arch, compute_dtype, monkeypatch):
    jcfg, cfg = _configs(arch, compute_dtype)
    ref_inst, inst = _instances(arch, jcfg, cfg)
    want_plan = R.solve(ref_inst, "bcd").plan
    got_plan = C.solve(inst, "bcd_torch", device="cpu").plan
    assert _plan(got_plan) == _plan(want_plan) and got_plan.K == 2
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    with recorded_routes(monkeypatch) as routes:
        want = JaxChainSimulator(jcfg, jp, ref_inst.net, ref_inst.profile,
                                 ref_inst.request).round_trip(
            want_plan, jnp.asarray(tokens, jnp.int32))
        got = ChainSimulator(cfg, tp, inst.net, inst.profile,
                             inst.request).round_trip(
            got_plan, torch.from_numpy(tokens))

    K = got_plan.K
    assert [(t.stage, t.direction) for t in got.traces] == \
        [(t.stage, t.direction) for t in want.traces] == \
        [(k, "FW") for k in range(K)] + [(k, "BW")
                                         for k in reversed(range(K))]
    for g, w in zip(got.traces, want.traces):
        assert (g.node, g.groups) == (w.node, w.groups)
        assert g.compute_s_predicted == w.compute_s_predicted
        assert g.transfer_s_charged == w.transfer_s_charged
        assert g.smashed_bytes == w.smashed_bytes
        assert g.compute_s_measured > 0
    for d in ("FW", "BW", None):
        assert got.charged_s(d) == want.charged_s(d)
    assert got.traces[0].transfer_s_charged > 0
    assert got.traces[-1].transfer_s_charged == 0.0  # nothing before stage 0

    tol = TOL[compute_dtype]
    assert got.hidden.shape == got.grad_in.shape == (B, S, cfg.d_model)
    assert got.grad_in.dtype == getattr(torch, compute_dtype)
    assert route_aware_err(got.hidden, want.hidden, routes, cfg,
                           compute_dtype) < tol
    assert torch.isfinite(got.grad_in).all()
    assert _rel(got.grad_in, want.grad_in) < tol


def _nsfnet(M, K, seed):
    """An NSFNET TR pipeline instance built in each package from the same
    numbers (``tests/test_trainpipe.py``'s ``_nsfnet_problem``)."""
    cands = tuple(map(tuple, C.candidate_sets(K, seed, C.NSFNET_NODES,
                                              C.SOURCE, C.DEST,
                                              per_stage=2)))
    assert cands == tuple(map(tuple, jax_candidate_sets(
        K, seed, NSFNET_NODES, SOURCE, DEST, per_stage=2)))
    out = []
    for pkg in (R, C):
        prof = pkg.resnet101_profile()
        req = pkg.ServiceChainRequest(prof.model_id, C.SOURCE, C.DEST, 128,
                                      pkg.TR, schedule=pkg.PIPE,
                                      n_microbatches=M)
        out.append(pkg.ProblemInstance(pkg.nsfnet(source=C.SOURCE), prof,
                                       req, K, cands))
    return out


@pytest.mark.parametrize("M,K,seed", [(2, 3, 0), (4, 3, 1), (7, 4, 2)])
def test_executed_round_trip_equals_jax(M, K, seed):
    ref_inst, inst = _nsfnet(M, K, seed)
    res = R.solve(ref_inst, "bcd")
    assert res.feasible
    p = res.plan
    plan = C.Plan(segments=[tuple(s) for s in p.segments],
                  placement=list(p.placement),
                  paths=[list(x) for x in p.paths],
                  tail_path=list(p.tail_path))
    jev = R.PlanEvaluator(ref_inst.net, ref_inst.profile, ref_inst.request)
    ev = PlanEvaluator(inst.net, inst.profile, inst.request)
    got = executed_round_trip_s(ev, plan, M)
    assert got == jax_replay(jev, p, M)
    assert got == pytest.approx(evaluate_round_trip(ev, plan, M).total_s,
                                rel=1e-9)
