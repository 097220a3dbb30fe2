"""The port's plan execution on the CPU against the JAX package: a port of
``tests/test_simulator.py`` for qwen3-14b, qwen2-1.5b, mamba2-370m,
qwen3-moe-30b-a3b, arctic-480b and recurrentgemma-9b, reduced and deepened
to four pattern groups.

Each package plans on its own objects built from the same parameters: the
group profiles are equal field by field, and the port's ``bcd_torch`` plan
(``device="cpu"``) equals the JAX package's ``bcd`` plan.  Then both
``ChainSimulator``s run that plan on the same weights (carried over with
``params_from_jax``) and tokens.  The charges of every stage
(``compute_s_predicted``, ``transfer_s_charged``, ``smashed_bytes``) are
``==``; the hidden states agree to 1e-5 of their largest magnitude in
float32 compute and to 5e-2 in bf16 (the bound of a stack of blocks in
``tests/test_torch_models.py``, which says why; route-aware for MoE, as
there).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro_torch.core as C
from repro.configs import ARCHS as JAX_ARCHS
from repro.models import transformer as JT
from repro.msl import group_profile as jax_group_profile
from repro.msl import plan_pipeline as jax_plan_pipeline
from repro.msl.simulator import ChainSimulator as JaxChainSimulator
from repro_torch.configs import ARCHS
from repro_torch.core.topology import tpu_pod_topology
from repro_torch.models import convert
from repro_torch.models import transformer as T
from repro_torch.msl import ChainSimulator, group_profile, plan_pipeline
from test_torch_models import recorded_routes, route_aware_err

ARCH_NAMES = ["qwen3-14b", "qwen2-1.5b", "mamba2-370m", "qwen3-moe-30b-a3b",
              "arctic-480b", "recurrentgemma-9b"]
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
B, S = 2, 16


def _configs(arch, compute_dtype="bfloat16"):
    n = 4 * len(ARCHS[arch].pattern)
    return (JAX_ARCHS[arch].reduced(n_layers=n, compute_dtype=compute_dtype),
            ARCHS[arch].reduced(n_layers=n, compute_dtype=compute_dtype))


def _rows(profile) -> list[tuple]:
    return [(r.name, r.flops_fw, r.flops_bw, r.act_bytes, r.grad_bytes,
             r.mem_bytes, r.disk_bytes) for r in profile.layers]


def _plan(plan) -> tuple:
    return (plan.K, tuple(map(tuple, plan.segments)), tuple(plan.placement),
            tuple(map(tuple, plan.paths)), tuple(plan.tail_path))


@pytest.mark.parametrize("mode", ["train", "prefill"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_group_profile_equals_jax(arch, mode):
    jcfg, cfg = _configs(arch)
    want = jax_group_profile(jcfg, seq_len=16, mode=mode)
    got = group_profile(cfg, seq_len=16, mode=mode)
    assert got.model_id == want.model_id and got.L == want.L == 4
    assert _rows(got) == _rows(want)
    full = group_profile(ARCHS[arch], seq_len=2048, mode=mode)
    assert _rows(full) == _rows(jax_group_profile(JAX_ARCHS[arch],
                                                  seq_len=2048, mode=mode))


def _instances(arch, jcfg, cfg):
    """The planning problem of test_simulator.py, built in each package."""
    out = []
    for pkg, c, gp, pod in ((R, jcfg, jax_group_profile, R.tpu_pod_topology),
                            (C, cfg, group_profile, tpu_pod_topology)):
        net = pod(n_groups=4, chips_per_group=8)
        nodes = sorted(net.nodes)
        prof = gp(c, seq_len=S, mode="train")
        req = pkg.ServiceChainRequest(arch, nodes[0], nodes[-1], B, pkg.TR)
        out.append(pkg.ProblemInstance(net, prof, req, 2,
                                       ((nodes[0],), (nodes[-1],))))
    return out


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_chain_execution_matches_jax(arch, compute_dtype, monkeypatch):
    jcfg, cfg = _configs(arch, compute_dtype)
    ref_inst, inst = _instances(arch, jcfg, cfg)
    want_plan = R.solve(ref_inst, "bcd")
    got_plan = C.solve(inst, "bcd_torch", device="cpu")
    assert want_plan.feasible and got_plan.feasible
    assert _plan(got_plan.plan) == _plan(want_plan.plan)
    assert got_plan.latency_s == want_plan.latency_s

    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    with recorded_routes(monkeypatch) as routes:
        want = JaxChainSimulator(jcfg, jp, ref_inst.net, ref_inst.profile,
                                 ref_inst.request).run_plan(
            want_plan.plan, jnp.asarray(tokens, jnp.int32))
        got = ChainSimulator(cfg, tp, inst.net, inst.profile,
                             inst.request).run_plan(got_plan.plan,
                                                    torch.from_numpy(tokens))

    assert len(got.traces) == len(want.traces) == got_plan.plan.K
    for g, w in zip(got.traces, want.traces):
        assert (g.stage, g.node, g.groups, g.direction) == \
            (w.stage, w.node, w.groups, w.direction)
        assert g.compute_s_predicted == w.compute_s_predicted
        assert g.transfer_s_charged == w.transfer_s_charged
        assert g.smashed_bytes == w.smashed_bytes
        assert g.compute_s_measured > 0
    assert got.total_charged_s == want.total_charged_s
    for t in got.traces[:-1]:
        assert t.transfer_s_charged > 0 and t.smashed_bytes > 0

    assert got.hidden.dtype == getattr(torch, compute_dtype)
    assert route_aware_err(got.hidden, want.hidden, routes, cfg,
                           compute_dtype) < TOL[compute_dtype]

    # the chain walks the same blocks in the same order as the whole stack
    pos = torch.arange(S).expand(B, S)
    mono, _, _ = T.apply_stack(tp["stack"], cfg, cfg.n_layers, cfg.pattern,
                               T.embed_tokens(tp, cfg,
                                              torch.from_numpy(tokens)),
                               T.Ctx(mode="prefill", positions=pos), None)
    assert torch.equal(got.hidden, mono)


@pytest.mark.parametrize("mode", ["TR", "IF"])
@pytest.mark.parametrize("arch,seq_len,microbatch", [
    ("qwen2-1.5b", 2048, 2), ("mamba2-370m", 2048, 2),
    ("qwen3-moe-30b-a3b", 2048, 2), ("recurrentgemma-9b", 4096, 1)])
def test_plan_pipeline_equals_jax(arch, seq_len, microbatch, mode):
    """The full-size models' pipeline plans: ``bcd_torch`` on the CPU
    against the JAX package's ``bcd``, at the path's sequence and batch."""
    kw = dict(seq_len=seq_len, microbatch=microbatch, mode=mode)
    want = jax_plan_pipeline(JAX_ARCHS[arch], solver="bcd", **kw)
    got = plan_pipeline(ARCHS[arch], device="cpu", **kw)
    assert (got.K, got.segments, got.placement, got.n_groups) == \
        (want.K, want.segments, want.placement, want.n_groups)
    assert got.predicted_latency_s == want.predicted_latency_s
    assert got.breakdown == want.breakdown
    assert got.plan.segments == got.segments
    plen = len(ARCHS[arch].pattern)
    assert got.problem.profile.L == -(-ARCHS[arch].n_layers // plen)


def test_stage_loop_refuses_remainder_layers():
    """A profile that does not group the config's layers (here 4 groups for
    1 whole repetition and 1 remainder layer) is refused."""
    cfg = ARCHS["qwen2-1.5b"].reduced(n_layers=3, pattern=("attn", "attn"))
    inst = _instances("qwen2-1.5b", *_configs("qwen2-1.5b"))[1]
    with pytest.raises(ValueError, match="remainder"):
        ChainSimulator(cfg, {}, inst.net, inst.profile, inst.request)


def test_stage_loop_runs_remainder_layers_as_a_last_group():
    """recurrentgemma-9b's 38 layers are 12 repetitions of its 3-block
    pattern and 2 remainder ``rglru`` layers, which ``group_profile`` plans
    as a 13th group.  Reduced to 3 repetitions and 2 remainder layers, the
    planned chain runs every layer once, in order: its hidden state ``==``
    the monolithic stack."""
    cfg = ARCHS["recurrentgemma-9b"].reduced(n_layers=11)
    pp = plan_pipeline(cfg, seq_len=S, microbatch=B, mode="IF",
                       candidate_K=(2, 3), n_groups_mesh=4,
                       chips_per_group=8, device="cpu")
    assert pp.n_groups == 4 and pp.segments[-1][1] == 4
    params = T.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S)))
    got = ChainSimulator(cfg, params, pp.problem.net, pp.problem.profile,
                         pp.problem.request).run_plan(pp.plan, tokens)
    pos = torch.arange(S).expand(B, S)
    mono, _, _ = T.apply_stack(params["stack"], cfg, cfg.n_layers,
                               cfg.pattern, T.embed_tokens(params, cfg,
                                                           tokens),
                               T.Ctx(mode="prefill", positions=pos), None)
    assert torch.equal(got.hidden, mono)


def test_plan_pipeline_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        plan_pipeline(ARCHS["mamba2-370m"], seq_len=2048, microbatch=2,
                      mode="IF")
