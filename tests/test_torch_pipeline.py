"""The port's pipeline runtime on the CPU against the JAX package's own.

The reference's ``pipeline_forward`` and ``make_pipeline_train_step`` run
in subprocesses, one per model family, all started together, each with
``XLA_FLAGS=--xla_force_host_platform_device_count=3`` and a ``(K, 1)``
mesh of ``("stage", "data")`` axes built here with Auto axis types (on
JAX 0.9 ``jax.make_mesh`` makes them Explicit, and the reference's
reshape at ``pipeline.py:160`` then raises); each writes its outputs to an
``.npz``.  The port runs on the CPU in this process, on the same JAX
parameters carried over by ``convert.params_from_jax`` and the same numpy
batch.

A ``(K, 1)`` mesh is the port's single data replica: the reference takes
its aux loss out of the ``shard_map`` with no reduction over ``"data"``
(``pipeline.py:149``, ``:168``), so with more data shards its aux depends
on the data axis.

Cases: reduced qwen3-14b, mamba2-370m, qwen3-moe-30b-a3b and
recurrentgemma-9b deepened to 4-5 groups, K 2 and 3 with uneven segments
(a stage with fewer groups than ``Gmax``), M 1, 2 and 4.  In float32
compute the hidden state and the aux agree to 1e-5 and one AdamW step's
loss and nll to 1e-5, every updated parameter to 1e-4 (float32 sums in
other orders; ``_adamw`` says why its eps is 1e-3); in bf16 the hidden
state and the aux to 5e-2, the bound of a stack of blocks
(``tests/test_torch_models.py``).  The slot -> group map
and the validity mask are ``==`` the reference's.  A config with remainder
layers, which the reference never runs (ROADMAP §C), is held to the
port's own forward of each microbatch instead.
"""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
B, S = 4, 16
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
PARAM_TOL = {"float32": 1e-4}
DEVICES = 3  # host devices of a reference subprocess: the largest K


class Case(NamedTuple):
    arch: str
    n_layers: int
    segments: tuple
    n_micro: int
    compute_dtype: str
    train: bool

    @property
    def id(self) -> str:
        segs = "-".join(f"{lo}.{hi}" for lo, hi in self.segments)
        return (f"{self.arch}-L{self.n_layers}-{segs}-M{self.n_micro}-"
                f"{self.compute_dtype}")


CASES = [
    Case("qwen3-14b", 5, ((1, 1), (2, 4), (5, 5)), 4, "float32", True),
    Case("qwen3-14b", 5, ((1, 2), (3, 5)), 2, "bfloat16", False),
    Case("mamba2-370m", 4, ((1, 1), (2, 4)), 2, "float32", True),
    Case("mamba2-370m", 4, ((1, 2), (3, 3), (4, 4)), 4, "bfloat16", False),
    Case("qwen3-moe-30b-a3b", 4, ((1, 3), (4, 4)), 1, "float32", True),
    Case("qwen3-moe-30b-a3b", 4, ((1, 1), (2, 3), (4, 4)), 2, "bfloat16",
         False),
    Case("recurrentgemma-9b", 12, ((1, 2), (3, 3), (4, 4)), 2, "float32",
         True),
    Case("recurrentgemma-9b", 12, ((1, 3), (4, 4)), 4, "bfloat16", False),
]
CASE_IDS = [c.id for c in CASES]


def _cfg(ARCHS, case: Case):
    return ARCHS[case.arch].reduced(compute_dtype=case.compute_dtype,
                                    n_layers=case.n_layers)


def _plan(PipelinePlan, case: Case, **kw):
    K = len(case.segments)
    return PipelinePlan(K=K, segments=list(case.segments),
                        placement=[f"s{k}" for k in range(K)],
                        n_groups=case.segments[-1][1],
                        predicted_latency_s=0.0, breakdown={}, **kw)


def _batch(vocab: int) -> dict:
    rng = np.random.default_rng(0)
    return {k: rng.integers(0, vocab, (B, S)).astype(np.int32)
            for k in ("tokens", "targets")}


def _adamw(optim):
    """AdamW at lr 1e-3 from the first step, with eps 1e-3.  Its first
    update is lr * g / (|g| + eps): with the default eps of 1e-8 it is
    lr * sign(g) wherever |g| is well above 1e-8 and swings across the
    whole range where |g| is near it, so there the float32 rounding of two
    packages' gradients (which agree to about 1e-6 of each leaf's largest
    here) moved single parameters by a tenth of lr (2.7e-4 of a leaf's
    largest magnitude).  With eps 1e-3 the update is a smooth function of
    the gradient and still moves a parameter by up to lr."""
    return optim.adamw(optim.cosine_schedule(1e-3, 1, 10), eps=1e-3)


def _jax_params(case: Case):
    import jax

    from repro.configs import ARCHS as JAX_ARCHS
    from repro.models import transformer as JT

    jcfg = _cfg(JAX_ARCHS, case)
    return jcfg, JT.init_params(jax.random.PRNGKey(0), jcfg)


def _path_str(path) -> str:
    return "/".join(str(getattr(e, "key", getattr(e, "idx", e)))
                    for e in path)


def _reference(out: str, arch: str) -> None:
    """The JAX package's pipeline on every case of ``arch``, into ``out``
    (run in a subprocess with DEVICES host devices)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, Mesh

    from repro.msl.pipeline import make_pipeline_train_step, pipeline_forward
    from repro.msl.planner import PipelinePlan
    from repro import optim

    from repro.models import layers as JL
    from test_torch_models import jax_route

    routes: dict = {}  # stage -> its MoE layers' routings, in call order
    ffn = JL.moe_ffn

    def keep(stage, *arrays):
        routes.setdefault(int(stage), []).append(
            [np.array(a) for a in arrays])

    def recorded_ffn(p, cfg, x):
        jax.debug.callback(keep, jax.lax.axis_index("stage"),
                           *jax_route(p["router"], cfg, x))
        return ffn(p, cfg, x)

    JL.moe_ffn = recorded_ffn
    res = {}
    for case in CASES:
        if case.arch != arch:
            continue
        jcfg, jp = _jax_params(case)
        plan = _plan(PipelinePlan, case)
        mesh = Mesh(np.array(jax.devices()[:plan.K]).reshape(plan.K, 1),
                    ("stage", "data"), axis_types=(AxisType.Auto,) * 2)
        batch = {k: jnp.asarray(v) for k, v in _batch(jcfg.vocab_size).items()}
        routes.clear()
        hidden, aux = jax.jit(lambda p, b: pipeline_forward(
            p, b, jcfg, mesh, plan, case.n_micro))(jp, batch)
        res[f"{case.id}/hidden"] = np.asarray(hidden.astype(jnp.float32))
        res[f"{case.id}/aux"] = np.asarray(aux)
        jax.effects_barrier()
        for s_, calls in routes.items():
            for i, name in enumerate(("logits", "idx", "keep")):
                res[f"{case.id}/routes/{s_}/{name}"] = np.stack(
                    [c[i] for c in calls])
        if case.train:
            opt = _adamw(optim)
            step = jax.jit(make_pipeline_train_step(jcfg, mesh, plan,
                                                    case.n_micro, opt))
            p2, _, metrics = step(jp, opt.init(jp), batch)
            res[f"{case.id}/loss"] = np.asarray(metrics["loss"])
            res[f"{case.id}/nll"] = np.asarray(metrics["nll"])
            for path, leaf in jax.tree_util.tree_flatten_with_path(p2)[0]:
                res[f"{case.id}/params/{_path_str(path)}"] = np.asarray(
                    leaf.astype(jnp.float32))
    np.savez(out, **res)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every case's reference outputs: one subprocess per model family, all
    started together."""
    tmp = tmp_path_factory.mktemp("pipeline_ref")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={DEVICES}",
               PYTHONPATH=os.pathsep.join(
                   [str(REPO / "src"), str(REPO / "tests"),
                    os.environ.get("PYTHONPATH", "")]))
    procs = {arch: subprocess.Popen(
        [sys.executable, __file__, str(tmp / f"{i}.npz"), arch], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i, arch in enumerate(dict.fromkeys(c.arch for c in CASES))}
    out = {}
    for i, (arch, proc) in enumerate(procs.items()):
        log, _ = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"{arch}: {log}"
        out.update(np.load(tmp / f"{i}.npz"))
    return out


def _port(case: Case):
    from repro_torch.configs import ARCHS
    from repro_torch.models import convert

    _, jp = _jax_params(case)
    cfg = _cfg(ARCHS, case)
    import jax

    params = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return cfg, params


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_stack_for_pipeline_map_and_mask(case):
    """The slot -> group map and the validity mask ``==`` the reference's
    (its map read off a stack whose one leaf is the group index)."""
    import jax.numpy as jnp

    from repro.msl import pipeline as JP
    from repro.msl.planner import PipelinePlan as JPlan
    from repro_torch.configs import ARCHS
    from repro_torch.models import transformer as T
    from repro_torch.msl import PipelinePlan, stack_for_pipeline

    cfg = _cfg(ARCHS, case)
    R = case.segments[-1][1]
    groups, valid = JP.stack_for_pipeline(
        {"stack": {"groups": [{"i": jnp.arange(R)}]}}, cfg,
        _plan(JPlan, case))
    params = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    st = stack_for_pipeline(params, cfg, _plan(PipelinePlan, case))
    assert np.array_equal(st.index, np.asarray(groups[0]["i"]))
    assert np.array_equal(st.valid, np.asarray(valid))
    assert st.index.dtype == np.int32 and st.valid.dtype == bool
    layers = params["stack"]["layers"]
    for k, stage in enumerate(st.stages):
        assert len(stage) == case.segments[k][1] - case.segments[k][0] + 1
        for g, group in enumerate(stage):  # the parameters, not copies
            first = (case.segments[k][0] - 1 + g) * len(cfg.pattern)
            assert all(a is b for a, b in zip(group, layers[first:]))


def _by_microbatch(case: Case, calls: dict, slots: bool) -> list:
    """Routings recorded stage by stage (each stage's calls in order: its
    active ticks, then its group slots, then the MoE layers of a group) as
    one list per microbatch in chain order.  ``slots``: the stage ran all
    ``Gmax`` slots (the reference), whose invalid ones are dropped."""
    K, M = len(case.segments), case.n_micro
    n = [hi - lo + 1 for lo, hi in case.segments]
    per_group = len(calls[0]) // (M * (max(n) if slots else n[0]))
    out: list = [[] for _ in range(M)]
    for k in range(K):
        width = (max(n) if slots else n[k]) * per_group
        assert len(calls[k]) == M * width
        for j, call in enumerate(calls[k]):
            if j % width < n[k] * per_group:
                out[j // width].append(call)
    return out


def _route_aware(case: Case, cfg, hidden, want, port_calls, reference):
    """The relative error of the hidden state over the tokens that route
    alike at every MoE layer of their microbatch, as
    ``test_torch_models.route_aware_err`` holds a stack: in float32 every
    token must route alike; in bf16 every flip must be a near tie on the
    JAX side and half the tokens at least must agree."""
    from repro_torch.models import layers as L

    key = f"{case.id}/routes"
    ref_calls = {k: [tuple(torch.from_numpy(reference[f"{key}/{k}/{n}"][i])
                           for n in ("logits", "idx", "keep"))
                     for i in range(len(reference[f"{key}/{k}/idx"]))]
                 for k in range(len(case.segments))}
    agree = []
    for got, ref in zip(_by_microbatch(case, port_calls, False),
                        _by_microbatch(case, ref_calls, True)):
        ra = L.routing_agreement(got, ref)
        if case.compute_dtype == "float32":
            assert ra.flips == 0 and bool(ra.agree.all())
        assert ra.flips_are_near_ties(TOL[case.compute_dtype]), ra
        agree.append(ra.agree.numpy())
    agree = np.concatenate(agree)
    assert agree.sum() * 2 >= agree.size
    got = hidden.float().numpy().reshape(-1, cfg.d_model)[agree]
    return _rel(got, want.reshape(-1, cfg.d_model)[agree])


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_pipeline_forward_matches_the_reference(case, reference,
                                                monkeypatch):
    """The hidden state and the aux loss; MoE route-aware."""
    from repro_torch.models import layers as L
    from repro_torch.msl import (
        PipelinePlan,
        make_pipeline_mesh,
        pipeline_forward,
    )
    from repro_torch.msl import pipeline as P

    cfg, params = _port(case)
    batch = {k: torch.from_numpy(v).long()
             for k, v in _batch(cfg.vocab_size).items()}
    calls: dict = {}
    stage = [0]
    route, apply = L.moe_route, P._stage_apply

    def recorded_route(router, cfg_, toks):
        r = route(router, cfg_, toks)
        calls.setdefault(stage[0], []).append((r.logits, r.idx, r.keep))
        return r

    def staged(stage_, first, *args):
        stage[0] = next(k for k, (lo, _) in enumerate(case.segments)
                        if lo - 1 == first)
        return apply(stage_, first, *args)

    monkeypatch.setattr(L, "moe_route", recorded_route)
    monkeypatch.setattr(P, "_stage_apply", staged)
    with torch.no_grad():
        hidden, aux = pipeline_forward(
            params, batch, cfg, make_pipeline_mesh(len(case.segments),
                                                   device="cpu"),
            _plan(PipelinePlan, case), case.n_micro)
    tol = TOL[case.compute_dtype]
    assert hidden.shape == (B, S, cfg.d_model)
    want_h = reference[f"{case.id}/hidden"]
    err = (_route_aware(case, cfg, hidden, want_h, calls, reference)
           if cfg.n_experts else _rel(hidden.float(), want_h))
    assert err <= tol
    want = float(reference[f"{case.id}/aux"])
    assert abs(float(aux) - want) <= tol * max(abs(want), 1.0)
    if cfg.n_experts:
        assert want > 0.0


@pytest.mark.parametrize("case", [c for c in CASES if c.train],
                         ids=[c.id for c in CASES if c.train])
def test_pipeline_train_step_matches_the_reference(case, reference):
    """One AdamW step through the pipeline: the loss and nll, and every
    updated parameter (in the JAX layout, each leaf against its largest
    magnitude)."""
    from repro_torch.ckpt import flatten_with_path
    from repro_torch.models import convert
    from repro_torch.msl import (
        PipelinePlan,
        make_pipeline_mesh,
        make_pipeline_train_step,
    )
    from repro_torch import optim

    cfg, params = _port(case)
    batch = {k: torch.from_numpy(v).long()
             for k, v in _batch(cfg.vocab_size).items()}
    opt = _adamw(optim)
    step = make_pipeline_train_step(
        cfg, make_pipeline_mesh(len(case.segments), device="cpu"),
        _plan(PipelinePlan, case), case.n_micro, opt)
    params, state, metrics = step(params, opt.init(params, cfg), batch)
    assert state["step"] == 1
    for k in ("loss", "nll"):
        want = float(reference[f"{case.id}/{k}"])
        assert abs(float(metrics[k]) - want) <= TOL["float32"] * abs(want)
    got = flatten_with_path(convert.params_to_jax_layout(params, cfg))
    prefix = f"{case.id}/params/"
    names = [k[len(prefix):] for k in reference if k.startswith(prefix)]
    assert sorted("/".join(map(str, p)) for p, _ in got) == sorted(names)
    for path, leaf in got:
        want = reference[prefix + "/".join(map(str, path))]
        assert _rel(leaf.float(), want) <= PARAM_TOL["float32"], path


@pytest.mark.parametrize("arch, n_layers, segments", [
    ("recurrentgemma-9b", 14, ((1, 2), (3, 4), (5, 5))),
    ("qwen3-14b", 5, ((1, 4), (5, 5))),
])
@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_pipeline_runs_the_remainder_layers(arch, n_layers, segments,
                                            n_micro):
    """Where the depth is not whole repetitions (recurrentgemma-9b at 14
    layers: four repetitions of three and two remainder layers, the fifth
    group), every microbatch's pipelined hidden state ``==`` the port's
    forward of that microbatch's rows, and the aux ``==`` their aux summed
    over M + K - 1."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import transformer as T
    from repro_torch.models.layers import Ctx
    from repro_torch.msl import (
        PipelinePlan,
        make_pipeline_mesh,
        pipeline_forward,
    )

    case = Case(arch, n_layers, segments, n_micro, "float32", False)
    cfg = _cfg(ARCHS, case)
    params = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.from_numpy(_batch(cfg.vocab_size)["tokens"]).long()
    K = len(segments)
    with torch.no_grad():
        hidden, aux = pipeline_forward(
            params, {"tokens": toks}, cfg, make_pipeline_mesh(K, device="cpu"),
            _plan(PipelinePlan, case), n_micro)
        mb = B // n_micro
        total = torch.zeros(())
        for m in range(n_micro):
            rows = slice(m * mb, (m + 1) * mb)
            h, _, a = T.forward(params, cfg, toks[rows], Ctx(
                mode="train", positions=torch.arange(S).expand(mb, S)))
            assert torch.equal(hidden[rows], h)
            total = total + a
    assert torch.equal(aux, total / (n_micro + K - 1))


def test_a_plan_that_leaves_out_layers_raises():
    from repro_torch.configs import ARCHS
    from repro_torch.models import transformer as T
    from repro_torch.msl import PipelinePlan, stack_for_pipeline

    cfg = ARCHS["recurrentgemma-9b"].reduced(n_layers=14)
    params = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    # the reference's count of groups, the full repetitions alone
    plan = PipelinePlan(K=2, segments=[(1, 2), (3, 4)], placement=["a", "b"],
                        n_groups=4, predicted_latency_s=0.0, breakdown={})
    with pytest.raises(ValueError, match="4 groups, the config 5"):
        stack_for_pipeline(params, cfg, plan)


def test_mesh_runs_on_the_card_and_has_no_data_axis():
    """Without a process group the mesh is this process's: its stages on
    the card unless the caller asks for the CPU, and no data axis: one
    raises, naming how to start a group of one process a (stage, replica)
    (``tests/test_torch_pipeline_dist.py`` runs such groups)."""
    from repro_torch.msl import PipelineMesh, make_pipeline_mesh

    with pytest.raises(RuntimeError, match="process group of 4 ranks"):
        make_pipeline_mesh(2, 2, device="cpu")
    mesh = make_pipeline_mesh(3, device="cpu")
    assert isinstance(mesh, PipelineMesh)
    assert mesh.stages == (torch.device("cpu"),) * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_pipeline_mesh(2)


if __name__ == "__main__":
    _reference(*sys.argv[1:])
