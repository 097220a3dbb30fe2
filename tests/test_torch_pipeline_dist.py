"""The port's pipeline with stages in processes of their own and a data
axis (``msl.make_pipeline_mesh`` in a started group), on gloo ranks on the
CPU, against the JAX package's pipeline on its own ``(2, 2)`` mesh.

The reference's ``pipeline_forward`` and ``make_pipeline_train_step`` run
in one subprocess with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``
on a ``("stage", "data")`` mesh of 4 host devices with Auto axes, built as
``tests/test_torch_pipeline.py`` builds its ``(K, 1)`` (on JAX 0.9
``jax.make_mesh`` makes Explicit axes, and the reference's reshape at
``pipeline.py:160`` then raises).  The port's ranks are spawned from a
script written to ``tmp_path`` (``launch.ranks.spawn``: gloo over
localhost, a timeout on every collective and on the whole run, so a
deadlock fails a test instead of hanging the suite), on the same JAX
parameters carried over by ``convert.params_from_jax`` and the same numpy
batch; each rank writes what it holds to an ``.npz``.

Cases, each in float32 compute at B 8 x S 16, K 2 with two groups a stage:

* (a) reduced qwen2-1.5b (tied) and mamba2-370m (aux 0) on ``(2, 2)``,
  M 2: each last-stage rank's hidden rows, then the loss, the nll and
  every parameter after one AdamW step against the reference's, within
  ``tests/test_torch_pipeline.py``'s tolerances (1e-5; parameters 1e-4
  of each leaf's largest; its ``_adamw``); the replicas' copies ``==``;
* (b) ``(2, 1)`` in two processes ``==`` the one-process runtime (qwen2
  at M 2 and mamba2 at M 4): the same ops on the same rows in the same
  order, the embedding one lookup of the replica's rows, the tied table's
  two parts summed once either way (a + b, commutative), each layer's
  microbatch gradients added in one order (M 4 included), so equal bits;
* (c) reduced qwen3-moe-30b-a3b on ``(2, 2)``: the nll against the
  reference's, and the aux ``==`` the mean of each replica's ``(2, 1)``
  aux on its own rows (the reference takes no mean over ``"data"``:
  ROADMAP §C);
* (d) the ZeRO layout (``msl.pipeline.shard_stage``) ``==`` the whole
  layout on the same 4 ranks: one gather, a reduce-scatter of two
  addends, the same elementwise AdamW on each shard;
* (e) a tied config whose stage K - 1 contribution to the table is
  dropped (the mesh's pair group taken away) must miss the one-process
  runtime.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_pipeline as TP

REPO = Path(__file__).resolve().parents[1]
B, S = 8, 16
TOL, PARAM_TOL = TP.TOL["float32"], TP.PARAM_TOL["float32"]
DEVICES = 4
RUN_TIMEOUT_S = 300
COLLECTIVE_TIMEOUT_S = 120

# id: (arch, n_layers, K, n_data, M, layout, drop_tied)
CASES = {
    "qwen2": ("qwen2-1.5b", 4, 2, 2, 2, "whole", False),
    "qwen2-zero": ("qwen2-1.5b", 4, 2, 2, 2, "sharded", False),
    "mamba2": ("mamba2-370m", 4, 2, 2, 2, "whole", False),
    "moe": ("qwen3-moe-30b-a3b", 4, 2, 2, 2, "whole", False),
    "qwen2-k2": ("qwen2-1.5b", 4, 2, 1, 2, "whole", False),
    "mamba2-k2-m4": ("mamba2-370m", 4, 2, 1, 4, "whole", False),
    "qwen2-k2-untied": ("qwen2-1.5b", 4, 2, 1, 2, "whole", True),
}
REFERENCE_CASES = ("qwen2", "mamba2", "moe")


def _cfg(ARCHS, case_id: str):
    arch, n_layers = CASES[case_id][:2]
    return ARCHS[arch].reduced(compute_dtype="float32", n_layers=n_layers)


def _plan(PipelinePlan, cfg, K: int):
    R = -(-cfg.n_layers // len(cfg.pattern))
    segs = [(1, R // 2), (R // 2 + 1, R)] if K == 2 else [(1, R)]
    return PipelinePlan(K=K, segments=segs,
                        placement=[f"s{k}" for k in range(K)], n_groups=R,
                        predicted_latency_s=0.0, breakdown={})


def _batch(vocab: int) -> dict:
    rng = np.random.default_rng(0)
    return {k: rng.integers(0, vocab, (B, S)).astype(np.int32)
            for k in ("tokens", "targets")}


# ----------------------------------------------------------- the reference --
def _reference(out: str) -> None:
    """The JAX package's pipeline on the ``(2, 2)`` cases, into ``out``
    (run in a subprocess with DEVICES host devices)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, Mesh

    from repro import optim
    from repro.configs import ARCHS as JAX_ARCHS
    from repro.models import transformer as JT
    from repro.msl.pipeline import make_pipeline_train_step, pipeline_forward
    from repro.msl.planner import PipelinePlan

    res = {}
    for cid in REFERENCE_CASES:
        _, _, K, n_data, M = CASES[cid][:5]
        jcfg = _cfg(JAX_ARCHS, cid)
        jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
        plan = _plan(PipelinePlan, jcfg, K)
        mesh = Mesh(np.array(jax.devices()[:K * n_data]).reshape(K, n_data),
                    ("stage", "data"), axis_types=(AxisType.Auto,) * 2)
        batch = {k: jnp.asarray(v) for k, v in _batch(jcfg.vocab_size).items()}
        hidden, aux = jax.jit(lambda p, b: pipeline_forward(
            p, b, jcfg, mesh, plan, M))(jp, batch)
        res[f"{cid}/hidden"] = np.asarray(hidden)
        res[f"{cid}/aux"] = np.asarray(aux)
        opt = TP._adamw(optim)
        step = jax.jit(make_pipeline_train_step(jcfg, mesh, plan, M, opt))
        p2, _, metrics = step(jp, opt.init(jp), batch)
        res[f"{cid}/loss"] = np.asarray(metrics["loss"])
        res[f"{cid}/nll"] = np.asarray(metrics["nll"])
        for path, leaf in jax.tree_util.tree_flatten_with_path(p2)[0]:
            res[f"{cid}/params/{TP._path_str(path)}"] = np.asarray(leaf)
    np.savez(out, **res)


# ------------------------------------------------------------- the ranks --
RANKS = r"""
import dataclasses, json, sys
import numpy as np
import torch

sys.path.insert(0, sys.argv[4])
import test_torch_pipeline_dist as D


def run(rank, cases, tmp):
    from torch.distributed.tensor import DTensor
    from repro_torch import optim
    from repro_torch.configs import ARCHS
    from repro_torch.models import transformer as T
    from repro_torch.msl import (PipelinePlan, make_pipeline_mesh,
                                 make_pipeline_train_step, pipeline_forward)
    from repro_torch.msl import pipeline as P

    world = torch.distributed.get_world_size()
    for cid in cases:
        arch, n_layers, K, n_data, M, layout, drop = D.CASES[cid]
        cfg = D._cfg(ARCHS, cid)
        plan = D._plan(PipelinePlan, cfg, K)
        batch = {k: torch.from_numpy(v).long()
                 for k, v in D._batch(cfg.vocab_size).items()}
        params = torch.load(f"{tmp}/{cid}.pt")
        mesh = make_pipeline_mesh(K, n_data, device="cpu")
        if drop:  # stage K - 1's part of the tied table never reaches stage 0
            mesh = dataclasses.replace(mesh, tied_group=None)
        sp = P.stage_params(params, cfg, plan, mesh.stage)
        if layout == "sharded":
            sp = P.shard_stage(sp, mesh)
        res = {"stage": mesh.stage, "replica": mesh.replica,
               "route": mesh.route}
        with torch.no_grad():
            hidden, aux = pipeline_forward(sp, batch, cfg, mesh, plan, M)
        if hidden is not None:
            res["hidden"] = hidden.numpy()
            res["aux"] = aux.numpy()
            res["rows"] = P.replica_rows(D.B, M, n_data, mesh.replica).numpy()
        opt = D.TP._adamw(optim)
        state = opt.init(P.local_shards(sp), cfg)
        sp, state, metrics = make_pipeline_train_step(
            cfg, mesh, plan, M, opt)(sp, state, batch)
        res["loss"], res["nll"] = metrics["loss"].numpy(), metrics["nll"].numpy()
        res["step"] = state["step"]
        for path, leaf in T.tree_paths(sp):
            if isinstance(leaf, DTensor):
                res["sharded/" + "/".join(map(str, path))] = 1
                leaf = leaf.full_tensor()
            res["p/" + "/".join(map(str, path))] = leaf.detach().numpy()
        np.savez(f"{tmp}/{cid}.r{rank}.npz", **res)
    # a mesh whose size is not the group's raises
    try:
        make_pipeline_mesh(world + 1, 1, device="cpu")
        raise AssertionError("a mesh larger than the group was made")
    except ValueError as e:
        assert "ranks, the group has" in str(e), e


if __name__ == "__main__":
    from repro_torch.launch.ranks import spawn

    spawn(run, int(sys.argv[1]), (json.loads(sys.argv[2]), sys.argv[3]),
          timeout_s=float(sys.argv[5]), collective_timeout_s=float(sys.argv[6]))
"""


def _env() -> dict:
    return dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), str(REPO / "tests"),
         os.environ.get("PYTHONPATH", "")]))


def _save_params(tmp: Path) -> dict:
    """Each case's parameters: the JAX package's seed-0 draw carried over,
    saved for the ranks; returns them by case."""
    import jax

    from repro.configs import ARCHS as JAX_ARCHS
    from repro.models import transformer as JT
    from repro_torch.configs import ARCHS
    from repro_torch.models import convert

    out = {}
    for cid in CASES:
        jp = JT.init_params(jax.random.PRNGKey(0), _cfg(JAX_ARCHS, cid))
        out[cid] = convert.params_from_jax(jax.tree.map(np.asarray, jp),
                                           _cfg(ARCHS, cid), "cpu")
        torch.save(out[cid], tmp / f"{cid}.pt")
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's outputs and every rank's, all started together: the
    reference in one subprocess, the ``(2, 2)`` cases on 4 ranks and the
    ``(2, 1)`` cases on 2."""
    tmp = tmp_path_factory.mktemp("pipeline_dist")
    params = _save_params(tmp)
    script = tmp / "ranks.py"
    script.write_text(RANKS)
    env = _env()
    ref = subprocess.Popen(
        [sys.executable, __file__, str(tmp / "ref.npz")],
        env=dict(env, XLA_FLAGS=f"--xla_force_host_platform_device_count="
                 f"{DEVICES}"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    groups = {}
    for cid, case in CASES.items():
        groups.setdefault(case[2] * case[3], []).append(cid)
    procs = {world: subprocess.Popen(
        [sys.executable, str(script), str(world), json.dumps(cids), str(tmp),
         str(REPO / "tests"), str(RUN_TIMEOUT_S), str(COLLECTIVE_TIMEOUT_S)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for world, cids in groups.items()}
    logs = {}
    try:
        for world, proc in procs.items():
            logs[world], _ = proc.communicate(timeout=RUN_TIMEOUT_S + 60)
        ref_log, _ = ref.communicate(timeout=600)
    finally:
        for p in [ref, *procs.values()]:
            if p.poll() is None:
                p.kill()
    for world, proc in procs.items():
        assert proc.returncode == 0, f"{world} ranks: {logs[world][-4000:]}"
    assert ref.returncode == 0, ref_log[-4000:]
    ranks = {cid: [dict(np.load(tmp / f"{cid}.r{r}.npz"))
                   for r in range(CASES[cid][2] * CASES[cid][3])]
             for cid in CASES}
    return {"ref": dict(np.load(tmp / "ref.npz")), "ranks": ranks,
            "params": params}


def _one_process(cid: str, params, rows=None):
    """The one-process runtime on ``cid``'s (K, 1) mesh, from a copy of
    ``params``: (hidden, aux) of a forward and (params, metrics) after one
    AdamW step, on the batch or its ``rows``."""
    from repro_torch import optim
    from repro_torch.configs import ARCHS
    from repro_torch.models import transformer as T
    from repro_torch.msl import (
        PipelinePlan,
        make_pipeline_mesh,
        make_pipeline_train_step,
        pipeline_forward,
    )

    _, _, K, _, M = CASES[cid][:5]
    cfg = _cfg(ARCHS, cid)
    plan = _plan(PipelinePlan, cfg, K)
    batch = {k: torch.from_numpy(v).long()
             for k, v in _batch(cfg.vocab_size).items()}
    if rows is not None:
        batch = {k: v[torch.as_tensor(rows)] for k, v in batch.items()}
    params = T.tree_map(lambda t: t.clone(), params)
    mesh = make_pipeline_mesh(K, device="cpu")
    with torch.no_grad():
        hidden, aux = pipeline_forward(params, batch, cfg, mesh, plan, M)
    opt = TP._adamw(optim)
    params, _, metrics = make_pipeline_train_step(cfg, mesh, plan, M, opt)(
        params, opt.init(params, cfg), batch)
    return hidden, aux, params, metrics


def _assembled(cid: str, runs) -> dict:
    """{port path: leaf} after the step, from every rank; each leaf that
    several ranks hold (the replicas, the tied table's two stages) is
    ``==`` across them."""
    out: dict = {}
    for res in runs["ranks"][cid]:
        for k, v in res.items():
            if k.startswith("p/"):
                if k[2:] in out:
                    assert np.array_equal(out[k[2:]], v), (cid, k)
                out[k[2:]] = v
    return out


def _port_tree(cid: str, runs):
    """The port's whole parameter tree after the ranks' step."""
    from repro_torch.models import transformer as T

    got = _assembled(cid, runs)
    paths = [p for p, _ in T.tree_paths(runs["params"][cid])]
    assert sorted("/".join(map(str, p)) for p in paths) == sorted(got)
    it = iter(torch.from_numpy(got["/".join(map(str, p))]) for p in paths)
    return T.tree_map(lambda _: next(it), runs["params"][cid])


@pytest.mark.parametrize("cid", ["qwen2", "mamba2"])
def test_forward_on_two_by_two_ranks_matches_the_reference(cid, runs):
    """Each last-stage rank's rows of the hidden state (the reference's
    shard of every microbatch) and the aux (0 for these families)."""
    want = runs["ref"][f"{cid}/hidden"]
    seen = []
    for res in runs["ranks"][cid]:
        assert res["route"] == "gloo-cpu"
        if "hidden" in res:
            assert res["stage"] == 1
            assert TP._rel(res["hidden"], want[res["rows"]]) <= TOL
            assert float(res["aux"]) == float(runs["ref"][f"{cid}/aux"]) \
                == 0.0
            seen += res["rows"].tolist()
    assert sorted(seen) == list(range(B))


@pytest.mark.parametrize("cid", ["qwen2", "mamba2"])
def test_train_step_on_two_by_two_ranks_matches_the_reference(cid, runs):
    """One AdamW step: the loss and nll on every rank, and every parameter
    in the JAX layout against the reference's (each leaf to its largest
    magnitude)."""
    from repro_torch.ckpt import flatten_with_path
    from repro_torch.configs import ARCHS
    from repro_torch.models import convert

    for res in runs["ranks"][cid]:
        assert res["step"] == 1
        for k in ("loss", "nll"):
            want = float(runs["ref"][f"{cid}/{k}"])
            assert abs(float(res[k]) - want) <= TOL * abs(want)
    got = flatten_with_path(convert.params_to_jax_layout(
        _port_tree(cid, runs), _cfg(ARCHS, cid)))
    prefix = f"{cid}/params/"
    names = [k[len(prefix):] for k in runs["ref"] if k.startswith(prefix)]
    assert sorted("/".join(map(str, p)) for p, _ in got) == sorted(names)
    for path, leaf in got:
        want = runs["ref"][prefix + "/".join(map(str, path))]
        assert TP._rel(leaf.float(), want) <= PARAM_TOL, path


@pytest.mark.parametrize("cid", ["qwen2-k2", "mamba2-k2-m4"])
def test_two_processes_equal_the_one_process_runtime(cid, runs):
    """``(2, 1)`` in two processes: the hidden state, the aux, the loss,
    the nll and every parameter after the step ``==`` the one-process
    runtime's (the module docstring says why the bits agree)."""
    hidden, aux, params, metrics = _one_process(cid, runs["params"][cid])
    last = [r for r in runs["ranks"][cid] if "hidden" in r]
    assert len(last) == 1
    assert np.array_equal(last[0]["hidden"], hidden.numpy())
    assert float(last[0]["aux"]) == float(aux)
    for res in runs["ranks"][cid]:
        assert float(res["loss"]) == float(metrics["loss"])
        assert float(res["nll"]) == float(metrics["nll"])
    got = _assembled(cid, runs)
    from repro_torch.models import transformer as T

    for path, leaf in T.tree_paths(params):
        key = "/".join(map(str, path))
        assert np.array_equal(got[key], leaf.detach().numpy()), key


def test_moe_on_two_by_two_ranks(runs):
    """Reduced qwen3-moe: the nll against the reference's; the aux is the
    mean over the replicas of each one's ``(2, 1)`` aux on its own rows
    (``==``: the same ops on the same rows, a mean of two exact), where
    the reference leaves its ``shard_map`` with one replica's (ROADMAP
    §C), so its aux is not compared."""
    from repro_torch.msl import replica_rows

    ranks = runs["ranks"]["moe"]
    for res in ranks:
        want = float(runs["ref"]["moe/nll"])
        assert abs(float(res["nll"]) - want) <= TOL * abs(want)
    auxes = [_one_process("moe", runs["params"]["moe"],
                          replica_rows(B, 2, 2, d).numpy())[1].numpy()
             for d in range(2)]
    assert min(auxes) > 0.0
    for res in ranks:
        if "aux" in res:
            assert res["aux"] == (auxes[0] + auxes[1]) * np.float32(0.5)
    # one AdamW step moved every leaf, the replicas alike (_assembled)
    assert all(np.isfinite(v).all() for v in _assembled("moe", runs).values())


def test_zero_layout_equals_the_whole_layout(runs):
    """The stage's leaves split over its data submesh (DTensor
    ``Shard(dim)``: every leaf of reduced qwen2 has a dim 2 divides), the
    optimizer on the shards: the loss, the nll and every parameter ``==``
    the whole layout's on the same ranks."""
    whole, zero = runs["ranks"]["qwen2"], runs["ranks"]["qwen2-zero"]
    for a, b in zip(whole, zero):
        assert any(k.startswith("sharded/") for k in b)
        assert float(a["loss"]) == float(b["loss"])
        assert float(a["nll"]) == float(b["nll"])
    w, z = _assembled("qwen2", runs), _assembled("qwen2-zero", runs)
    assert sorted(w) == sorted(z)
    for k in w:
        assert np.array_equal(w[k], z[k]), k


def test_dropping_the_tied_tables_last_stage_part_fails(runs):
    """The check of (b) rejects a step that never sums stage K - 1's
    gradient of the tied table into stage 0's: stage 0's table misses the
    one-process runtime's, and the two copies part."""
    _, _, params, _ = _one_process("qwen2-k2-untied", runs["params"][
        "qwen2-k2-untied"])
    want = params["embed"].detach().numpy()
    tables = [r["p/embed"] for r in runs["ranks"]["qwen2-k2-untied"]]
    assert not any(np.array_equal(t, want) for t in tables)
    assert TP._rel(tables[0], want) > PARAM_TOL
    assert not np.array_equal(tables[0], tables[1])


LAUNCH = r"""
import sys
from repro_torch.launch.ranks import spawn


def run(rank, argv):
    from repro_torch.launch import train

    assert train.main(argv) == 0


if __name__ == "__main__":
    spawn(run, int(sys.argv[1]), (sys.argv[2:],), timeout_s=240.0,
          collective_timeout_s=120.0)
"""


def _launch(tmp_path, world: int, argv: list) -> str:
    script = tmp_path / "launch.py"
    script.write_text(LAUNCH)
    proc = subprocess.run([sys.executable, str(script), str(world), *argv],
                          env=dict(_env(), OMP_NUM_THREADS="1"),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return proc.stdout


def test_train_launcher_on_ranks(tmp_path):
    """``launch.train --mode msl-pp`` in a started group takes the
    reference's ``(2, W // 2)`` mesh: on 2 ranks, 4 steps, then a resume
    to 6 (each rank's stage and its moments out of the whole checkpoint;
    rank 0 writes the whole tree gathered from the stages), every leaf of
    the step-5 checkpoint ``==`` six one-process steps; on 4 ranks, ``(2,
    2)``, 4 steps with finite losses and a checkpoint of step 3."""
    from repro_torch.ckpt import CheckpointManager, flatten_with_path
    from repro_torch.launch import train

    small = ["--arch", "qwen2-1.5b", "--batch", "4", "--seq", "32",
             "--device", "cpu", "--mode", "msl-pp", "--ckpt-every", "3"]
    assert train.main(small + ["--steps", "6", "--ckpt-dir",
                               str(tmp_path / "one")]) == 0
    _launch(tmp_path, 2, small + ["--steps", "4", "--ckpt-dir",
                                  str(tmp_path / "two")])
    out = _launch(tmp_path, 2, small + ["--steps", "6", "--resume",
                                        "--ckpt-dir", str(tmp_path / "two")])
    assert out.count("[resume] from step 3") == 1  # rank 0 alone prints
    a = flatten_with_path(CheckpointManager(tmp_path / "one").restore(5)[1])
    b = flatten_with_path(CheckpointManager(tmp_path / "two").restore(5)[1])
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), path
    out = _launch(tmp_path, 4, small + ["--steps", "4", "--ckpt-dir",
                                        str(tmp_path / "four")])
    loss = [float(line.split("loss=")[1].split()[0])
            for line in out.splitlines() if "loss=" in line]
    assert len(loss) == 2 and all(np.isfinite(loss))
    step, tree = CheckpointManager(tmp_path / "four").restore(3)
    assert step == 3 and int(dict(flatten_with_path(tree))[
        ("opt", "step")]) == 4


def test_replica_rows_are_the_references_data_shards():
    """Replica d of microbatch m holds what the reference's ``P(None,
    "data")`` split of the (M, mb, S, D) reshape gives it."""
    from repro_torch.msl import replica_rows

    x = np.arange(12)
    for M, n_data in ((1, 2), (2, 2), (3, 2), (2, 3), (1, 4)):
        parts = np.split(x.reshape(M, -1), n_data, axis=1)
        for d in range(n_data):
            assert replica_rows(12, M, n_data, d).tolist() == \
                parts[d].reshape(-1).tolist()
    with pytest.raises(ValueError, match="microbatches over"):
        replica_rows(8, 2, 3, 0)


def test_stage_params_and_the_shard_rule():
    """A stage's leaves keep their layer indices (so ``stacked_groups``
    groups them as the whole tree's); the tied table on stages 0 and K - 1
    both; the shard dim is the reference's ``shard_of`` past its stacked
    layer dim."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import transformer as T
    from repro_torch.msl import PipelinePlan, stage_params
    from repro_torch.msl.pipeline import shard_dim
    from repro_torch.optim import stacked_groups

    cfg = ARCHS["qwen2-1.5b"].reduced(n_layers=6)
    params = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    plan = PipelinePlan(K=3, segments=[(1, 1), (2, 4), (5, 6)],
                        placement=["a", "b", "c"], n_groups=6,
                        predicted_latency_s=0.0, breakdown={})
    stages = [stage_params(params, cfg, plan, s) for s in range(3)]
    assert [sorted(st["stack"]["layers"]) for st in stages] == [
        [0], [1, 2, 3], [4, 5]]
    assert stages[0]["embed"] is params["embed"] is stages[2]["embed"]
    assert "embed" not in stages[1] and "final_norm" in stages[2]
    whole = {tuple(T.tree_paths(params)[i][0] for i in idx): st
             for idx, st in stacked_groups(params, cfg)}
    for sp in stages:
        paths = [p for p, _ in T.tree_paths(sp)]
        for idx, stacked in stacked_groups(sp, cfg):
            key = next(k for k in whole if paths[idx[0]] in k)
            assert whole[key] == stacked
    assert shard_dim((151936, 5120), 128) == 0
    assert shard_dim((7, 5120), 128) == 1
    assert shard_dim((5120,), 128) == 0
    assert shard_dim((7, 9), 2) is None
    assert shard_dim((64,), 2) == 0


def test_the_route_is_the_groups_and_never_another():
    """The route follows the group's backend and the device asked for:
    NCCL stays NCCL on any device (two ranks on one card then fail in
    NCCL itself, never falling to gloo), gloo on a card goes through host
    buffers, and any other backend raises."""
    from repro_torch.msl import pipeline as P

    cpu, card = torch.device("cpu"), torch.device("cuda")
    assert P._route("nccl", card) == P._route("nccl", cpu) == "nccl"
    assert P._route("gloo", card) == "gloo-card"
    assert P._route("gloo", cpu) == "gloo-cpu"
    assert P._route("fake", cpu) == "fake"
    with pytest.raises(ValueError, match="nccl, gloo or a fake group"):
        P._route("mpi", cpu)


def test_mesh_needs_a_group_for_a_data_axis():
    from repro_torch.msl import make_pipeline_mesh

    with pytest.raises(RuntimeError, match="init_process_group"):
        make_pipeline_mesh(2, 2, device="cpu")
    with pytest.raises(ValueError, match="a stage and a replica"):
        make_pipeline_mesh(0, device="cpu")


if __name__ == "__main__":
    _reference(*sys.argv[1:])
