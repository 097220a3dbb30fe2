"""The port's launchers on the CPU: ``repro_torch.launch.train`` in ``dp``
and ``msl-pp`` mode, a resumed run ``==`` a straight one, a resume from a
checkpoint the JAX package wrote, ``repro_torch.launch.serve``, each CLI's
exit 2 without a card, and ``python -m repro_torch.msl.pipeline_check``.
torch runs on one thread here (``test_torch_sweep.one_thread``)."""
from __future__ import annotations

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.ckpt import CheckpointManager, flatten_with_path
from repro_torch.launch import serve, train
from test_torch_sweep import one_thread  # noqa: F401  (a fixture)

REPO = Path(__file__).resolve().parents[1]
pytestmark = pytest.mark.usefixtures("one_thread")
SMALL = ["--arch", "qwen2-1.5b", "--batch", "4", "--seq", "32",
         "--device", "cpu"]


def _leaves(directory, step):
    got_step, tree = CheckpointManager(directory).restore(step)
    assert got_step == step
    return flatten_with_path(tree)


@pytest.mark.parametrize("mode", ["dp", "msl-pp"])
def test_train_runs_and_checkpoints(mode, tmp_path, capsys):
    assert train.main(SMALL + ["--mode", mode, "--steps", "3",
                               "--ckpt-every", "1",
                               "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "done: 3 steps; checkpoint at step 2" in out
    # steps 1 and 2 (the last twice: non-blocking, then the final one)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_0000000001", "step_0000000002"]
    leaves = dict(_leaves(tmp_path, 2))
    assert int(leaves[("opt", "step")]) == 3
    assert leaves[("params", "stack", "groups", 0, "attn", "wq")].shape[0] == 2
    loss = [float(line.split("loss=")[1].split()[0])
            for line in out.splitlines() if "loss=" in line]
    assert all(np.isfinite(loss))


def test_resume_equals_a_straight_run(tmp_path):
    """Six pipelined steps straight, against four then a resume to six:
    every leaf of the step-5 checkpoint ``==`` (the first five steps are
    the warm-up, so the schedule's total does not change them)."""
    common = SMALL + ["--mode", "msl-pp", "--ckpt-every", "3"]
    assert train.main(common + ["--steps", "6", "--ckpt-dir",
                                str(tmp_path / "a")]) == 0
    assert train.main(common + ["--steps", "4", "--ckpt-dir",
                                str(tmp_path / "b")]) == 0
    assert CheckpointManager(tmp_path / "b").latest_step() == 3
    assert train.main(common + ["--steps", "6", "--resume", "--ckpt-dir",
                                str(tmp_path / "b")]) == 0
    a, b = _leaves(tmp_path / "a", 5), _leaves(tmp_path / "b", 5)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (path, x), (_, y) in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), path
    assert int(dict(b)[("opt", "step")]) == 6


def test_resume_from_a_jax_checkpoint(tmp_path, capsys):
    """The JAX package's parameters and AdamW state, saved by its own
    ``CheckpointManager``, resume in the port's launcher: the step goes on
    from the saved one, and the untrained leaves come back unchanged."""
    import jax

    from repro import optim as jopt
    from repro.ckpt import CheckpointManager as JaxCheckpointManager
    from repro.configs import get_config
    from repro.models import transformer as JT

    # the launcher's --reduced is the JAX package's reduced config
    jcfg = get_config("qwen2-1.5b").reduced()
    assert jcfg.resolved_head_dim == 16
    jp = JT.init_params(jax.random.PRNGKey(3), jcfg)
    state = jopt.make_optimizer("adamw").init(jp)
    state["step"] = np.asarray(4, np.int32)
    JaxCheckpointManager(tmp_path).save(4, {"params": jp, "opt": state})
    assert train.main(SMALL + ["--steps", "6", "--resume", "--ckpt-every",
                               "0", "--ckpt-dir", str(tmp_path)]) == 0
    assert "[resume] from step 4" in capsys.readouterr().out
    leaves = dict(_leaves(tmp_path, 5))
    assert leaves[("opt", "step")].shape == () and int(
        leaves[("opt", "step")]) == 5
    moved = leaves[("params", "stack", "groups", 0, "attn", "wq")]
    start = np.asarray(jp["stack"]["groups"][0]["attn"]["wq"])
    assert moved.shape == start.shape and not np.array_equal(
        moved.numpy(), start)


def test_a_port_checkpoint_restores_into_the_jax_reduced_config(tmp_path):
    """The reverse: the port's launcher at ``--reduced`` writes a
    checkpoint that the JAX package's ``CheckpointManager`` restores into
    the JAX package's own ``cfg.reduced()`` tree, leaf for leaf the same
    paths, shapes and dtypes as its ``init_params`` and optimizer state,
    and the JAX model runs on it."""
    import jax
    import jax.numpy as jnp

    from repro import optim as jopt
    from repro.ckpt import CheckpointManager as JaxCheckpointManager
    from repro.configs import get_config
    from repro.models import transformer as JT
    from repro.models.layers import Ctx as JCtx

    assert train.main(SMALL + ["--steps", "2", "--ckpt-every", "0",
                               "--ckpt-dir", str(tmp_path)]) == 0
    jcfg = get_config("qwen2-1.5b").reduced()
    step, state = JaxCheckpointManager(tmp_path).restore()
    assert step == 1
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    want = {"params": jp, "opt": jopt.make_optimizer("adamw").init(jp)}

    def spec(tree):
        return [(jax.tree_util.keystr(path), np.shape(leaf),
                 np.asarray(leaf).dtype)
                for path, leaf in jax.tree_util.tree_leaves_with_path(tree)]

    assert spec(state) == spec(want)
    params = jax.tree.map(jnp.asarray, state["params"])
    pos = jnp.broadcast_to(jnp.arange(8), (1, 8))
    hidden, _, _ = JT.forward(params, jcfg, jnp.ones((1, 8), jnp.int32),
                              JCtx(mode="prefill", positions=pos))
    assert hidden.shape == (1, 8, jcfg.d_model)
    assert bool(jnp.isfinite(hidden).all())


def test_serve_generates(capsys):
    assert serve.main(["--arch", "qwen2-1.5b", "--requests", "3",
                       "--max-new", "4", "--device", "cpu"]) == 0
    assert "3 requests -> " in capsys.readouterr().out


def test_serve_names_moe_decode(capsys):
    """Named for the time it raised naming ROADMAP A17; now the serving
    launcher serves MoE configs, at ``--reduced``, as the JAX package's
    does."""
    assert serve.main(["--arch", "qwen3-moe-30b-a3b", "--device",
                       "cpu"]) == 0
    assert "8 requests -> " in capsys.readouterr().out


@pytest.mark.parametrize("main", [train.main, serve.main],
                         ids=["train", "serve"])
def test_cli_without_a_card_exits_2(main, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit) as e:
        main(["--arch", "qwen2-1.5b"])
    assert e.value.code == 2
    assert "--device cpu" in capsys.readouterr().err


def test_pipeline_check_module():
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(REPO / "src"), os.environ.get("PYTHONPATH", "")]))
    run = subprocess.run(
        [sys.executable, "-m", "repro_torch.msl.pipeline_check", "qwen3-14b",
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "pipeline-vs-sequential max_err=" in run.stdout
    assert run.stdout.rstrip().endswith("PIPELINE CHECK OK")
