"""The encoder-decoder and vision families on the CPU against the JAX
package: whisper-small (an encoder of non-causal ``attn`` blocks over the
audio frames, a decoder of ``dec_block``s) and llama-3.2-vision-90b
(``attn`` x 4 then ``xattn`` over the patch embeddings), both reduced.

The JAX parameters are drawn by ``repro.models.transformer.init_params``,
made numpy, and carried over with ``convert.params_from_jax``; both
packages then run on the same numpy tokens and memory.  Every cross block
scales its output by ``tanh(xgate)``, and ``xgate`` is zero at init in both
families (``src/repro/models/layers.py:120``), so seeded weights take out
every cross-attention output, and the encoder's gradients are exactly 0:
they cannot show a broken cross path.  So every comparison runs with the
numpy ``xgate`` set to XGATE in both packages' parameters, and once more at
the seeded zero.

Tolerances, those of ``tests/test_torch_models.py``, ``test_torch_train.py``,
``test_torch_serving.py`` and ``test_torch_optim.py``: in float32 the
forward, ``encode_memory``, the loss, the served logits and every cache
leaf within 1e-5 of the JAX package's largest magnitude, each gradient
leaf within 1e-4 of its largest magnitude (a leaf stored in bf16, as
llama-vision's are, within one bf16 ulp of it); in bf16 5e-2, the bound of a
stack of blocks; one AdamW step (whisper's optimizer) and one Adafactor
step (llama-vision's) within 1e-6 on the stacked leaves, the encoder's
grouped as the JAX package stacks it.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.configs import ARCHS as JAX_ARCHS
from repro.models import transformer as JT
from repro.models.layers import Ctx as JCtx
from repro.serving import engine as JE
from repro.train import steps as jsteps
from repro_torch import optim, serving, train
from repro_torch.configs import ARCHS
from repro_torch.data import BatchSpec, SyntheticLM, shard_batch
from repro_torch.launch import serve as serve_launcher
from repro_torch.launch import train as train_launcher
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.msl import ChainSimulator, plan_pipeline

ARCHES = ["whisper-small", "llama-3.2-vision-90b"]
XGATE = 0.5  # the cross blocks' gate in the comparisons: tanh 0.46
GATES = [XGATE, 0.0]
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
LEAF_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
# a leaf stored in bf16 (llama-vision's weights) gets its gradient rounded
# to bf16 by both packages: one bf16 ulp apart (tests/test_torch_train.py)
BF16_LEAF_TOL = 2.0 ** -7
# bf16 gradients: the port's distance from the JAX package's float32 ones
# may be this many times the JAX package's own bf16 distance
BF16_WITNESS = 2.0
OPT_TOL = 1e-6
B, S = 2, 16
CACHE_LEN, STEPS = 32, 8


def _with_xgate(tree, value: float):
    """The numpy tree with every ``xgate`` leaf set to ``value``."""
    if isinstance(tree, dict):
        return {k: (np.full_like(v, value) if k == "xgate"
                    else _with_xgate(v, value)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_with_xgate(v, value) for v in tree]
    return tree


@functools.cache
def _models(arch: str, compute_dtype: str, xgate: float):
    jcfg = JAX_ARCHS[arch].reduced(compute_dtype=compute_dtype)
    cfg = ARCHS[arch].reduced(compute_dtype=compute_dtype)
    tree = _with_xgate(jax.tree.map(
        np.asarray, JT.init_params(jax.random.PRNGKey(0), jcfg)), xgate)
    return jcfg, cfg, jax.tree.map(jnp.asarray, tree), \
        convert.params_from_jax(tree, cfg, "cpu")


def _memory(cfg, seed=7) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.memory_len, cfg.d_model)).astype(np.float32)


def _tokens(cfg, seed=2) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


def _rel(got, want) -> float:
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    got = (got.detach().float().numpy() if torch.is_tensor(got)
           else np.asarray(got, np.float64))
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))


def _ctxs(mode="prefill"):
    pos = np.broadcast_to(np.arange(S), (B, S))
    return (JCtx(mode=mode, positions=jnp.asarray(pos, jnp.int32)),
            L.Ctx(mode=mode, positions=torch.from_numpy(pos.copy())))


def test_the_configs_attend_to_a_memory():
    """whisper's reduced config has an encoder of 2 layers over 8 frames,
    llama-vision's 10 layers with two ``xattn`` blocks over 8 patches; both
    at the JAX package's reduced head width of 16, which the card's flash
    kernels take."""
    whisper = ARCHS["whisper-small"].reduced()
    vision = ARCHS["llama-3.2-vision-90b"].reduced()
    assert (whisper.enc_layers, whisper.memory_len) == (2, 8)
    assert T.layer_kinds(vision.n_layers, vision.pattern).count("xattn") == 2
    assert not vision.enc_layers and vision.memory_len == 8
    for cfg in (whisper, vision):
        assert T.has_cross(cfg) and cfg.resolved_head_dim == 16
    assert not T.has_cross(ARCHS["qwen2-1.5b"])


@pytest.mark.parametrize("xgate", GATES)
@pytest.mark.parametrize("arch", ARCHES)
def test_encode_memory_matches_jax(arch, xgate):
    jcfg, cfg, jp, tp = _models(arch, "float32", xgate)
    mem = _memory(cfg)
    want = JT.encode_memory(jp, jcfg, jnp.asarray(mem))
    got = T.encode_memory(tp, cfg, torch.from_numpy(mem))
    assert got.shape == want.shape == (B, cfg.memory_len, cfg.d_model)
    assert _rel(got, want) < TOL["float32"]
    if not cfg.enc_layers:  # vision: the patch embeddings, cast
        assert torch.equal(got, torch.from_numpy(mem))


@pytest.mark.parametrize("xgate", GATES)
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHES)
def test_forward_with_memory_matches_jax(arch, compute_dtype, xgate):
    """``forward(memory=...)`` and the last position's logits; the memory
    moves the hidden state exactly where the gate is open."""
    jcfg, cfg, jp, tp = _models(arch, compute_dtype, xgate)
    toks, mem = _tokens(cfg), _memory(cfg)
    jctx, tctx = _ctxs()
    want, _, _ = JT.forward(jp, jcfg, jnp.asarray(toks, jnp.int32), jctx,
                            memory=jnp.asarray(mem))
    got, cache, aux = T.forward(tp, cfg, torch.from_numpy(toks), tctx,
                                memory=torch.from_numpy(mem))
    assert cache is None and float(aux) == 0.0
    assert got.dtype == getattr(torch, compute_dtype)
    assert _rel(got, want) < TOL[compute_dtype]
    assert _rel(T.logits_last(tp, cfg, got),
                JT.logits_last(jp, jcfg, want)) < TOL[compute_dtype]
    other, _, _ = T.forward(tp, cfg, torch.from_numpy(toks), tctx,
                            memory=torch.from_numpy(_memory(cfg, seed=8)))
    assert torch.equal(other, got) == (xgate == 0.0)


def _batch(cfg) -> dict:
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "targets": toks[:, 1:].astype(np.int32), "memory": _memory(cfg)}


@pytest.mark.parametrize("xgate", GATES)
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHES)
def test_loss_and_gradients_match_jax(arch, compute_dtype, xgate):
    """The loss on a batch with memory and the gradient of every leaf,
    ``xgate`` and the encoder's included (rematerialised, as the train
    step runs).  At the seeded zero gate the encoder's gradients are 0 in
    both packages, and the gates' are not.

    In bf16 the loss is held to the JAX package's bf16 loss, and the
    gradients to its float32 ones, each leaf within 5e-2 of its largest
    magnitude or within BF16_WITNESS times the JAX package's own bf16
    gradient's distance from them, whichever is larger.  The two packages'
    bf16 gradients each lie up to 4.5e-2 from the float32 ones on
    llama-vision's 10 reduced layers (the port's 3.3e-2 at most, the JAX
    package's 4.5e-2, in layer 3's query and key weights), so against each
    other they add up past the stack's 5e-2; and a gate's gradient, one
    sum over every token, cancels to the bf16 floor at the seeded zero
    (llama-vision's first gate: 2.5e-3 in float32, the port's bf16 3.3e-3,
    the JAX package's 0.85e-3)."""
    jcfg, cfg, jp, tp = _models(arch, compute_dtype, xgate)
    batch = _batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    grad_fn = jax.jit(jax.value_and_grad(jsteps.loss_fn, has_aux=True),
                      static_argnums=1)
    (jloss, _), jgrads = grad_fn(jp, jcfg, jbatch)
    own = None  # the JAX package's own gradients in this type
    if compute_dtype != "float32":
        own = T.tree_leaves(convert.params_from_jax(
            jax.tree.map(np.asarray, jgrads), cfg, "cpu"))
        jcfg32, _, jp32, _ = _models(arch, "float32", xgate)
        _, jgrads = grad_fn(jp32, jcfg32, jbatch)
    (loss, _), grads = train.value_and_grad(
        lambda p: train.loss_fn(p, cfg, shard_batch(batch, "cpu")), tp)
    assert abs(float(loss.detach()) - float(jloss)) <= TOL[
        compute_dtype] * abs(float(jloss))
    want = convert.params_from_jax(jax.tree.map(np.asarray, jgrads), cfg,
                                   "cpu")
    paths = T.tree_paths(grads)
    assert [p for p, _ in paths] == [p for p, _ in T.tree_paths(want)]
    by_path = dict(T.tree_paths(want))
    for i, ((path, g), w) in enumerate(zip(paths, T.tree_leaves(want))):
        assert g.shape == w.shape and torch.isfinite(g).all(), path
        err = float((g.double() - w.double()).abs().max())
        scale = float(w.double().abs().max())
        if path[-1] == "bk" and "xattn" in path:
            # a key bias shifts every score of a query alike, which the
            # softmax ignores: its gradient is 0 but for rounding, so it
            # is held to its block's value bias instead
            scale = float(by_path[path[:-1] + ("bv",)].double().abs().max())
            assert float(g.double().abs().max()) <= LEAF_TOL[
                compute_dtype] * scale, path
        tol = LEAF_TOL[compute_dtype]
        if w.dtype == torch.bfloat16:
            tol = max(tol, BF16_LEAF_TOL)
        limit = tol * max(scale, 1e-30)
        if own is not None:
            limit = max(limit, BF16_WITNESS * float(
                (own[i].double() - w.double()).abs().max()))
        assert err <= limit, path
    gates = [g for p, g in paths if p[-1] == "xgate"]
    assert gates and all(float(g.abs()) > 0 for g in gates)
    if cfg.enc_layers:
        enc = T.tree_leaves(grads["encoder"]) + [grads["enc_norm"]]
        assert all(bool((g == 0).all()) for g in enc) == (xgate == 0.0)


def _fed_tokens(cfg) -> np.ndarray:
    return np.random.default_rng(6).integers(0, cfg.vocab_size, (STEPS, B, 1))


def _assert_caches_match(got, want, tol: float) -> None:
    assert jax.tree.structure(got) == jax.tree.structure(want)
    paths = jax.tree_util.tree_leaves_with_path(want)
    for (path, w), g in zip(paths, jax.tree.leaves(got)):
        assert g.shape == w.shape, path
        if path[-1].key == "pos":
            np.testing.assert_array_equal(g, w)
        else:
            assert _rel(g, w) < tol, path


@pytest.mark.parametrize("xgate", GATES)
@pytest.mark.parametrize("arch", ARCHES)
def test_prefill_and_decode_match_jax(arch, xgate):
    """``prefill(memory=...)`` (the memory encoded once, ``enc_memory`` in
    the cache, the cross K/V projected into it with no ``pos``), then
    STEPS decode steps fed the same tokens: the logits and every cache
    leaf within 1e-5 in float32, after every step."""
    jcfg, cfg, jp, tp = _models(arch, "float32", xgate)
    toks, mem = _tokens(cfg), _memory(cfg)
    logits, jcache = JE.prefill(jp, jcfg, jnp.asarray(toks, jnp.int32),
                                CACHE_LEN, memory=jnp.asarray(mem))
    got, cache = serving.prefill(tp, cfg, torch.from_numpy(toks), CACHE_LEN,
                                 memory=torch.from_numpy(mem))
    assert set(cache) == {"stack", "enc_memory"}
    kinds = T.layer_kinds(cfg.n_layers, cfg.pattern)
    for kind, c in zip(kinds, cache["stack"]["layers"]):
        cross = {"xattn": c, "dec_block": c.get("cross")}.get(kind)
        if cross is not None:
            assert set(cross) == {"k", "v"}
            assert cross["k"].shape[1] == cfg.memory_len
    runs = [((got, convert.cache_to_jax_layout(cache, cfg)),
             (logits, jcache))]
    step = jax.jit(lambda p, c, t, q: JE.decode_step(p, jcfg, c, t, q))
    for i, fed in enumerate(_fed_tokens(cfg)):
        pos = np.full((B, 1), S + i)
        logits, jcache = step(jp, jcache, jnp.asarray(fed, jnp.int32),
                              jnp.asarray(pos, jnp.int32))
        got, cache = serving.decode_step(tp, cfg, cache,
                                         torch.from_numpy(fed),
                                         torch.from_numpy(pos))
        runs.append(((got, convert.cache_to_jax_layout(cache, cfg)),
                     (logits, jcache)))
    for (got, gcache), (want, wcache) in runs:
        assert _rel(got, want) < TOL["float32"]
        _assert_caches_match(gcache, jax.tree.map(np.asarray, wcache),
                             TOL["float32"])


@pytest.mark.parametrize("arch", ARCHES)
def test_decode_reuses_the_cross_cache(arch, monkeypatch):
    """A decode step takes the cross K/V the prefill projected: it never
    reads the memory (a different ``enc_memory`` gives the same logits)
    and runs no memory projection, only the one attention over the cached
    keys a cross block; and it equals the cache-free forward over the
    prompt and the fed tokens."""
    _, cfg, _, tp = _models(arch, "float32", XGATE)
    toks, mem = torch.from_numpy(_tokens(cfg)), torch.from_numpy(
        _memory(cfg))
    logits, cache = serving.prefill(tp, cfg, toks, CACHE_LEN, memory=mem)
    fed = torch.from_numpy(_fed_tokens(cfg)[0])
    pos = torch.full((B, 1), S)
    calls = []
    kv = L._cross_kv
    monkeypatch.setattr(L, "_cross_kv", lambda *a: calls.append(1) or kv(*a))
    step, _ = serving.decode_step(tp, cfg, dict(cache), fed, pos)
    assert not calls
    other, _ = serving.decode_step(tp, cfg, dict(
        cache, enc_memory=torch.zeros_like(cache["enc_memory"])), fed, pos)
    assert torch.equal(step, other)
    whole = torch.cat([toks, fed], dim=1)
    hidden, _, _ = T.forward(tp, cfg, whole, L.Ctx(
        mode="prefill", positions=torch.arange(S + 1).expand(B, S + 1)),
        memory=mem)
    assert _rel(step, T.logits_last(tp, cfg, hidden).numpy()) < TOL["float32"]


def _optimizer_inputs(arch):
    """The JAX parameters perturbed (no leaf all zeros, the gates open)
    and two steps of random gradients, numpy."""
    jcfg = JAX_ARCHS[arch].reduced()
    cfg = ARCHS[arch].reduced()
    rng = np.random.default_rng(4)
    jp = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
        a.shape).astype(a.dtype), JT.init_params(jax.random.PRNGKey(0),
                                                 jcfg))
    grads = [jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
        np.float32), jp) for _ in range(2)]
    return jcfg, cfg, jp, grads


@pytest.mark.parametrize("arch", ARCHES)
def test_optimizer_step_matches_jax(arch):
    """The config's own optimizer (whisper AdamW, llama-vision Adafactor)
    two steps from the same gradients, within 1e-6 on the stacked leaves:
    the encoder's layers grouped as the JAX package stacks them (AdamW
    decays its stacked vectors, Adafactor factors them), ``xgate``
    stacked to (repetitions,) and never decayed or factored."""
    jcfg, cfg, jp, grads = _optimizer_inputs(arch)
    name = cfg.optimizer
    assert name == {"whisper-small": "adamw",
                    "llama-3.2-vision-90b": "adafactor"}[arch]
    jo = jopt.make_optimizer(name, lr=3e-3, warmup=1, total=10)
    po = optim.make_optimizer(name, lr=3e-3, warmup=1, total=10)
    tp = convert.params_from_jax(jp, cfg, "cpu")
    js, ps = jo.init(jax.tree.map(jnp.asarray, jp)), po.init(tp, cfg)
    paths = [p for p, _ in T.tree_paths(tp)]
    stacked = {paths[idx[0]][0] for idx, s in ps["groups"] if s}
    assert stacked == ({"stack", "encoder"} if cfg.enc_layers else {"stack"})
    jparams = jax.tree.map(jnp.asarray, jp)
    update = jax.jit(jo.update)
    for g in grads:
        jparams, js = update(jax.tree.map(jnp.asarray, g), js, jparams)
        tp, ps = po.update(convert.params_from_jax(g, cfg, "cpu"), ps, tp)
    want = convert.params_from_jax(jax.tree.map(np.asarray, jparams), cfg,
                                   "cpu")
    for (path, g), w in zip(T.tree_paths(tp), T.tree_leaves(want)):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        err = float((g.double() - w.double()).abs().max())
        assert err <= OPT_TOL * max(float(w.double().abs().max()), 1e-30), \
            path
    back = convert.opt_state_to_jax_layout(ps, tp, cfg)
    assert jax.tree.structure(jax.tree.map(np.asarray, back)) == \
        jax.tree.structure(jax.tree.map(np.asarray, js))


@pytest.mark.parametrize("arch", ARCHES)
def test_params_from_jax_round_trips(arch):
    """``params_to_jax_layout`` gives back the JAX tree, leaf for leaf, the
    encoder's stack, ``enc_norm`` and the gates among them, and the port's
    own ``init_params`` builds the same tree as the converter."""
    _, cfg, jp, tp = _models(arch, "bfloat16", XGATE)
    back = convert.params_to_jax_layout(tp, cfg)
    want = jax.tree.map(np.asarray, jp)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    flat = jax.tree_util.tree_leaves_with_path(want)
    for (path, w), g in zip(flat, jax.tree.leaves(back)):
        assert tuple(g.shape) == w.shape, path
        np.testing.assert_array_equal(g.float().numpy(), w.astype(np.float32))
    own = T.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    assert T.tree_map(lambda t: (tuple(t.shape), t.dtype), own) == \
        T.tree_map(lambda t: (tuple(t.shape), t.dtype), tp)


@pytest.mark.parametrize("arch", ARCHES)
def test_the_reference_quirks_raise(arch):
    """What the JAX package cannot run either: ``ServingEngine.generate``
    and the serving launcher pass no memory, and ``ChainSimulator`` and the
    pipeline carry none (ROADMAP §C)."""
    _, cfg, _, tp = _models(arch, "float32", XGATE)
    engine = serving.ServingEngine(cfg, tp, B, CACHE_LEN, device="cpu")
    with pytest.raises(ValueError, match="memory"):
        engine.generate([np.array([1, 2, 3])], 2)
    with pytest.raises(ValueError, match="memory"):
        serve_launcher.main(["--arch", arch, "--device", "cpu"])
    pp = plan_pipeline(cfg, seq_len=S, microbatch=B, mode="IF",
                       candidate_K=(2,), n_groups_mesh=4, chips_per_group=8,
                       device="cpu")
    with pytest.raises(ValueError, match="memory"):
        ChainSimulator(cfg, tp, pp.problem.net, pp.problem.profile,
                       pp.problem.request)


def test_train_launcher_trains_whisper_reduced(tmp_path, capsys):
    """``launch.train --arch whisper-small --reduced`` in ``dp`` mode, as the
    JAX package's launcher does: SyntheticLM's memory of ``memory_len``
    frames reaches the encoder, the loss is finite and the checkpoint
    holds the encoder's stack."""
    assert train_launcher.main([
        "--arch", "whisper-small", "--batch", "2", "--seq", "16",
        "--steps", "2", "--ckpt-every", "0", "--ckpt-dir", str(tmp_path),
        "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    loss = [float(line.split("loss=")[1].split()[0])
            for line in out.splitlines() if "loss=" in line]
    assert loss and all(np.isfinite(loss))
    from repro_torch.ckpt import CheckpointManager, flatten_with_path
    _, tree = CheckpointManager(tmp_path).restore()
    paths = [p for p, _ in flatten_with_path(tree)]
    assert ("params", "encoder", "groups", 0, "attn", "wq") in paths
    assert ("params", "stack", "groups", 0, "xattn", "xgate") in paths


def test_train_steps_lower_the_loss_with_memory():
    """A few AdamW steps on SyntheticLM batches with memory lower the loss
    of reduced whisper-small, from the port's own seeded weights."""
    cfg = ARCHS["whisper-small"].reduced()
    stream = SyntheticLM(BatchSpec(2, 32, cfg.vocab_size, cfg.memory_len,
                                   cfg.d_model), seed=1)
    params = T.init_params(torch.Generator().manual_seed(1), cfg, "cpu")
    opt = optim.make_optimizer(cfg.optimizer, lr=3e-3, warmup=1, total=50)
    state = opt.init(params, cfg)
    step = train.make_train_step(cfg, opt)
    losses = []
    for i in range(8):
        params, state, m = step(params, state,
                                shard_batch(stream.batch_at(i % 2), "cpu"))
        assert torch.isfinite(m["loss"])
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses
