"""The port's serving engine on the CPU against the JAX package's.

JAX parameters go through ``params_from_jax`` and JAX caches through
``cache_from_jax`` (``cache_to_jax_layout`` brings the port's back, leaf by
leaf).  Four reduced models (qwen2-1.5b, qwen3-14b with its qk-norm,
mamba2-370m, recurrentgemma-9b) serve a batch of two prompts of 12 and 32
tokens, left-padded to 32 (two SSD chunks of 16), into caches of 48 slots:
recurrentgemma's local-attention ring has min(48, window 32) = 32 slots, so
its decode steps wrap it.

In float32 compute the port's logits and every cache leaf lie within 1e-5
of the JAX package's largest magnitude (``pos`` ``==``), after the prefill
and after each of 8 decode steps fed the same tokens, and
``ServingEngine.generate`` gives JAX's tokens, token for token.  In bf16
the prefill and 4 decode steps lie within 5e-2, the bound of a bf16 stack
in ``tests/test_torch_models.py``.  The port is also held against itself:
its cached decode against its own cache-free forward over the same tokens.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import transformer as JT
from repro.serving import engine as JE
from repro_torch import serving as S
from repro_torch.configs import ARCHS
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

MODELS = ["qwen2-1.5b", "qwen3-14b", "mamba2-370m", "recurrentgemma-9b"]
TOL = {"float32": 1e-5, "bfloat16": 5e-2}
B, LENGTHS, CACHE_LEN = 2, (12, 32), 48
STEPS = {"float32": 8, "bfloat16": 4}


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / (np.abs(want).max() + 1e-6))


@functools.cache
def _models(arch: str, compute_dtype: str, **over):
    jcfg = JAX_ARCHS[arch].reduced(compute_dtype=compute_dtype, **over)
    cfg = ARCHS[arch].reduced(compute_dtype=compute_dtype, **over)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, cfg, jp, tp


def _prompts(cfg, seed=5) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, n) for n in LENGTHS]


def _fed_tokens(cfg, steps: int) -> np.ndarray:
    """The tokens both packages' decode steps are fed, (steps, B, 1)."""
    return np.random.default_rng(6).integers(0, cfg.vocab_size,
                                             (steps, B, 1))


@functools.cache
def _jax_run(arch: str, compute_dtype: str):
    """The JAX package's prefill of the padded prompts, then its decode
    steps: [(logits, cache)], numpy leaves."""
    jcfg, cfg, jp, _ = _models(arch, compute_dtype)
    toks = S.left_pad(_prompts(cfg), B)
    logits, cache = JE.prefill(jp, jcfg, jnp.asarray(toks, jnp.int32),
                               CACHE_LEN)
    runs = [(np.asarray(logits), jax.tree.map(np.asarray, cache))]
    step = jax.jit(lambda p, c, t, pos: JE.decode_step(p, jcfg, c, t, pos))
    for i, fed in enumerate(_fed_tokens(cfg, STEPS[compute_dtype])):
        pos = np.full((B, 1), toks.shape[1] + i, np.int32)
        logits, cache = step(jp, cache, jnp.asarray(fed, jnp.int32),
                             jnp.asarray(pos))
        runs.append((np.asarray(logits), jax.tree.map(np.asarray, cache)))
    return runs


def _port_run(arch: str, compute_dtype: str):
    """The port's prefill and decode steps on the same inputs, each cache
    in the JAX layout as it was after its step (the KV rings are written
    in place)."""
    _, cfg, _, tp = _models(arch, compute_dtype)
    toks = torch.from_numpy(S.left_pad(_prompts(cfg), B))
    logits, cache = S.prefill(tp, cfg, toks, CACHE_LEN)
    runs = [(logits, convert.cache_to_jax_layout(cache, cfg))]
    for i, fed in enumerate(_fed_tokens(cfg, STEPS[compute_dtype])):
        pos = torch.full((B, 1), toks.shape[1] + i)
        logits, cache = S.decode_step(tp, cfg, cache, torch.from_numpy(fed),
                                      pos)
        runs.append((logits, convert.cache_to_jax_layout(cache, cfg)))
    return runs


def _assert_caches_match(got, want, tol: float) -> None:
    """Leaf by leaf: the same tree, shapes and values (``pos`` ``==``)."""
    assert jax.tree.structure(got) == jax.tree.structure(want)
    paths = jax.tree_util.tree_leaves_with_path(want)
    for (path, w), g in zip(paths, jax.tree.leaves(got)):
        assert g.shape == w.shape, path
        if path[-1].key == "pos":
            assert g.dtype == np.int32
            np.testing.assert_array_equal(g, w)
        else:
            assert _rel(g, w.astype(np.float32)) < tol, path


@pytest.mark.parametrize("arch", MODELS)
def test_prefill_matches_jax(arch):
    logits, cache = _port_run(arch, "float32")[0]
    want_logits, want_cache = _jax_run(arch, "float32")[0]
    assert logits.shape == want_logits.shape
    assert logits.dtype == torch.float32
    assert _rel(logits, want_logits) < TOL["float32"]
    _assert_caches_match(cache, want_cache, TOL["float32"])


@pytest.mark.parametrize("arch", MODELS)
def test_decode_steps_match_jax(arch):
    got, want = _port_run(arch, "float32"), _jax_run(arch, "float32")
    assert len(got) == len(want) == 1 + STEPS["float32"]
    for (logits, cache), (want_logits, want_cache) in zip(got[1:], want[1:]):
        assert _rel(logits, want_logits) < TOL["float32"]
        _assert_caches_match(cache, want_cache, TOL["float32"])


def test_recurrentgemma_ring_wraps():
    """The local-attention ring of 32 slots holds positions 8..39 after 8
    decode steps from 32 prompt tokens: the steps overwrote slots 0..7."""
    _, cache = _port_run("recurrentgemma-9b", "float32")[-1]
    cfg = _models("recurrentgemma-9b", "float32")[1]
    slot = cfg.pattern.index("local_attn")
    pos = cache["stack"]["groups"][slot]["pos"]  # (reps, B, 32)
    assert pos.shape[-1] == cfg.window == 32
    want = np.concatenate([np.arange(32, 40), np.arange(8, 32)])
    np.testing.assert_array_equal(pos, np.broadcast_to(want, pos.shape))


@pytest.mark.parametrize("eos", ["never", "hit"])
@pytest.mark.parametrize("arch", MODELS)
def test_generate_matches_jax(arch, eos):
    """``eos_id=-1`` decodes every row to the end; otherwise the eos is the
    first row's third token, so that row stops there."""
    jcfg, cfg, jp, tp = _models(arch, "float32")
    prompts = _prompts(cfg)
    eos_id = -1
    if eos == "hit":
        eos_id = S.ServingEngine(cfg, tp, B, CACHE_LEN, eos_id=-1,
                                 device="cpu").generate(prompts, 3)[0][2]
    want = JE.ServingEngine(jcfg, jp, B, CACHE_LEN, eos_id=eos_id).generate(
        prompts, 8)
    got = S.ServingEngine(cfg, tp, B, CACHE_LEN, eos_id=eos_id,
                          device="cpu").generate(prompts, 8)
    assert got == want
    assert all(isinstance(t, int) for row in got for t in row)
    if eos == "hit":
        assert got[0][-1] == eos_id and len(got[0]) <= 3
    else:
        assert [len(row) for row in got] == [8, 8]


@pytest.mark.parametrize("arch", MODELS)
def test_bf16_prefill_and_decode_within_the_stack_bound(arch):
    got, want = _port_run(arch, "bfloat16"), _jax_run(arch, "bfloat16")
    for (logits, cache), (want_logits, want_cache) in zip(got, want):
        assert _rel(logits, want_logits) < TOL["bfloat16"]
        _assert_caches_match(cache, want_cache, TOL["bfloat16"])


@pytest.mark.parametrize("arch", MODELS)
def test_cached_decode_matches_the_cache_free_forward(arch):
    """Teacher-forced: the port's greedy serve (prefill, then 15 decode
    steps) against one cache-free forward over the prompt and the tokens it
    generated.  The logits at position S-1+t are the prefill's (t = 0) and
    decode step t's, within 1e-5, and each greedy token is that forward's
    argmax, or its logit lies within 1e-5 of the largest (a near tie)."""
    _, cfg, _, tp = _models(arch, "float32")
    n_new = 16  # 32 + 16 tokens: three SSD chunks, and the ring wraps
    toks = torch.from_numpy(S.left_pad(_prompts(cfg), B))
    Sp = toks.shape[1]
    step = S.make_serve_step(cfg)
    logits, cache = S.prefill(tp, cfg, toks, CACHE_LEN)
    served = [logits[:, -1]]
    cur = torch.argmax(logits[:, -1], dim=-1)
    tokens = [cur]
    for t in range(1, n_new):
        pos = torch.full((B, 1), Sp + t - 1)
        logits, cache = S.decode_step(tp, cfg, cache, cur[:, None], pos)
        served.append(logits[:, -1])
        cur = torch.argmax(logits[:, -1], dim=-1)
        tokens.append(cur)
    nxt, _ = step(tp, cache, cur[:, None], torch.full((B, 1), Sp + n_new - 1))
    assert nxt.shape == (B,) and nxt.dtype == torch.int64
    served = torch.stack(served, dim=1)  # (B, n_new, V)
    tokens = torch.stack(tokens, dim=1)  # (B, n_new)

    seq = torch.cat([toks, tokens], dim=1)
    pos = torch.arange(seq.shape[1]).expand(B, -1)
    hidden, none, _ = T.forward(tp, cfg, seq,
                                L.Ctx(mode="prefill", positions=pos))
    assert none is None
    W = T.head_matrix(tp, cfg).to(L.cdt(cfg))
    want = (hidden[:, Sp - 1 : Sp - 1 + n_new] @ W).float()
    if cfg.final_softcap:
        want = L.softcap(want, cfg.final_softcap)
    scale = want.abs().amax(-1)
    assert float(((served - want).abs().amax(-1) / scale).max()) < 1e-5
    gap = (want.amax(-1) - torch.gather(want, -1, tokens[..., None])[..., 0])
    assert float((gap / scale).max()) <= 1e-5


def test_ssd_prefill_with_a_ragged_length_raises():
    """A prefill longer than ``ssm_chunk`` (16) that it does not divide
    raises in both packages."""
    jcfg, cfg, jp, tp = _models("mamba2-370m", "float32")
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, 20))
    with pytest.raises(AssertionError, match="divisible"):
        JE.prefill(jp, jcfg, jnp.asarray(toks, jnp.int32), CACHE_LEN)
    with pytest.raises(ValueError, match="divide"):
        S.prefill(tp, cfg, torch.from_numpy(toks), CACHE_LEN)


@pytest.mark.parametrize("arch,kind", [("qwen3-moe-30b-a3b", "moe"),
                                       ("arctic-480b", "moe_dense")])
def test_moe_caches_name_a17(arch, kind):
    cfg = ARCHS[arch].reduced()
    with pytest.raises(NotImplementedError, match="A17"):
        T.init_block_cache(cfg, kind, B, CACHE_LEN, device="cpu")
    tp = T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="A17"):
        S.prefill(tp, cfg, torch.zeros((B, 8), dtype=torch.int64),
                  CACHE_LEN)


def test_engine_runs_on_the_card_unless_asked_otherwise(monkeypatch):
    _, cfg, _, tp = _models("mamba2-370m", "float32")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.ServingEngine(cfg, tp, B, CACHE_LEN)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_cache(cfg, B, CACHE_LEN)
    assert S.ServingEngine(cfg, tp, B, CACHE_LEN,
                           device="cpu").device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="parameter lives on cpu"):
        S.ServingEngine(cfg, tp, B, CACHE_LEN, device="cuda")


def test_decode_needs_a_cache_and_a_ring_takes_at_most_its_length():
    _, cfg, _, tp = _models("qwen2-1.5b", "float32")
    decode = L.Ctx(mode="decode", positions=torch.zeros((B, 1),
                                                        dtype=torch.int64))
    x = torch.zeros((B, 1, cfg.d_model))
    with pytest.raises(ValueError, match="needs its cache"):
        T.apply_block(tp["stack"]["layers"][0], cfg, "attn", x, decode, None)
    ring = L.init_kv_cache(cfg, B, 4, device="cpu")
    kv = torch.zeros((B, 5, cfg.n_kv_heads, cfg.resolved_head_dim))
    with pytest.raises(ValueError, match="5 tokens written into a ring of 4"):
        L._cache_write(ring, kv, kv, torch.arange(5).expand(B, 5))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_cache_layout_round_trips(compute_dtype):
    """A JAX cache (recurrentgemma at 5 layers: one repetition of its
    pattern, and two layers of remainder) through ``cache_from_jax`` and
    ``cache_to_jax_layout`` comes back leaf for leaf, bf16 widened to
    float32; the port's leaves are of the port's types and shapes."""
    jcfg, cfg, jp, _ = _models("recurrentgemma-9b", compute_dtype,
                               n_layers=5)
    toks = S.left_pad(_prompts(cfg), B)
    _, jcache = JE.prefill(jp, jcfg, jnp.asarray(toks, jnp.int32), CACHE_LEN)
    want = jax.tree.map(np.asarray, jcache)
    got = convert.cache_from_jax(want, cfg, "cpu")
    empty = {"stack": T.init_cache(cfg, B, CACHE_LEN, device="cpu")}
    assert T.tree_map(lambda t: (t.shape, t.dtype), got) == \
        T.tree_map(lambda t: (t.shape, t.dtype), empty)
    back = convert.cache_to_jax_layout(got, cfg)
    assert len(back["stack"]["groups"]) == 3 and len(back["stack"]["rem"]) == 2
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        assert g.dtype == (np.float32 if w.dtype.name == "bfloat16"
                           else w.dtype)
        np.testing.assert_array_equal(g, w.astype(g.dtype))
