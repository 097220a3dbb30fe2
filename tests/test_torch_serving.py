"""The port's serving engine on the CPU against the JAX package's.

JAX parameters go through ``params_from_jax`` and JAX caches through
``cache_from_jax`` (``cache_to_jax_layout`` brings the port's back, leaf by
leaf).  Six reduced models (qwen2-1.5b, qwen3-14b with its qk-norm,
mamba2-370m, recurrentgemma-9b, and the MoE models qwen3-moe-30b-a3b and
arctic-480b) serve a batch of two prompts of 12 and 32 tokens, left-padded
to 32 (two SSD chunks of 16), into caches of 48 slots: recurrentgemma's
local-attention ring has min(48, window 32) = 32 slots, so its decode steps
wrap it.  An MoE layer routes a call's own tokens: the prefill's 64 as one
group, a decode step's 2 as one group at capacity max(1, int(2 * 2 / 4 *
1.25)) = 1, so its steps drop a slot wherever the two tokens pick the same
expert.

In float32 compute every MoE layer call routes every token alike in the two
packages (each side's routing recorded, the JAX package's through
``test_torch_models.jax_route`` and an ordered callback, decode steps
included), and the port's logits and every cache leaf lie within 1e-5 of
the JAX package's largest magnitude (``pos`` ``==``), after the prefill and
after each of 8 decode steps fed the same tokens, and
``ServingEngine.generate`` gives JAX's tokens, token for token.  In bf16
the prefill and 4 decode steps lie within 5e-2, the bound of a bf16 stack
in ``tests/test_torch_models.py``; MoE route-aware: every pick that differs
is a near tie on the JAX side, and the rows compared are those whose every
token so far kept the same experts at every layer.  The port is also held
against itself: its cached decode against its own cache-free forward over
the same tokens.
"""
from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.serving import engine as JE
from repro_torch import serving as S
from repro_torch.configs import ARCHS
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from test_torch_models import jax_route

MOE = ["qwen3-moe-30b-a3b", "arctic-480b"]
MODELS = ["qwen2-1.5b", "qwen3-14b", "mamba2-370m", "recurrentgemma-9b",
          "gemma2-27b", "starcoder2-7b", *MOE]
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


@contextlib.contextmanager
def _routes(package: str, replay=None):
    """Every MoE layer call's routing inside the block, in call order, as
    (logits, idx, keep) tensors: the port's ``moe_route`` (``package``
    "port"), or the JAX package's ``moe_ffn`` recomputed by ``jax_route``
    and handed out by an ordered callback, also from inside ``lax.scan``
    and ``jit`` ("jax"; ``jax.effects_barrier`` waits for them).  With
    ``replay`` (the JAX package's routings of the same calls) the port's
    calls send their tokens to the JAX package's experts instead
    (``routing_of_picks``), which must keep the same slots; the port's own
    router's routings are still the ones recorded."""
    routes: list = []
    if package == "port":
        route = L.moe_route

        def port_route(router, cfg, toks):
            r = route(router, cfg, toks)
            routes.append((r.logits, r.idx, r.keep))
            if replay is not None:
                _, idx, keep = replay[len(routes) - 1]
                r = L.routing_of_picks(r.logits, r.probs, idx.long(),
                                       r.capacity)
                assert torch.equal(r.keep, keep)
            return r

        L.moe_route = port_route
        try:
            yield routes
        finally:
            L.moe_route = route
        return
    ffn = JL.moe_ffn

    def keep(*arrays):
        routes.append(tuple(torch.from_numpy(np.array(a)) for a in arrays))

    def jax_ffn(p, cfg, x):
        jax.debug.callback(keep, *jax_route(p["router"], cfg, x),
                           ordered=True)
        return ffn(p, cfg, x)

    JL.moe_ffn = jax_ffn
    try:
        yield routes
        jax.effects_barrier()
    finally:
        JL.moe_ffn = ffn


@functools.cache
def _jax_run(arch: str, compute_dtype: str):
    """The JAX package's prefill of the padded prompts, then its decode
    steps: [(logits, cache, routes)], numpy leaves, ``routes`` the call's
    MoE routings (empty without MoE layers)."""
    jcfg, cfg, jp, _ = _models(arch, compute_dtype)
    toks = S.left_pad(_prompts(cfg), B)
    with _routes("jax") as routes:
        logits, cache = JE.prefill(jp, jcfg, jnp.asarray(toks, jnp.int32),
                                   CACHE_LEN)
        runs = [(np.asarray(logits), jax.tree.map(np.asarray, cache))]
        step = jax.jit(lambda p, c, t, pos: JE.decode_step(p, jcfg, c, t,
                                                           pos))
        for i, fed in enumerate(_fed_tokens(cfg, STEPS[compute_dtype])):
            pos = np.full((B, 1), toks.shape[1] + i, np.int32)
            logits, cache = step(jp, cache, jnp.asarray(fed, jnp.int32),
                                 jnp.asarray(pos))
            runs.append((np.asarray(logits),
                         jax.tree.map(np.asarray, cache)))
    return _with_routes(cfg, runs, routes)


def _with_routes(cfg, runs: list, routes: list) -> list:
    """Each call's (logits, cache) with its own MoE routings appended."""
    n = sum(kind in ("moe", "moe_dense")
            for kind in T.layer_kinds(cfg.n_layers, cfg.pattern))
    assert len(routes) == n * len(runs)
    return [(*run, routes[i * n:(i + 1) * n]) for i, run in enumerate(runs)]


def _port_run(arch: str, compute_dtype: str, replay=None):
    """The port's prefill and decode steps on the same inputs, each cache
    in the JAX layout as it was after its step (the KV rings are written
    in place), with each call's MoE routings (see ``_routes`` for
    ``replay``)."""
    _, cfg, _, tp = _models(arch, compute_dtype)
    toks = torch.from_numpy(S.left_pad(_prompts(cfg), B))
    with _routes("port", replay) as routes:
        logits, cache = S.prefill(tp, cfg, toks, CACHE_LEN)
        runs = [(logits, convert.cache_to_jax_layout(cache, cfg))]
        for i, fed in enumerate(_fed_tokens(cfg, STEPS[compute_dtype])):
            pos = torch.full((B, 1), toks.shape[1] + i)
            logits, cache = S.decode_step(tp, cfg, cache,
                                          torch.from_numpy(fed), pos)
            runs.append((logits, convert.cache_to_jax_layout(cache, cfg)))
    return _with_routes(cfg, runs, routes)


def _assert_routed_alike(routes, want_routes) -> None:
    """A float32 call routes every token of every MoE layer as the JAX
    package's does."""
    assert len(routes) == len(want_routes)
    if want_routes:
        ra = L.routing_agreement(routes, want_routes)
        assert ra.flips == 0 and bool(ra.agree.all()), ra


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
    logits, cache, routes = _port_run(arch, "float32")[0]
    want_logits, want_cache, want_routes = _jax_run(arch, "float32")[0]
    _assert_routed_alike(routes, want_routes)
    assert logits.shape == want_logits.shape
    assert logits.dtype == torch.float32
    assert _rel(logits, want_logits) < TOL["float32"]
    _assert_caches_match(cache, want_cache, TOL["float32"])


@pytest.mark.parametrize("arch", MODELS)
def test_decode_steps_match_jax(arch):
    got, want = _port_run(arch, "float32"), _jax_run(arch, "float32")
    assert len(got) == len(want) == 1 + STEPS["float32"]
    for (logits, cache, routes), (want_logits, want_cache, want_routes) \
            in zip(got[1:], want[1:]):
        _assert_routed_alike(routes, want_routes)
        assert _rel(logits, want_logits) < TOL["float32"]
        _assert_caches_match(cache, want_cache, TOL["float32"])


def test_recurrentgemma_ring_wraps():
    """The local-attention ring of 32 slots holds positions 8..39 after 8
    decode steps from 32 prompt tokens: the steps overwrote slots 0..7."""
    _, cache, _ = _port_run("recurrentgemma-9b", "float32")[-1]
    cfg = _models("recurrentgemma-9b", "float32")[1]
    slot = cfg.pattern.index("local_attn")
    pos = cache["stack"]["groups"][slot]["pos"]  # (reps, B, 32)
    assert pos.shape[-1] == cfg.window == 32
    want = np.concatenate([np.arange(32, 40), np.arange(8, 32)])
    np.testing.assert_array_equal(pos, np.broadcast_to(want, pos.shape))


def test_gemma2_prefill_past_its_ring_matches_jax():
    """gemma2-27b reduced, float32: prompts of 12 and 40 tokens left-padded
    to 40 into caches of 48 slots, so the prefill runs past the end of the
    local ring of min(48, window 32) = 32 slots and keeps the last 32
    positions (the JAX package's ``tail``), as path 3 of ``chip_smoke.py``
    serves gemma2-27b at full width; then 4 decode steps wrap the ring
    again.  Every call's logits and cache leaves within 1e-5 of the JAX
    package's (``pos`` ``==``)."""
    jcfg, cfg, jp, tp = _models("gemma2-27b", "float32")
    rng = np.random.default_rng(7)
    toks = S.left_pad([rng.integers(1, cfg.vocab_size, n) for n in (12, 40)],
                      B)
    assert toks.shape[1] == 40 > cfg.window
    fed = _fed_tokens(cfg, 4)
    logits_j, cache_j = JE.prefill(jp, jcfg, jnp.asarray(toks, jnp.int32),
                                   CACHE_LEN)
    logits_t, cache_t = S.prefill(tp, cfg, torch.from_numpy(toks), CACHE_LEN)
    slot = cfg.pattern.index("local_attn")
    ring = cache_t["stack"]["layers"][slot]["pos"]
    np.testing.assert_array_equal(
        ring, np.broadcast_to(np.concatenate([np.arange(32, 40),
                                              np.arange(8, 32)]), ring.shape))
    for i in range(len(fed) + 1):
        assert _rel(logits_t, logits_j) < TOL["float32"]
        _assert_caches_match(convert.cache_to_jax_layout(cache_t, cfg),
                             jax.tree.map(np.asarray, cache_j),
                             TOL["float32"])
        if i == len(fed):
            break
        pos = np.full((B, 1), toks.shape[1] + i)
        logits_j, cache_j = JE.decode_step(jp, jcfg, cache_j,
                                           jnp.asarray(fed[i], jnp.int32),
                                           jnp.asarray(pos, jnp.int32))
        logits_t, cache_t = S.decode_step(tp, cfg, cache_t,
                                          torch.from_numpy(fed[i]),
                                          torch.from_numpy(pos))


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
    """MoE route-aware.  The two packages round the bf16 residual
    differently, so a token whose experts nearly tie can pick another one,
    or the same two in the other slot order, which moves the buffer places
    and so the capacity drops of other tokens of its group.  So the port
    runs with the JAX package's expert picks replayed, dropping the same
    slots, and every logit and cache leaf is held to 5e-2; its own router's
    picks in that run may differ from the JAX package's only at near ties
    (within 5e-2 of the largest |logit|), half the tokens of each call at
    least keeping the same experts at every layer."""
    want = _jax_run(arch, "bfloat16")
    got = _port_run(arch, "bfloat16",
                    replay=[r for run in want for r in run[2]])
    for (logits, cache, routes), (want_logits, want_cache, want_routes) \
            in zip(got, want):
        if want_routes:
            ra = L.routing_agreement(routes, want_routes)
            assert ra.flips_are_near_ties(TOL["bfloat16"]), ra
            assert 2 * int(ra.agree.sum()) >= ra.agree.numel(), ra
        assert _rel(logits, want_logits) < TOL["bfloat16"]
        _assert_caches_match(cache, want_cache, TOL["bfloat16"])


@pytest.mark.parametrize("arch", MODELS)
def test_cached_decode_matches_the_cache_free_forward(arch):
    """Teacher-forced: the port's greedy serve (prefill, then 15 decode
    steps) against one cache-free forward over the prompt and the tokens it
    generated.  The logits at position S-1+t are the prefill's (t = 0) and
    decode step t's, within 1e-5, and each greedy token is that forward's
    argmax, or its logit lies within 1e-5 of the largest (a near tie).

    The MoE models run with ``capacity_factor`` E / k: an MoE layer takes
    its capacity over a call's own tokens, so at the config's 1.25 a decode
    step (2 tokens, capacity 1) and the forward (96 tokens, capacity 60)
    rightly drop different slots, and the two runs compute different
    functions.  At E / k the capacity is the group's length in both runs
    and no slot can drop."""
    over = {}
    if arch in MOE:
        c = ARCHS[arch].reduced()
        over["capacity_factor"] = c.n_experts / c.moe_top_k
    _, cfg, _, tp = _models(arch, "float32", **over)
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


def test_moe_prefill_of_partial_groups_raises():
    """A prefill of B * S = 1,200 tokens, over MOE_GROUP (1,024) and not a
    multiple of it, raises in both packages: the JAX package's reshape into
    groups fails, the port names the tokens and MOE_GROUP."""
    jcfg, cfg, jp, tp = _models("qwen3-moe-30b-a3b", "float32")
    assert L.MOE_GROUP == JL.MOE_GROUP == 1024
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (B, 600))
    with pytest.raises(TypeError, match="reshape"):
        JE.prefill(jp, jcfg, jnp.asarray(toks, jnp.int32), 640)
    with pytest.raises(ValueError, match="1200 tokens.*MOE_GROUP = 1024"):
        S.prefill(tp, cfg, torch.from_numpy(toks), 640)


@pytest.mark.parametrize("arch,kind", [("qwen3-moe-30b-a3b", "moe"),
                                       ("arctic-480b", "moe_dense")])
def test_moe_caches_name_a17(arch, kind):
    """Named for the time MoE caches raised naming ROADMAP A17; now an MoE
    block's cache is the KV ring of ``attn`` (``k``, ``v`` of (B, length,
    Hkv, hd) in the compute type, ``pos`` -1), as the JAX package's, and
    the JAX package's MoE serving cache after a prefill crosses through
    ``cache_from_jax`` and back through ``cache_to_jax_layout`` leaf for
    leaf."""
    jcfg, cfg, jp, _ = _models(arch, "float32")
    ring = T.init_block_cache(cfg, kind, B, CACHE_LEN, device="cpu")
    want = jax.tree.map(np.asarray, JT.init_block_cache(jcfg, kind, B,
                                                        CACHE_LEN))
    assert set(ring) == set(want) == {"k", "v", "pos"}
    for name, t in ring.items():
        assert tuple(t.shape) == want[name].shape
        np.testing.assert_array_equal(t.numpy(), want[name])
    assert ring["pos"].dtype == torch.int64
    toks = S.left_pad(_prompts(cfg), B)
    _, jcache = JE.prefill(jp, jcfg, jnp.asarray(toks, jnp.int32), CACHE_LEN)
    jcache = jax.tree.map(np.asarray, jcache)
    got = convert.cache_from_jax(jcache, cfg, "cpu")
    empty = {"stack": T.init_cache(cfg, B, CACHE_LEN, device="cpu")}
    assert T.tree_map(lambda t: (t.shape, t.dtype), got) == \
        T.tree_map(lambda t: (t.shape, t.dtype), empty)
    back = convert.cache_to_jax_layout(got, cfg)
    assert jax.tree.structure(back) == jax.tree.structure(jcache)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(jcache)):
        np.testing.assert_array_equal(g, w)


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
