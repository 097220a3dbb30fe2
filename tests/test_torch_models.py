"""The port's model stack on the CPU against the JAX package.

JAX parameters (``repro.models.transformer.init_params``) are carried over
with ``repro_torch.models.convert.params_from_jax``; then each block kind
(``attn`` of qwen2-1.5b, qwen3-14b and starcoder2-7b with its biases,
``local_attn`` and ``attn`` of gemma2-27b with its softcaps, ``ssd`` of
mamba2-370m, ``moe`` of qwen3-moe-30b-a3b, ``moe_dense`` of arctic-480b,
``rglru`` of recurrentgemma-9b, all reduced) and the whole stack run in
both packages on the same numpy inputs; gemma2-27b also past its reduced
window, and reduced configs at head groups of 5 and 9.  In float32 compute the two agree to 1e-5 of the
output's largest magnitude (float32 sums in other orders), and every MoE
layer routes every token alike: that is the check of the algorithm.

In bf16 compute one block agrees to 2e-2 of it, the bound
``tests/test_simulator.py`` uses between two orderings of the JAX model
itself.  A stack of blocks is held to 5e-2: the frameworks round bf16 at
other places (XLA keeps fused elementwise chains in fp32, the port rounds
every op, and the port's attention keeps its probabilities in fp32 where
the JAX model rounds them to bf16), and the SSD stack amplifies rounding.
``scripts/bf16_parity_spread.py`` measures it: on mamba2-370m reduced, 2
and 4 layers, B 2, S 32, three keys, the port's bf16 stack was within
4.1e-2 of the jitted JAX model, and the JAX model's own jitted and op-by-op
runs differed by up to 2.2e-2.

MoE in bf16 is compared route-aware.  The router is float32, but its input
is the bf16 residual, which the two packages round differently; a token
whose k-th and (k+1)-th experts nearly tie can then pick another expert,
and its output differs by its gate times an expert's output.  So each side's
routing is recorded (the port's ``layers.moe_route``; on the JAX side
layers.py:400-419 of its ``moe_ffn`` recomputed on the same input, which a
``jax.debug.callback`` hands out of the scan), every flipped pick must be a
near tie on the JAX side (``RouteAgreement.flips_are_near_ties``, within
the bf16 tolerance of the largest |logit|), and the output is held to the
tolerance on the tokens that keep the same experts at every layer.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import ARCHS
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

TOL = {"float32": 1e-5, "bfloat16": 2e-2}  # one block
TOL_STACK = {"float32": 1e-5, "bfloat16": 5e-2}  # several blocks
BLOCKS = [("qwen2-1.5b", "attn"), ("qwen3-14b", "attn"),
          ("mamba2-370m", "ssd"), ("qwen3-moe-30b-a3b", "moe"),
          ("arctic-480b", "moe_dense"), ("recurrentgemma-9b", "rglru"),
          ("gemma2-27b", "local_attn"), ("gemma2-27b", "attn"),
          ("starcoder2-7b", "attn")]
STACKS = ["qwen2-1.5b", "mamba2-370m", "qwen3-14b", "qwen3-moe-30b-a3b",
          "arctic-480b", "recurrentgemma-9b", "gemma2-27b", "starcoder2-7b"]
B, S = 2, 16  # the sizes of tests/test_simulator.py


def jax_route(router, cfg, x):
    """The routing of the JAX package's ``moe_ffn`` on x (B, S, D),
    layers.py:391-419 step for step: (logits, idx, keep), each (G, g, .)."""
    B_, S_, D = x.shape
    g = min(JL.MOE_GROUP, B_ * S_)
    toks = x.reshape(max(1, B_ * S_ // g), g, D)
    E, k = cfg.n_experts, cfg.moe_top_k
    C = max(1, int(g * k / E * cfg.capacity_factor))
    logits = jnp.einsum("gtd,de->gte", toks.astype(jnp.float32), router)
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), k)
    mask = jax.nn.one_hot(idx, E, dtype=jnp.int32)
    totals = mask.sum(axis=1, keepdims=True)
    pos = (jnp.cumsum(mask, axis=1) - mask + jnp.cumsum(totals, axis=2)
           - totals)
    pos = jnp.take_along_axis(pos, idx[..., None], axis=-1)[..., 0]
    return logits, idx, pos < C


@contextlib.contextmanager
def recorded_routes(monkeypatch):
    """Record every MoE layer's routing in both packages, in layer order:
    yields (port's, JAX's), lists of (logits, idx, keep) tensors.  The JAX
    side's records arrive through ordered callbacks, also from inside
    ``lax.scan`` and ``jit``; ``jax.effects_barrier`` waits for them."""
    port, ref = [], []
    route, ffn = L.moe_route, JL.moe_ffn

    def port_route(router, cfg, toks):
        r = route(router, cfg, toks)
        port.append((r.logits, r.idx, r.keep))
        return r

    def keep(*arrays):
        ref.append(tuple(torch.from_numpy(np.array(a)) for a in arrays))

    def jax_ffn(p, cfg, x):
        jax.debug.callback(keep, *jax_route(p["router"], cfg, x),
                           ordered=True)
        return ffn(p, cfg, x)

    monkeypatch.setattr(L, "moe_route", port_route)
    monkeypatch.setattr(JL, "moe_ffn", jax_ffn)
    yield port, ref
    jax.effects_barrier()


def route_aware_err(got, want, routes, cfg, compute_dtype,
                    tol=TOL_STACK) -> float:
    """The relative error of ``got`` against ``want`` (B, S, D) over the
    tokens that route alike at every MoE layer (all tokens where the model
    has none).  Float32 compute must route every token alike; in bf16 every
    token that diverged must have done so at a near tie on the JAX side
    (within the bf16 tolerance ``tol`` of the largest |logit|), and half
    the tokens at least must agree."""
    port, ref = routes
    want = np.asarray(jnp.asarray(want, jnp.float32)).reshape(-1, cfg.d_model)
    got = got.float().numpy().reshape(-1, cfg.d_model)
    if not ref:
        assert not port
        return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-6))
    ra = L.routing_agreement(port, ref)
    assert ra.picks == len(ref) * got.shape[0] * cfg.moe_top_k
    if compute_dtype == "float32":
        assert ra.flips == 0 and bool(ra.agree.all())
    assert ra.flips_are_near_ties(tol[compute_dtype]), ra
    agree = ra.agree.numpy()
    assert agree.sum() * 2 >= agree.size, ra
    return float(np.abs(got[agree] - want[agree]).max()
                 / (np.abs(want[agree]).max() + 1e-6))


def _configs(arch, compute_dtype, **over):
    jcfg = JAX_ARCHS[arch].reduced(compute_dtype=compute_dtype, **over)
    cfg = ARCHS[arch].reduced(compute_dtype=compute_dtype, **over)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    return jcfg, cfg


def _params(jcfg, cfg, seed=0):
    jp = JT.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                       "cpu")


def _hidden(cfg, seed=1):
    x = np.random.default_rng(seed).standard_normal((B, S, cfg.d_model))
    return x.astype(np.float32)


def _contexts():
    pos = np.broadcast_to(np.arange(S), (B, S))
    return (JL.Ctx(mode="prefill", positions=jnp.asarray(pos, jnp.int32)),
            L.Ctx(mode="prefill", positions=torch.from_numpy(pos.copy())))


def _rel_err(got: torch.Tensor, want) -> float:
    want = np.asarray(jnp.asarray(want, jnp.float32))
    err = np.abs(got.float().numpy() - want).max()
    return float(err / (np.abs(want).max() + 1e-6))


def test_params_from_jax_carries_every_weight_over():
    jcfg, cfg = _configs("qwen2-1.5b", "bfloat16", n_layers=5,
                         pattern=("attn", "local_attn"))
    jp, tp = _params(jcfg, cfg)
    assert len(tp["stack"]["layers"]) == 5
    # layer 2r + i is repetition r of pattern slot i; layer 4 is `rem`
    for r in range(2):
        for i in range(2):
            lp = tp["stack"]["layers"][2 * r + i]
            slot = jp["stack"]["groups"][i]
            for name in ("wq", "wk", "wv", "wo", "bq", "bk", "bv"):
                np.testing.assert_array_equal(
                    lp["attn"][name].numpy(),
                    np.asarray(slot["attn"][name][r]))
            np.testing.assert_array_equal(
                lp["mlp"]["w_down"].numpy(),
                np.asarray(slot["mlp"]["w_down"][r]))
            np.testing.assert_array_equal(lp["ln1"].numpy(),
                                          np.asarray(slot["ln1"][r]))
    rem = jp["stack"]["rem"][0]
    np.testing.assert_array_equal(tp["stack"]["layers"][4]["attn"]["wq"],
                                  np.asarray(rem["attn"]["wq"]))
    np.testing.assert_array_equal(tp["embed"], np.asarray(jp["embed"]))
    assert "head" not in tp  # tied embeddings
    assert tp["embed"].dtype == torch.float32


@pytest.mark.parametrize("arch", STACKS)
def test_init_params_has_the_jax_tree(arch):
    """The port's own initialiser builds the tree the converter builds."""
    jcfg, cfg = _configs(arch, "bfloat16")
    _, tp = _params(jcfg, cfg)
    own = T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [shapes(v) for v in tree]
        return (tuple(tree.shape), tree.dtype)

    assert shapes(own) == shapes(tp)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,kind", BLOCKS)
def test_block_matches_jax(arch, kind, compute_dtype, monkeypatch):
    """One block of each kind, with its aux loss (the MoE load-balance
    loss, 0 elsewhere) at the block's tolerance: it averages the router's
    probabilities, which the bf16 residual moves as it moves the output."""
    jcfg, cfg = _configs(arch, compute_dtype)
    jp, tp = _params(jcfg, cfg)
    x = _hidden(cfg)
    jctx, tctx = _contexts()
    p_j = jax.tree.map(lambda a: a[0], jp["stack"]["groups"][0])
    with recorded_routes(monkeypatch) as routes:
        want, _, aux_j = JT.apply_block(p_j, jcfg, kind,
                                        jnp.asarray(x).astype(JL.cdt(jcfg)),
                                        jctx, None)
        got, cache, aux = T.apply_block(tp["stack"]["layers"][0], cfg, kind,
                                        torch.from_numpy(x).to(L.cdt(cfg)),
                                        tctx, None)
    assert cache is None and got.dtype == getattr(torch, compute_dtype)
    assert len(routes[0]) == (kind in ("moe", "moe_dense"))
    assert route_aware_err(got, want, routes, cfg, compute_dtype,
                           TOL) < TOL[compute_dtype]
    assert aux.dtype == torch.float32
    assert abs(float(aux) - float(aux_j)) <= \
        TOL[compute_dtype] * max(1.0, float(aux_j))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", STACKS)
def test_stack_and_forward_match_jax(arch, compute_dtype, monkeypatch):
    """The stack (with its summed aux loss), the forward pass and the last
    position's logits; route-aware where the model has MoE layers (the
    logits of the last positions then only where both sequences' last
    tokens route alike at every layer)."""
    jcfg, cfg = _configs(arch, compute_dtype)
    jp, tp = _params(jcfg, cfg)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S))
    jctx, tctx = _contexts()
    jx = JT.embed_tokens(jp, jcfg, jnp.asarray(tokens, jnp.int32))
    tx = T.embed_tokens(tp, cfg, torch.from_numpy(tokens))
    with recorded_routes(monkeypatch) as routes:
        want, _, aux_j = JT.apply_stack(jp["stack"], jcfg, jcfg.n_layers,
                                        jcfg.pattern, jx, jctx, None)
        got, _, aux = T.apply_stack(tp["stack"], cfg, cfg.n_layers,
                                    cfg.pattern, tx, tctx, None)
    assert route_aware_err(got, want, routes, cfg,
                           compute_dtype) < TOL_STACK[compute_dtype]
    assert abs(float(aux) - float(aux_j)) <= \
        TOL_STACK[compute_dtype] * max(1.0, float(aux_j))
    with recorded_routes(monkeypatch) as routes:
        hid_j, _, _ = JT.forward(jp, jcfg, jnp.asarray(tokens, jnp.int32),
                                 jctx)
        hid_t, _, _ = T.forward(tp, cfg, torch.from_numpy(tokens), tctx)
    assert route_aware_err(hid_t, hid_j, routes, cfg,
                           compute_dtype) < TOL_STACK[compute_dtype]
    logits_t = T.logits_last(tp, cfg, hid_t)
    logits_j = JT.logits_last(jp, jcfg, hid_j)
    assert logits_t.shape == (B, 1, cfg.vocab_size)
    last = np.ones(B, dtype=bool)
    if routes[1]:
        last = L.routing_agreement(*routes).agree.reshape(B, S)[:, -1].numpy()
    assert _rel_err(logits_t[last], np.asarray(logits_j)[last]) < \
        TOL_STACK[compute_dtype]


def _stack_logits(jcfg, cfg, seq: int, seed: int = 2):
    """The stack and the last position's logits of both packages over
    (B, seq) tokens: (port's hidden, JAX's hidden, port's logits, JAX's
    logits), the JAX ones as numpy."""
    jp, tp = _params(jcfg, cfg)
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size,
                                                  (B, seq))
    pos = np.broadcast_to(np.arange(seq), (B, seq))
    hid_j, _, _ = JT.forward(jp, jcfg, jnp.asarray(tokens, jnp.int32),
                             JL.Ctx(mode="prefill",
                                    positions=jnp.asarray(pos, jnp.int32)))
    hid_t, _, _ = T.forward(tp, cfg, torch.from_numpy(tokens),
                            L.Ctx(mode="prefill",
                                  positions=torch.from_numpy(pos.copy())))
    return (hid_t, hid_j, T.logits_last(tp, cfg, hid_t),
            np.asarray(JT.logits_last(jp, jcfg, hid_j)))


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_gemma2_past_its_window_matches_jax(compute_dtype):
    """gemma2-27b reduced (window 32) at S 64: its local layers' window
    masks the first half of the keys of the last positions, and the final
    softcap of 30 shapes the logits.  The stack and the last position's
    logits within the stack's tolerance of the JAX package's; the same
    model without its window gives other hidden states (so the window did
    mask), and every logit lies inside the softcap."""
    seq = 64
    jcfg, cfg = _configs("gemma2-27b", compute_dtype)
    assert cfg.window == 32 < seq and cfg.final_softcap == 30.0
    hid_t, hid_j, logits_t, logits_j = _stack_logits(jcfg, cfg, seq)
    assert hid_t.shape == (B, seq, cfg.d_model)
    assert _rel_err(hid_t, hid_j) < TOL_STACK[compute_dtype]
    assert logits_t.shape == (B, 1, cfg.vocab_size)
    assert _rel_err(logits_t, logits_j) < TOL_STACK[compute_dtype]
    assert float(logits_t.abs().max()) <= cfg.final_softcap
    unmasked = _stack_logits(*(dataclasses.replace(c, window=None)
                               for c in (jcfg, cfg)), seq)[0]
    assert _rel_err(unmasked, np.asarray(hid_t.float())) > \
        TOL_STACK[compute_dtype]


@pytest.mark.parametrize("arch,heads", [("qwen3-14b", (10, 2)),
                                        ("starcoder2-7b", (9, 1))])
def test_odd_head_groups_match_jax(arch, heads):
    """Head groups of 5 (qwen3-14b's 40 / 8) and 9 (starcoder2-7b's 36 /
    4) at reduced width: every block's query heads share their KV head by
    ``h // G``; the stack and the last logits within 1e-5 of the JAX
    package's in float32."""
    n_heads, n_kv = heads
    jcfg, cfg = _configs(arch, "float32", n_heads=n_heads, n_kv_heads=n_kv)
    assert cfg.n_heads // cfg.n_kv_heads in (5, 9)
    hid_t, hid_j, logits_t, logits_j = _stack_logits(jcfg, cfg, S)
    assert _rel_err(hid_t, hid_j) < TOL_STACK["float32"]
    assert _rel_err(logits_t, logits_j) < TOL_STACK["float32"]


def test_layer_helpers_keep_the_jax_semantics():
    """rmsnorm scales by 1 + scale, rope rotates halves, gelu is the tanh
    approximation."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    scale = rng.standard_normal((8,)).astype(np.float32)
    pos = np.broadcast_to(np.arange(5), (2, 5)).copy()
    np.testing.assert_allclose(
        L.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6),
        JL.rmsnorm(jnp.asarray(x), jnp.asarray(scale), 1e-6), rtol=1e-5,
        atol=1e-6)
    np.testing.assert_allclose(
        L.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4),
        JL.rope(jnp.asarray(x), jnp.asarray(pos), 1e4), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(L.gelu_tanh(torch.from_numpy(x)),
                               jax.nn.gelu(jnp.asarray(x)), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("arch,kind", [("llama-3.2-vision-90b", "xattn"),
                                       ("whisper-small", "dec_block")])
def test_unported_kinds_name_their_roadmap_item(arch, kind):
    """Named for the time they raised; now the cross-attention kinds build
    the JAX package's block (``tests/test_torch_cross.py`` holds them to
    it), their gate ``xgate`` zero at init as there."""
    jcfg, cfg = _configs(arch, "bfloat16")
    p = T.init_block(torch.Generator().manual_seed(0), cfg, kind)
    want = JT.init_block(jax.random.PRNGKey(0), jcfg, kind)
    assert T.tree_map(lambda t: tuple(t.shape), p) == jax.tree.map(
        lambda a: tuple(a.shape), want, is_leaf=lambda a: hasattr(a, "shape"))
    gate = p["attn" if kind == "xattn" else "xattn"]["xgate"]
    assert gate.shape == () and float(gate) == 0.0


def _cached_block_steps(arch, kind, jcache, tcache):
    """One block of ``kind`` (float32) in both packages: a prefill of
    (B, S) from the given caches, then a decode step at position S from
    the caches it returned.  Returns the relative errors of the outputs
    and of every float cache leaf; ``pos`` leaves must be ``==``."""
    jcfg, cfg = _configs(arch, "float32")
    jp, tp = _params(jcfg, cfg)
    p_j = jax.tree.map(lambda a: a[0], jp["stack"]["groups"][0])
    p_t = tp["stack"]["layers"][0]
    x = _hidden(cfg)
    x1 = np.random.default_rng(4).standard_normal((B, 1, cfg.d_model))
    jctx, tctx = _contexts()
    pos1 = np.full((B, 1), S)
    steps = [(x, jctx, tctx), (x1.astype(np.float32), JL.Ctx(
        mode="decode", positions=jnp.asarray(pos1, jnp.int32)), L.Ctx(
        mode="decode", positions=torch.from_numpy(pos1)))]
    errs = []
    for xs, jc, tc in steps:
        want, jcache, _ = JT.apply_block(p_j, jcfg, kind, jnp.asarray(xs),
                                         jc, jcache)
        got, tcache, _ = T.apply_block(p_t, cfg, kind, torch.from_numpy(xs),
                                       tc, tcache)
        errs.append(_rel_err(got, want))
        assert set(tcache) == set(jcache)
        for name, t in tcache.items():
            if name == "pos":
                np.testing.assert_array_equal(t.numpy(),
                                              np.asarray(jcache[name]))
            else:
                errs.append(_rel_err(t, jcache[name]))
    return errs


@pytest.mark.parametrize("arch,kind", [("qwen3-moe-30b-a3b", "moe"),
                                       ("arctic-480b", "moe_dense"),
                                       ("recurrentgemma-9b", "rglru")])
def test_new_kinds_with_a_cache_name_their_roadmap_item(arch, kind,
                                                        monkeypatch):
    """Named for the time the MoE blocks with a cache raised naming ROADMAP
    A17 (MoE decode); now they take the KV ring of ``attn`` (2S slots, the
    JAX package's ``init_kv_cache``) and the RG-LRU block takes one from an
    empty dict, as the JAX package's does (a prefill from h = 0 that
    returns its state).  A prefill, then a decode step, each within 1e-5 of
    the JAX package's in float32, every MoE call routing every token alike
    (the decode step's B tokens as one group at capacity 1)."""
    if kind == "rglru":
        assert max(_cached_block_steps(arch, kind, {}, {})) < 1e-5
        return
    jcfg, cfg = _configs(arch, "float32")
    with recorded_routes(monkeypatch) as (port, ref):
        errs = _cached_block_steps(
            arch, kind, JL.init_kv_cache(jcfg, B, 2 * S),
            T.init_block_cache(cfg, kind, B, 2 * S, device="cpu"))
    assert max(errs) < 1e-5
    assert len(port) == len(ref) == 2
    for got, want in zip(port, ref):
        ra = L.routing_agreement([got], [want])
        assert ra.flips == 0 and bool(ra.agree.all()), ra
    assert port[1][1].shape == (1, B, cfg.moe_top_k)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "recurrentgemma-9b"])
def test_params_from_jax_keeps_the_float32_router_and_lam_of_a_bf16_model(
        arch):
    """bf16 leaves (numpy's ml_dtypes bf16) carry over bit for bit, and the
    MoE router and the RG-LRU's lam stay float32 in a bf16 model."""
    jcfg, cfg = _configs(arch, "bfloat16", param_dtype="bfloat16")
    jp, tp = _params(jcfg, cfg)
    layer = tp["stack"]["layers"][0]
    slot = jax.tree.map(lambda a: a[0], jp["stack"]["groups"][0])
    name, f32 = (("moe", "router") if "moe" in layer else ("rglru", "lam"))
    assert layer[name][f32].dtype == torch.float32
    for key, t in layer[name].items():
        want = np.asarray(slot[name][key]).astype(np.float32)
        assert t.dtype == (torch.float32 if key == f32 else torch.bfloat16)
        np.testing.assert_array_equal(t.float().numpy(), want)
    assert tp["embed"].dtype == torch.bfloat16


def test_cache_and_decode_are_not_ported_yet():
    """Named for the time they raised; now the attention block's KV cache
    and decode: a prefill into an empty ring of 2S slots (the JAX package's
    ``init_kv_cache``), then a decode step that attends over it, within
    1e-5 of the JAX package's in float32, ``pos`` ``==``."""
    jcfg, cfg = _configs("qwen2-1.5b", "float32")
    jcache = JL.init_kv_cache(jcfg, B, 2 * S)
    tcache = T.init_block_cache(cfg, "attn", B, 2 * S, device="cpu")
    assert tcache["pos"].dtype == torch.int64
    assert (tcache["pos"] == -1).all()
    assert max(_cached_block_steps("qwen2-1.5b", "attn", jcache,
                                   tcache)) < 1e-5


class _PeakBytes(torch.utils._python_dispatch.TorchDispatchMode):
    """The most bytes of storage that the ops inside the block held alive
    at once (each storage counted once, from its first op to its tensor's
    end)."""

    def __init__(self):
        super().__init__()
        self.live, self.peak, self.ptrs = 0, 0, set()

    def _free(self, ptr, n):
        self.ptrs.discard(ptr)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                ptr = t.untyped_storage().data_ptr()
                if ptr not in self.ptrs:
                    n = t.untyped_storage().nbytes()
                    self.ptrs.add(ptr)
                    self.live += n
                    self.peak = max(self.peak, self.live)
                    weakref.finalize(t, self._free, ptr, n)
        return out


def test_dense_init_holds_one_float32_draw():
    """A bf16 weight is drawn in float32, scaled and cast: at most the
    draw and the bf16 result alive at once (6 bytes an element), the values
    those of ``(randn * scale).to(bf16)``.  Scaling out of place held a
    second float32 copy (8 bytes an element): on the card, arctic-480b's
    init at 2 layers asked for 16.6 GiB more with 59.3 GiB allocated."""
    shape = (4, 96, 40)
    with _PeakBytes() as mode:
        got = L._dense_init(torch.Generator().manual_seed(5), shape,
                            torch.bfloat16)
    n = math.prod(shape)
    assert mode.peak <= 6 * n
    want = (torch.randn(shape, generator=torch.Generator().manual_seed(5))
            * (1.0 / math.sqrt(shape[-2]))).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_init_params_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ARCHS["mamba2-370m"].reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_params(torch.Generator(), cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="generator"):
        T.init_params(torch.Generator(), cfg, device="cuda")
