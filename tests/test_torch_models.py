"""The port's model stack on the CPU against the JAX package.

JAX parameters (``repro.models.transformer.init_params``) are carried over
with ``repro_torch.models.convert.params_from_jax``; then each block kind
(``attn`` of qwen2-1.5b and qwen3-14b, ``ssd`` of mamba2-370m, all reduced)
and the whole stack run in both packages on the same numpy inputs.  In
float32 compute the two agree to 1e-5 of the output's largest magnitude
(float32 sums in other orders): that is the check of the algorithm.

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
"""
from __future__ import annotations

import dataclasses

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
          ("mamba2-370m", "ssd")]
B, S = 2, 16  # the sizes of tests/test_simulator.py


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


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-370m", "qwen3-14b"])
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
def test_block_matches_jax(arch, kind, compute_dtype):
    jcfg, cfg = _configs(arch, compute_dtype)
    jp, tp = _params(jcfg, cfg)
    x = _hidden(cfg)
    jctx, tctx = _contexts()
    p_j = jax.tree.map(lambda a: a[0], jp["stack"]["groups"][0])
    want, _, _ = JT.apply_block(p_j, jcfg, kind,
                                jnp.asarray(x).astype(JL.cdt(jcfg)), jctx,
                                None)
    got, cache, _ = T.apply_block(tp["stack"]["layers"][0], cfg, kind,
                                  torch.from_numpy(x).to(L.cdt(cfg)), tctx,
                                  None)
    assert cache is None and got.dtype == getattr(torch, compute_dtype)
    assert _rel_err(got, want) < TOL[compute_dtype]


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-370m", "qwen3-14b"])
def test_stack_and_forward_match_jax(arch, compute_dtype):
    jcfg, cfg = _configs(arch, compute_dtype)
    jp, tp = _params(jcfg, cfg)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S))
    jctx, tctx = _contexts()
    jx = JT.embed_tokens(jp, jcfg, jnp.asarray(tokens, jnp.int32))
    tx = T.embed_tokens(tp, cfg, torch.from_numpy(tokens))
    want, _, _ = JT.apply_stack(jp["stack"], jcfg, jcfg.n_layers,
                                jcfg.pattern, jx, jctx, None)
    got, _, _ = T.apply_stack(tp["stack"], cfg, cfg.n_layers, cfg.pattern,
                              tx, tctx, None)
    assert _rel_err(got, want) < TOL_STACK[compute_dtype]
    hid_j, _, _ = JT.forward(jp, jcfg, jnp.asarray(tokens, jnp.int32), jctx)
    hid_t, _, _ = T.forward(tp, cfg, torch.from_numpy(tokens), tctx)
    assert _rel_err(hid_t, hid_j) < TOL_STACK[compute_dtype]
    logits_t = T.logits_last(tp, cfg, hid_t)
    logits_j = JT.logits_last(jp, jcfg, hid_j)
    assert logits_t.shape == (B, 1, cfg.vocab_size)
    assert _rel_err(logits_t, logits_j) < TOL_STACK[compute_dtype]


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


@pytest.mark.parametrize("arch,kind", [("qwen3-moe-30b-a3b", "moe"),
                                       ("recurrentgemma-9b", "rglru"),
                                       ("whisper-small", "dec_block")])
def test_unported_kinds_name_their_roadmap_item(arch, kind):
    cfg = ARCHS[arch].reduced()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.init_block(torch.Generator(), cfg, kind)


def test_cache_and_decode_are_not_ported_yet():
    cfg = ARCHS["qwen2-1.5b"].reduced()
    tp = T.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    _, tctx = _contexts()
    x = torch.zeros((B, S, cfg.d_model), dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.apply_block(tp["stack"]["layers"][0], cfg, "attn", x, tctx, {})
    decode = L.Ctx(mode="decode", positions=tctx.positions[:, :1])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.apply_block(tp["stack"]["layers"][0], cfg, "attn", x[:, :1], decode,
                      None)


def test_init_params_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ARCHS["mamba2-370m"].reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.init_params(torch.Generator(), cfg)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="generator"):
        T.init_params(torch.Generator(), cfg, device="cuda")
