"""Fake, sharded stand-ins for every argument of a dry-run cell's step, and
the step functions, the JAX package's ``launch/specs.py``.

:func:`input_specs` runs inside a ``FakeTensorMode``: the parameters are
drawn at full size as fake tensors (no memory), then laid out as DTensors
by the rules, as are the optimizer state, the batch and the caches.  The
steps:

* train: ``make_train_step(cfg, opt)`` on (parameters, optimizer state,
  batch of tokens and targets, with ``memory`` for cross configs);
* prefill: ``serving.prefill`` on (parameters, tokens (and ``memory``),
  the empty cache it fills);
* decode: one ``serving.decode_step`` and its argmax on (parameters,
  cache, tokens, positions).

Tokens, targets and positions are int64, PyTorch's index type, as the
port's data pipeline and serving loop give them.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..models import transformer as T
from ..models.layers import cdt
from ..models.sharding import MeshRules, is_dtensor, kept, param_specs
from ..optim import make_optimizer
from ..serving.engine import decode_step, prefill
from ..train.steps import make_train_step
from . import shardings as SH


def params_structs(cfg: ModelConfig, rules: MeshRules):
    """The full-size parameters of ``cfg`` (drawn from seed 0), as fake
    DTensors laid out by the rules, and their global fake tensors."""
    gen = torch.Generator().manual_seed(0)
    shapes = T.init_params(gen, cfg, device="cpu")
    return SH.to_structs(shapes, param_specs(shapes, rules),
                         rules.mesh), shapes


def _tokens(rules: MeshRules, B: int, S: int):
    return SH.to_structs(torch.zeros((B, S), dtype=torch.int64),
                         SH.batch_sharding(rules, 2, B), rules.mesh)


def _memory(cfg: ModelConfig, rules: MeshRules, B: int, dtype):
    return SH.to_structs(torch.zeros((B, cfg.memory_len, cfg.d_model),
                                     dtype=dtype),
                         SH.batch_sharding(rules, 3, B), rules.mesh)


def _cache(cfg: ModelConfig, rules: MeshRules, B: int, S: int):
    shapes = T.init_cache(cfg, B, S, device="cpu")
    return SH.to_structs(shapes, SH.cache_shardings(shapes, rules, B),
                         rules.mesh)


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                rules: MeshRules) -> dict:
    """All arguments of the step this cell runs, as fake sharded DTensors:
    ``{"fn": step, "args": tuple}``."""
    params, shapes = params_structs(cfg, rules)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        opt = make_optimizer(cfg.optimizer)
        state = opt.init(shapes, cfg)
        state = SH.to_structs(state, SH.opt_state_shardings(state, shapes,
                                                            rules),
                              rules.mesh)
        batch = {"tokens": _tokens(rules, B, S),
                 "targets": _tokens(rules, B, S)}
        if cfg.memory_len:
            batch["memory"] = _memory(cfg, rules, B, torch.float32)
        return {"fn": make_train_step(cfg, opt),
                "args": (params, state, batch)}

    if shape.kind == "prefill":
        batch = {"tokens": _tokens(rules, B, S)}
        if cfg.memory_len:
            batch["memory"] = _memory(cfg, rules, B, torch.float32)

        def prefill_step(params, batch, cache):
            return prefill(params, cfg, batch["tokens"], cache_len=S,
                           memory=batch.get("memory"), cache=cache)

        return {"fn": prefill_step,
                "args": (params, batch, _cache(cfg, rules, B, S))}

    # decode: one new token against a cache of seq_len
    cache = {"stack": _cache(cfg, rules, B, S)}
    if cfg.memory_len:
        cache["enc_memory"] = _memory(cfg, rules, B, cdt(cfg))
    tokens = _tokens(rules, B, 1)
    positions = _tokens(rules, B, 1)

    def serve_step(params, cache, tokens, positions):
        logits, new_cache = decode_step(params, cfg, cache, tokens,
                                        positions)
        last = logits[:, -1]
        if is_dtensor(last):  # the argmax over the whole vocab of a row
            last = last.redistribute(rules.mesh, kept(last, (0,)))
        return torch.argmax(last, dim=-1), new_cache

    return {"fn": serve_step, "args": (params, cache, tokens, positions)}
