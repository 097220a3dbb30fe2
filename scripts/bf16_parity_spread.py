#!/usr/bin/env python
"""How far apart bf16 evaluations of one model are: the port's stack against
the jitted JAX stack, beside the JAX stack run op by op against the same
jitted stack.  The bound of a bf16 stack in the port's tests
(tests/test_torch_models.py) rests on this spread.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/bf16_parity_spread.py

Runs on the CPU: reduced qwen2-1.5b and mamba2-370m at 2 and 4 layers,
B 2, S 32, JAX keys 0-2, the same weights (carried over with
``params_from_jax``) and tokens on both sides.  Each error is the largest
absolute difference over the largest magnitude of the jitted JAX output.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import ARCHS
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

B, S = 2, 32


def spread(arch: str, n_layers: int, key: int) -> tuple[float, float]:
    jcfg = JAX_ARCHS[arch].reduced(n_layers=n_layers)
    cfg = ARCHS[arch].reduced(n_layers=n_layers)
    jp = JT.init_params(jax.random.PRNGKey(key), jcfg)
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg, "cpu")
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (B, S))
    pos = np.broadcast_to(np.arange(S), (B, S))
    ctx = JL.Ctx(mode="prefill", positions=jnp.asarray(pos, jnp.int32))
    x = JT.embed_tokens(jp, jcfg, jnp.asarray(tokens, jnp.int32))

    def stack(params, h):
        return JT.apply_stack(params, jcfg, n_layers, jcfg.pattern, h, ctx,
                              None)[0]

    jitted = np.asarray(jax.jit(stack)(jp["stack"], x), np.float32)
    with jax.disable_jit():
        op_by_op = np.asarray(stack(jp["stack"], x), np.float32)
    port, _, _ = T.apply_stack(
        tp["stack"], cfg, n_layers, cfg.pattern,
        T.embed_tokens(tp, cfg, torch.from_numpy(tokens)),
        L.Ctx(mode="prefill", positions=torch.from_numpy(pos.copy())), None)
    scale = np.abs(jitted).max()
    return (float(np.abs(port.float().numpy() - jitted).max() / scale),
            float(np.abs(op_by_op - jitted).max() / scale))


def main() -> None:
    print("arch, layers, key: port vs jitted JAX, op-by-op JAX vs jitted JAX")
    for arch in ("mamba2-370m", "qwen2-1.5b"):
        rows = [(n, k, *spread(arch, n, k)) for n in (2, 4) for k in range(3)]
        for n, k, port, jax_self in rows:
            print(f"{arch}, {n}, {k}: {port:.4f}, {jax_self:.4f}")
        print(f"{arch}: largest {max(r[2] for r in rows):.4f}, "
              f"{max(r[3] for r in rows):.4f}")


if __name__ == "__main__":
    main()
