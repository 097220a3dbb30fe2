#!/usr/bin/env python
"""How far a bf16 MSL round trip lies from the float32 one, in each package,
beside how far the two packages' round trips lie apart.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/bf16_round_trip_spread.py [arch ...]

Runs on the CPU, at ``tests/test_torch_round_trip.py``'s setting: a model
reduced to four pattern groups (recurrentgemma-9b: 12 layers), B 2, S 16,
JAX key 0's weights carried over with ``params_from_jax``, the same tokens,
the same TR plan on a TPU-pod topology, ``ChainSimulator.round_trip`` in
both packages.  For the destination's hidden state and the gradient handed
back to the source (``grad_in``) it prints, each as the largest absolute
difference over the largest magnitude of the second operand:

* ``jax bf16 vs jax f32`` and ``port bf16 vs port f32``: each package's
  bf16 round trip against its own float32 one (bf16 rounding's spread);
* ``port bf16 vs jax bf16`` (what the round-trip test would compare) and
  ``port f32 vs jax f32`` (what it does compare, at 1e-5).
"""
from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.core as R
import repro_torch.core as C
from repro.configs import ARCHS as JAX_ARCHS
from repro.models import transformer as JT
from repro.msl.simulator import ChainSimulator as JaxChainSimulator
from repro.msl import group_profile as jax_group_profile
from repro_torch.configs import ARCHS
from repro_torch.models import convert
from repro_torch.msl import ChainSimulator, group_profile
from repro_torch.core.topology import tpu_pod_topology

B, S = 2, 16
DTYPES = ("float32", "bfloat16")


def _rel(got, want) -> float:
    got, want = (np.asarray(t, np.float64) for t in (got, want))
    return float(np.abs(got - want).max() / np.abs(want).max())


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _instance(pkg, cfg, gp, pod, arch):
    net = pod(n_groups=4, chips_per_group=8)
    nodes = sorted(net.nodes)
    prof = gp(cfg, seq_len=S, mode="train")
    req = pkg.ServiceChainRequest(arch, nodes[0], nodes[-1], B, pkg.TR)
    return pkg.ProblemInstance(net, prof, req, 2,
                               ((nodes[0],), (nodes[-1],)))


def round_trips(arch: str) -> dict:
    """(package, dtype) -> (hidden, grad_in) as float32 numpy arrays."""
    n = 4 * len(ARCHS[arch].pattern)
    tokens = np.random.default_rng(0).integers(
        0, ARCHS[arch].reduced(n_layers=n).vocab_size, (B, S))
    jp = None
    out = {}
    for dtype in DTYPES:
        jcfg = JAX_ARCHS[arch].reduced(n_layers=n, compute_dtype=dtype)
        cfg = ARCHS[arch].reduced(n_layers=n, compute_dtype=dtype)
        if jp is None:
            jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
        tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), cfg,
                                     "cpu")
        ref = _instance(R, jcfg, jax_group_profile, R.tpu_pod_topology, arch)
        inst = _instance(C, cfg, group_profile, tpu_pod_topology, arch)
        plan = R.solve(ref, "bcd").plan
        got_plan = C.solve(inst, "bcd_torch", device="cpu").plan
        want = JaxChainSimulator(jcfg, jp, ref.net, ref.profile,
                                 ref.request).round_trip(
            plan, jnp.asarray(tokens, jnp.int32))
        got = ChainSimulator(cfg, tp, inst.net, inst.profile,
                             inst.request).round_trip(
            got_plan, torch.from_numpy(tokens))
        out["jax", dtype] = (_np(want.hidden), _np(want.grad_in))
        out["port", dtype] = (_np(got.hidden), _np(got.grad_in))
    return out


def _lines(res, what: str, pick) -> None:
    p = {k: pick(v) for k, v in res.items()}
    print(f"  {what}: jax bf16 vs jax f32 "
          f"{_rel(p['jax', 'bfloat16'], p['jax', 'float32'])!r}; port bf16 "
          f"vs port f32 {_rel(p['port', 'bfloat16'], p['port', 'float32'])!r}"
          f"; port bf16 vs jax bf16 "
          f"{_rel(p['port', 'bfloat16'], p['jax', 'bfloat16'])!r}; port f32 "
          f"vs jax f32 {_rel(p['port', 'float32'], p['jax', 'float32'])!r}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("archs", nargs="*", default=["recurrentgemma-9b"])
    args = parser.parse_args()
    for arch in args.archs:
        print(f"{arch}, {4 * len(ARCHS[arch].pattern)} reduced layers, "
              f"B {B}, S {S}: the MSL round trip")
        res = round_trips(arch)
        _lines(res, "hidden", lambda v: v[0])
        _lines(res, "grad_in", lambda v: v[1])


if __name__ == "__main__":
    main()
