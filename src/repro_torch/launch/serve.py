"""Serving launcher: --arch <id>, batched generation over synthetic
prompts, as the JAX package's ``repro.launch.serve``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \\
      --requests 8 [--device cuda|cpu]

It runs on the card unless ``--device cpu`` is given; without a card it
exits 2.  Configs with cross-attention raise: ``ServingEngine.generate``
passes no memory, as the JAX package's does not.  ``--reduced`` is ``cfg.reduced()``, as the
training launcher's.
"""
from __future__ import annotations

import argparse
import sys
import time


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..configs import get_config
    from ..core.torch_solvers import resolve_device
    from ..models import transformer as T
    from ..serving import ServingEngine

    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        ap.error(f"{exc} (--device cpu)")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if T.has_cross(cfg):
        raise ValueError(f"{cfg.name} attends to a memory, which "
                         f"ServingEngine.generate does not take, as the JAX "
                         f"package's does not")
    params = T.init_params(torch.Generator(device=device).manual_seed(0), cfg,
                           device=device)
    engine = ServingEngine(cfg, params, batch_size=args.batch,
                           cache_len=args.cache_len, device=device)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(rng.integers(4, 32)))
               .astype(np.int32) for _ in range(args.requests)]
    t0 = time.time()
    outs = engine.generate(prompts, max_new=args.max_new)
    dt = time.time() - t0
    n_tok = sum(len(o) for o in outs)
    print(f"{args.requests} requests -> {n_tok} tokens in {dt:.2f}s "
          f"({n_tok/dt:.1f} tok/s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
