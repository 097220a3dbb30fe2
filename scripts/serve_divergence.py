#!/usr/bin/env python
"""How far a served model's cached decode lies from its cache-free forward
on the card, beside how far two valid cache-free evaluations lie apart.

    python scripts/serve_divergence.py [qwen2-1.5b mamba2-370m ...]

Runs on one CUDA card, at ``chip_smoke.py``'s path 3 (SERVE: the same
weights from seed 0, prompts, padding and greedy tokens).  For each model
it prints, row by row over the served positions (each row held to its own
largest |logit|, as path 3's teacher-forced gate holds it):

* ``served``: the served logits (prefill, then each decode step) against
  the cache-free forward through the kernels over prompt + generated;
* the same with cuBLAS's reduced-precision reductions of bf16 products
  switched off (``allow_bf16_reduced_precision_reduction``);
* the same with the decode steps' attention weights kept in fp32 (the
  JAX package's decode, and the port's, round them to the type of v);
* ``floor``: that cache-free forward against the same forward with each
  kernel replaced by its plain version (flash attention with fp32 p, SSD
  and RG-LRU without the kernels' summation orders): how far apart two
  valid bf16 evaluations of the model lie.

Each line gives the largest row error, its 99th and 90th percentiles, and
the largest over the first and the last quarter of the decode steps.
"""
from __future__ import annotations

import contextlib
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def _spread(err: torch.Tensor) -> str:
    """err (B, n): row errors by position; t = 0 is the prefill."""
    flat = err.flatten().float()
    q = max(1, (err.shape[1] - 1) // 4)
    return (f"max {float(flat.max())!r}, p99 "
            f"{float(flat.quantile(0.99))!r}, p90 "
            f"{float(flat.quantile(0.90))!r}; first quarter of the steps "
            f"{float(err[:, 1:1 + q].max())!r}, last quarter "
            f"{float(err[:, -q:].max())!r}")


@contextlib.contextmanager
def fp32_decode_weights():
    """The decode steps' attention with its softmax weights and v in fp32,
    the output rounded once to v's type."""
    from repro_torch.models import layers as ML

    attend = ML._decode_attention

    def fp32(cfg, q, k, v, q_positions, kv_positions, window=None):
        return attend(cfg, q, k, v.float(), q_positions, kv_positions,
                      window).to(v.dtype)

    ML._decode_attention = fp32
    try:
        yield
    finally:
        ML._decode_attention = attend


def main(names: list[str]) -> int:
    import dataclasses

    from repro_torch import serving as SV
    from repro_torch.configs import ARCHS
    from repro_torch.models import transformer as MT

    if not torch.cuda.is_available():
        print("serve_divergence: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {cs._card_line()}; torch {torch.__version__}")
    for name in names or list(cs.SERVE):
        spec, traffic = cs.MODELS[name], cs.SERVE[name]
        cfg = dataclasses.replace(ARCHS[name], **spec.overrides)
        params = MT.init_params(torch.Generator(device=device).manual_seed(0),
                                cfg, device=device)
        prompts = cs.serve_prompts(traffic, cfg.vocab_size)
        toks = torch.from_numpy(SV.left_pad(prompts, traffic.batch)).to(device)
        S, n = toks.shape[1], traffic.max_new
        flag = torch.backends.cuda.matmul
        variants = [("as served", True, contextlib.nullcontext),
                    ("bf16 reduced-precision reductions off", False,
                     contextlib.nullcontext),
                    ("decode attention weights in fp32", True,
                     fp32_decode_weights)]
        for label, reduced, patch in variants:
            flag.allow_bf16_reduced_precision_reduction = reduced
            with patch():
                run = cs.serve_loop(params, cfg, toks, traffic, device)
            served, generated = run["served"], run["generated"]
            seq = torch.cat([toks, generated], dim=1)
            want = cs._logits_at(params, cfg, seq, S - 1, n)
            off = int((generated != want.argmax(-1)).sum())
            print(f"{name}: served vs forward, {label}: "
                  f"{_spread(cs._row_err(served, want))}; {off} of "
                  f"{generated.numel()} greedy tokens off the forward's "
                  f"argmax")
            if label == "as served":
                with cs.plain_kernels():
                    plain = cs._logits_at(params, cfg, seq, S - 1, n)
                print(f"{name}: floor, forward through the kernels vs "
                      f"through the plain versions: "
                      f"{_spread(cs._row_err(want, plain))}")
                del plain
            del run, served, want
        flag.allow_bf16_reduced_precision_reduction = True
        del params
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
