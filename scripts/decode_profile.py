#!/usr/bin/env python
"""Where a served model's decode step spends its time on the card.

    python scripts/decode_profile.py [qwen2-1.5b mamba2-370m ...]

Runs on one CUDA card, at ``chip_smoke.py``'s path 3 (SERVE: the same
weights from seed 0, prompts and padding).  For each model: the prefill,
5 warm-up greedy steps, then the median host time of a step over 20 (each
ends in the host reading its tokens, as the serving loop does), the same
for the model cut to its first pattern repetition and for the head alone
(``logits_last`` and the argmax), and one step under ``torch.profiler``:
its wall, the device's busy time and share, the launches, and the ops
with the most host time and the kernels with the most device time.
"""
from __future__ import annotations

import dataclasses
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def step_ms(fn, reps: int = 20) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main(names: list[str]) -> int:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import serving as SV
    from repro_torch.configs import ARCHS
    from repro_torch.models import transformer as MT

    if not torch.cuda.is_available():
        print("decode_profile: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {cs._card_line()}; torch {torch.__version__}")
    for name in names or list(cs.SERVE):
        spec, traffic = cs.MODELS[name], cs.SERVE[name]
        cfg = dataclasses.replace(ARCHS[name], **spec.overrides)
        params = MT.init_params(torch.Generator(device=device).manual_seed(0),
                                cfg, device=device)
        toks = torch.from_numpy(SV.left_pad(
            cs.serve_prompts(traffic, cfg.vocab_size), traffic.batch)).to(
            device)
        B, S = toks.shape
        n_cut = len(cfg.pattern)
        cut_cfg = dataclasses.replace(cfg, n_layers=n_cut)
        cut_params = dict(params, stack={
            "layers": params["stack"]["layers"][:n_cut]})
        for label, p, c in (("full", params, cfg),
                            (f"{n_cut} layers", cut_params, cut_cfg)):
            logits, cache = SV.prefill(p, c, toks, traffic.cache_len)
            state = {"cur": torch.argmax(logits[:, -1], dim=-1),
                     "cache": cache, "t": S}

            def step():
                pos = torch.full((B, 1), state["t"], device=device)
                out, state["cache"] = SV.decode_step(
                    p, c, state["cache"], state["cur"][:, None], pos)
                state["cur"] = torch.argmax(out[:, -1], dim=-1)
                state["cur"].tolist()
                state["t"] += 1

            for _ in range(5):
                step()
            ms = step_ms(step)
            hidden = torch.zeros((B, 1, cfg.d_model), dtype=getattr(
                torch, cfg.compute_dtype), device=device)
            head = step_ms(lambda: torch.argmax(MT.logits_last(
                p, c, hidden)[:, -1], dim=-1).tolist())
            print(f"{name}, {label}: a decode step (B {B}) {ms!r} ms, the "
                  f"head alone {head!r} ms (median of 20)")
            if label != "full":
                continue
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                step()
                wall = (time.perf_counter() - t0) * 1e6
            busy, kernels = 0.0, {}
            launches = 0
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    busy += e.time_range.elapsed_us()
                    kernels[e.name] = kernels.get(e.name, 0.0) + \
                        e.time_range.elapsed_us()
                    launches += 1
            print(f"{name}: one step under the profiler: wall {wall!r} us, "
                  f"device busy {busy!r} us (share {busy / wall!r}), "
                  f"{launches} device events")
            top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
            print(f"{name}: top device time: "
                  f"{[(k[:80], v) for k, v in top]}")
            host = sorted(prof.key_averages(),
                          key=lambda a: -a.self_cpu_time_total)[:15]
            print(f"{name}: top host self time (us, calls): "
                  f"{[(a.key, a.self_cpu_time_total, a.count) for a in host]}")
        del params, cut_params, cache, logits
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
