#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's six paths once on an NVIDIA GPU; check them.

    python3 chip_smoke.py        # from the repository root; needs one card

Path 1 is the batched planner: ``ProblemInstance`` ->
``repro_torch.core.solve_batch`` -> ``dfts_torch`` / ``bcd_torch`` on
``cuda`` -> ``Plan`` + ``LatencyBreakdown``, through the fused min-plus
scan kernel (one launch per scan; ``dfts_torch`` runs every instance's
tours in lockstep waves, one scan per (K, S) group of a wave).
Path 2 is plan execution: ``repro_torch.msl.plan_pipeline`` (``bcd_torch``
on ``cuda``, the scan kernel again) -> ``ChainSimulator.run_plan``,
which runs four models at full width and full depth with random weights
from a seed, one after the other (MODELS):

* qwen2-1.5b, B 2 x S 2048, every block through the flash-attention kernel;
* mamba2-370m, B 2 x S 2048, every block through the SSD kernel;
* qwen3-moe-30b-a3b, B 2 x S 2048, every block through flash attention and
  three launches of the expert-matmul kernel.  Its one change from the
  published config: the weights are stored in bf16 (61.1 GB; 122 GB in
  float32 fits no card), which the bf16 compute rounds them to at every use
  anyway; the router stays float32;
* recurrentgemma-9b, B 1 x S 4096 (so that the 2048-token window of its
  local attention cuts keys), its ``rglru`` blocks through the RG-LRU kernel
  and its ``local_attn`` blocks through flash attention at head width 256.

Path 3 is serving, inside the turns of qwen2-1.5b, mamba2-370m and
recurrentgemma-9b on the same weights (SERVE; MoE decode is not ported):
``repro_torch.serving.prefill`` of left-padded prompts through the flash,
SSD and RG-LRU kernels, then greedy ``decode_step``s in plain PyTorch over
the KV rings and the SSD and RG-LRU states, then ``ServingEngine.generate``
on the same prompts.

Path 4 is training, inside the turns of qwen2-1.5b and mamba2-370m after
path 3, on the same weights (float32, bf16 compute; TRAIN):
``plan_pipeline(mode="TR")`` and ``ChainSimulator.round_trip`` (each stage
forward under autograd, then the backward wave in reverse chain order)
at B 2 x S 2048 and full depth, then four steps of
``repro_torch.train.make_train_step`` with AdamW on ``SyntheticLM``
batches, through the forward kernels and the backward kernels of flash
attention and SSD (``csrc/flash_attention_bwd.cu``, ``csrc/ssd_bwd.cu``).

Path 5 is the serving control plane, right after path 1 on the same card:
``repro_torch.serve``'s ``ServePlanner.admit``, ``ServeGateway.run_stream``
and ``ServeSim.run`` on NSFNET x ResNet-101, planning through
``dfts_torch`` / ``bcd_torch`` on ``cuda`` (presolve waves and replans,
the scan kernel again), each fleet held ``==`` against the same fleet
planned by the NumPy oracles on the host (``_stack_runs``).

Path 6 is the sweep engine, right after path 5: ``repro_torch.sweep``'s
``SweepRunner`` on ``cuda`` over the ``nsfnet_paper`` grid at full width
(ResNet-101's 37 layer groups on the 14-node NSFNET, K 2-7, b 1-256, both
modes, SWEEP_SEEDS of the paper's 10 candidate seeds) with ``exact`` and
``bcd_torch``, whose instances its batched presolve solves on the card,
then the quick tiers of ``nsfnet_gateway`` and ``nsfnet_mixed_training``
through the serve classes with ``bcd_torch`` on the card, each suite held
``==`` against the same suite with the host ``bcd`` (``run_sweep_path``).

Phases, in order; any failure exits non-zero:

1. device: a CUDA card is required; its name and power limit are printed;
   TF32 is switched off for float32 products and convolutions;
2. build: every kernel is built from the sources in the checkout, one
   ``nvcc`` per source, all started together (sm_90a, ``build/kernels/``);
3. kernel vs plain, generic: the min-plus product (``minplus_matmul``, no
   longer launched on a path) held with ``==`` against its plain version
   (ties, +inf holes, off-tile shapes, EXTRA_SHAPE); flash attention in bf16 at FLASH_TOL, SSD in float32 at
   SSD_TOL, the expert matmul in bf16 at GMM_TOL and the RG-LRU scan at
   RGLRU_TOL, at ``tests/test_kernels.py``'s shapes and a few more; the
   backward kernels against autograd through the plain versions, flash at
   FLASH_BWD_TOL on FLASH_GENERIC and SSD at SSD_BWD_TOL on SSD_GENERIC,
   each twice with the same bits;
4. path 1: the 96-instance population of the solver benchmark (NSFNET,
   ResNet-101 at its full 37 layer groups) through ``dfts_torch`` (distinct,
   then cycled to 1024) and ``bcd_torch``, every outcome ``==`` the port's
   NumPy oracles, with the scans and scan launches of each call over
   exactly this run (each scan one launch) and every scan's shape and first
   operands recorded; the warm 1024-instance pass's instances/s against
   ``dfts_np``, its scans (at most MAX_WARM_SCANS), its wall, device busy
   time and idle share under the profiler, and its host split (encode,
   capped-tour build, scan with its copies, decode, and the rest);
   then path 5 (``run_serve_stack_path``): the scan count set to 0, every
   fleet of ``_stack_runs`` through its entry class twice, with the card
   solver and with its oracle, the served records, summaries, timelines
   and per-tick counts ``==`` (STACK_UNCOMPARED aside), the card's traces
   replayed by ``replay_verify`` / ``replay_verify_sim``, each card run's
   scans and scan launches equal and not 0, each scan's shape and first
   operands recorded; each run's wall, presolve seconds beside the
   oracle's, instances presolved, plan-cache hit rate, ticks and admitted
   share printed, and the card's busy time and idle share over the gated
   card run of the longest fleet, which runs under the profiler;
   then path 6 (``run_sweep_path``): the scan count set to 0, each suite
   through ``SweepRunner(workers=0, device="cuda")`` and again with the
   host ``bcd`` on the CPU, the results, the comparison report and the
   CSV rows ``==`` (``sweep_view``: SWEEP_UNCOMPARED aside, ``bcd_torch``
   and its scenario ids mapped to ``bcd``'s), every card result passing
   ``verify_result`` with no errors, every spec the batched presolve
   takes in a map it returned (``presolved_maps``), each suite's scans
   and scan launches equal and not 0, each scan's shape and first
   operands recorded, each suite's artifact written and reloaded ``==``;
   each suite's wall and presolve seconds beside the host's, the BCD gap
   against ``exact`` beside the card, the first seed's presolve again
   under the profiler (busy time and idle share), a spawned worker's
   start-up, and four of the specs through SWEEP_WORKERS spawned workers
   ``==`` the serial run;
5. path 2, one model after the other: the counts set to 0, the plan and the
   planned chain run on the card, the counts read (the scan and each of the
   model's kernels must have launched), every kernel call's shape and first
   operands recorded; the chain's hidden state ``==`` the port's monolithic
   ``apply_stack`` on the card (the same blocks in the same order); the
   first two groups at S 512 on the card (kernels) within CHECK_TOL of
   their largest magnitude of the same groups on the CPU (plain versions),
   in bf16; route-aware for MoE: every expert pick of the card that the
   CPU's router would not make must be a near tie there, the tokens of
   each sequence before its first token that routes otherwise are held to
   the CPU's own run, and every token to a second CPU run that replays the
   card's expert picks (whose buffer places and drops must be ``==`` the
   card's); each stage's measured compute printed beside the planner's
   prediction; then path 3 where the model serves (``run_serve_path``):
   the counts set to 0, prefill and decode, the counts read (the model's
   kernels must have launched in the prefill), the prefill's logits
   within CHECK_TOL of a cache-free forward on the card; teacher-forced,
   every decode step's within CHECK_TOL of a cache-free forward over
   prompt + generated at SERVE_CHECK_DEPTH pattern repetitions (each
   greedy token that forward's argmax or a near tie) and, at full depth,
   within FLOOR_FACTOR of the floor between that forward through the
   kernels and through the plain versions; ``generate``'s tokens ``==``
   the loop's, every logit finite; its
   prefill ms, decode ms a step (p50, p90), tokens/s, cache bytes and peak
   memory printed beside the card; then path 4 where the model trains
   (``run_train_path``): the round trip with the counts set to 0 just
   before and read just after (one forward and one backward launch a
   layer), its traces FW then BW, every charge ``==``
   ``segment_comp_dir_s`` and the evaluator's transfer in its direction,
   ``executed_round_trip_s`` within 1e-9 of ``evaluate_round_trip``,
   ``grad_in`` finite, each stage's measured FW and BW compute printed
   beside its charge; on the same weights, the first TRAIN_CHECK_DEPTH
   repetitions at S CHECK_SEQ, card (kernels) against CPU (plain
   versions): the round trip's ``grad_in`` and every parameter's gradient
   within CHECK_TOL; four train steps counted likewise (two forward
   launches a layer under remat and one backward a step), every loss and
   grad norm finite, the loss on ``batch_at(0)`` lower at step 3 than at
   step 1, the step's p50 ms over steps 2-4, tokens/s and peak memory
   printed; the model freed before the next;
6. the min-plus product timed at EXTRA_SHAPE; kernel vs plain at the
   shapes of paths 1-3, 5 and 6, on the recorded operands and random ones:
   the scan ``==`` its plain version at every shape paths 1, 2, 5 and 6
   gave it (recorded, random with +inf holes and an all-+inf tour,
   tie-forcing) and at SCAN_GENERIC (K 1 and 2, S past a warp), then each
   path shape timed as below; flash attention at FLASH_TOL, which must also
   reject two wrong
   outputs (l off by 5 %, each row's diagonal key tile dropped); SSD's y and
   chunk states, and the RG-LRU scan, on the recorded operands against a
   float64 witness, at SSD_WITNESS and RGLRU_WITNESS times the plain
   version's own error (random operands at SSD_TOL and RGLRU_TOL), and the
   SSD witness must also reject two wrong outputs (one head with its
   neighbour's dt and A, each query tile's diagonal score tile dropped); the
   expert matmul at GMM_TOL, which must also reject two wrong outputs (one
   GMM_TILE slice of D left out, one counted twice); then each shape timed
   by ``torch.profiler`` device time (a time on a held stream by CUDA
   events beside it, the clock used when the profiler loses events in
   every window) beside its plain version, its bound, the operations and
   bytes per second it achieved and its share of the bound (SSD's bound is
   its TF32 tensor-core work; the same work at the fp32 rate is printed
   beside it), and its library
   yardstick (``scaled_dot_product_attention`` for flash attention,
   ``torch.bmm`` with the activation for the expert matmul; SSD and RG-LRU
   have no single library call), with the SM clock, its maximum and the
   temperature sampled before and after the timings; the backward kernels
   likewise at path 4's shapes (recorded operands and random, flash's
   rejecting dK and dV without the sum over the G query heads and a dQ
   that ignores the causal mask, with the kernel's and the fp32 plain
   version's errors against the plain version in float64 printed beside
   its gate on the recorded operands, SSD's held to its float64 witness at
   SSD_BWD_WITNESS and rejecting ddt without its reverse-cumsum term and
   dA with its sign flipped), flash's yardstick the backward of
   ``scaled_dot_product_attention``;
7. one JSON line of per-kernel numbers, the card line, then the result line.
"""
from __future__ import annotations

import collections
import contextlib
import csv
import dataclasses
import importlib
import json
import math
import multiprocessing
import statistics
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
FP64_OPS_PER_S = 34e12      # H100 SXM fp64 outside the tensor cores (ditto)
FP32_OPS_PER_S = 67e12      # H100 SXM fp32 outside the tensor cores (ditto)
BF16_OPS_PER_S = 989e12     # H100 SXM dense bf16 tensor cores (ditto)
TF32_OPS_PER_S = 495e12     # H100 SXM dense TF32 tensor cores (ditto)
EXTRA_SHAPE = (1024, 1, 16, 16)  # (batch, M, K, N): a scan step at Sp = 16
# (N, K, S) of the fused scan off the paths: K 1 and 2, S 1 and S off a
# warp's tours (5, 7, 33), a full warp, a warp's operands past its stage in
# shared memory (K 8 at S 32), and past a warp (the block variant: 64, 100,
# 1500 at 1,024 threads a tour)
SCAN_GENERIC = [(1, 1, 4), (3, 1, 33), (7, 2, 1), (5, 2, 7), (33, 3, 5),
                (100, 3, 16), (9, 4, 32), (3, 8, 32), (2, 3, 100),
                (1024, 5, 64), (2, 2, 1500)]
MAX_WARM_SCANS = 20  # scans of the warm 1024-instance dfts_torch pass
RECORDED_OPERANDS = 3  # operand sets kept per shape of a kernel's calls
CHECK_SEQ = 512        # path 2: sequence of the card-vs-CPU check
# Flash attention, bf16: the kernel rounds p to bf16 before P.V (as the
# JAX model's blocked_attention does) where the plain version keeps it
# fp32, and both round fp32 sums taken in other orders once to bf16, so
# they differ by about 2^-9 of a row and by an ulp of bf16 in a few
# elements (worst row 4.9e-3 of its norm on an H100; 2.2e-3 with fp32 p).
# Held per (batch, query, head) row of width hd, scaled to the
# row: ||got - want|| / ||want|| below FLASH_TOL[0], and max |got - want|
# at most FLASH_TOL[1] * max |want| over the whole output.
FLASH_TOL = (1e-2, 2.0 ** -6)
FLASH_TILE = 64  # keys per tile of csrc/flash_attention.cu (BK)
SSD_TOL = (1e-4, 1e-4, 1e-5)  # y, chunk states, decay (tests/test_kernels.py)
# SSD on the path's recorded operands: y and the chunk states are held to
# their float64 values; over each output the kernel's largest error there
# may be SSD_WITNESS times the plain version's own (or eps of the largest
# value, where the plain version is exact).  The decay stays at SSD_TOL[2].
SSD_WITNESS = 4.0
SSD_TILE = 64  # query and key rows of a score tile of csrc/ssd.cu (T)
# TF32 tensor-core products the SSD kernel does for each fp32 product
# (csrc/ssd.cu's wgmma3: lo.hi, hi.lo, hi.hi)
SSD_TF32_PASSES = 3
FP32_EPS = 2.0 ** -23
# Expert matmul, bf16: both sides sum exact products in fp32 (in other
# orders: the kernel's wgmma sums 64-deep stages, the plain version's
# einsum its own blocks) and apply the activation in fp32 (the kernel with
# a fast exponential and division, a few fp32 ulps), then round once to
# bf16, so they differ by an ulp of bf16 in a few elements: elementwise
# within GMM_TOL of |want| plus GMM_TOL of max |want|.
GMM_TOL = 2.0 ** -7
GMM_TILE = 64  # depth of one ring stage of csrc/moe_gmm.cu (BK)
# RG-LRU, float32: the kernel's sequential chunks and the plain version's
# doubling scan round the same recurrence in other orders: max |got - want|
# at most RGLRU_TOL of max |want| (tests/test_kernels.py's 1e-5).  On the
# path's recorded operands both are held to the float64 witness: the
# kernel's largest error at most RGLRU_WITNESS times the plain version's
# (or eps of the largest value, where the plain version is exact).
RGLRU_TOL = 1e-5
RGLRU_WITNESS = 4.0
CHECK_TOL = 2e-2  # path 2, card vs CPU, first two groups: of the largest
#                   magnitude (PERF.md gives the readings it was set from)
# The backward kernels against autograd through their plain versions.
# Flash attention, bf16: the kernel sums in fp32 and rounds each gradient
# once to bf16, where the plain version keeps them fp32: each of dQ, dK and
# dV within FLASH_BWD_TOL of its largest magnitude.  SSD, float32 (3xTF32
# products summed in other orders): each of dx, dB, dC, ddt and dA within
# SSD_BWD_TOL of its largest magnitude on random operands; on the path's
# recorded operands, as the forward's, each held to its float64 value
# instead, the kernel's largest error at most SSD_BWD_WITNESS times the
# plain version's own (or eps of the largest value): there the plain
# version's own error of ddt exceeded SSD_BWD_TOL of its largest value
# (PERF.md).
FLASH_BWD_TOL = 2.0 ** -6
SSD_BWD_TOL = 1e-4
SSD_BWD_WITNESS = 4.0


class PathModel(NamedTuple):
    """One model of path 2: the kernels its blocks run, its batch and
    sequence, and its changes from the published config."""
    kernels: tuple[str, ...]
    batch: int
    seq: int
    overrides: dict = {}


# path 2, in this order
MODELS = {
    "qwen2-1.5b": PathModel(("flash_attention",), 2, 2048),
    "mamba2-370m": PathModel(("ssd",), 2, 2048),
    "qwen3-moe-30b-a3b": PathModel(("flash_attention", "moe_gmm"), 2, 2048,
                                   {"param_dtype": "bfloat16"}),
    "recurrentgemma-9b": PathModel(("flash_attention", "rglru"), 1, 4096),
}


class ServeTraffic(NamedTuple):
    """Path 3's traffic for one model: ``batch`` prompts of lengths drawn
    from [shortest, longest], the first of the longest, each decoding
    ``max_new`` greedy tokens into caches of ``cache_len``."""
    batch: int
    shortest: int
    longest: int
    max_new: int
    cache_len: int


# path 3, inside its model's turn of path 2 (MoE decode is ROADMAP A17):
# qwen2 fills a KV cache of 0.5 GB; mamba2's prompts are 7 SSD chunks and
# its teacher-forced forward 8; recurrentgemma's 2048-slot local ring wraps
# at every decode step
SERVE = {
    "qwen2-1.5b": ServeTraffic(8, 256, 2048, 128, 2176),
    "mamba2-370m": ServeTraffic(8, 256, 1792, 256, 2048),
    "recurrentgemma-9b": ServeTraffic(1, 4096, 4096, 64, 4160),
}
# path 3's teacher-forced check at CHECK_TOL runs on the first
# SERVE_CHECK_DEPTH pattern repetitions (path 2's card-vs-CPU check takes as
# many).  At full depth the models amplify bf16 rounding past CHECK_TOL: the
# same cache-free forward through the kernels and through their plain
# versions lay 0.0235 (qwen2-1.5b), 0.309 (mamba2-370m) and 0.0086
# (recurrentgemma-9b) of a row's largest |logit| apart on an H100
# (scripts/serve_divergence.py, PERF.md), so there the served logits are
# held to FLOOR_FACTOR times that floor, measured in the same run: a bound
# on gross faults only.
SERVE_CHECK_DEPTH = 2
FLOOR_FACTOR = 2.0


class TrainTraffic(NamedTuple):
    """Path 4's work for one model: the round trip and ``steps`` train
    steps on batches of ``batch`` x ``seq`` tokens, through the forward
    and backward kernels named."""
    batch: int
    seq: int
    steps: int
    kernels: tuple[str, str]  # (forward, backward)


# path 4, inside its model's turn after path 3 (the train step updates the
# weights in place); the learning rate is the reference's default
TRAIN = {
    "qwen2-1.5b": TrainTraffic(2, 2048, 4, ("flash_attention",
                                            "flash_attention_bwd")),
    "mamba2-370m": TrainTraffic(2, 2048, 4, ("ssd", "ssd_bwd")),
}
TRAIN_LR = 3e-4
TRAIN_CHECK_DEPTH = SERVE_CHECK_DEPTH  # repetitions of the card-vs-CPU
#                                        gradients, as paths 2 and 3 check
# (B, Sq, Skv, Hq, Hkv, hd, causal, window, softcap): tests/test_kernels.py's
# cases, rows that see no key, and randomised GQA shapes
FLASH_GENERIC = [
    (2, 128, 128, 4, 2, 64, True, None, None),
    (1, 200, 200, 8, 1, 64, True, None, 50.0),
    (2, 256, 256, 4, 4, 128, True, 64, None),
    (1, 64, 256, 2, 2, 64, False, None, None),
    (1, 96, 96, 6, 3, 32, True, 32, 30.0),
    (1, 48, 16, 2, 1, 32, False, 8, None),
    (1, 37, 37, 8, 2, 128, True, None, None),
    (1, 130, 130, 4, 4, 32, True, None, None),
    (3, 70, 70, 2, 1, 64, False, None, None),
    (1, 200, 200, 4, 1, 256, True, None, None),
    (1, 300, 300, 4, 2, 256, True, 128, None),
    (2, 96, 96, 2, 1, 256, False, 40, 30.0),
]
# (B, S, H, P, N, Q): tests/test_kernels.py's cases, head width 16, a ragged
# Q, 5 heads (one past the kernel's group of 4), N off a multiple of 4, and
# a ragged chunk too long for the scans to stay in shared memory
SSD_GENERIC = [(2, 128, 4, 32, 16, 32), (1, 256, 2, 64, 128, 64),
               (2, 64, 3, 16, 16, 16), (1, 100, 2, 16, 8, 100),
               (1, 512, 5, 64, 128, 256), (1, 128, 2, 32, 10, 64),
               (1, 1000, 5, 64, 128, 500)]
# (E, C, D, F, activation): tests/test_kernels.py's cases, a ragged D and F
# (the wrapper pads them to multiples of 8), one row tile short of the MoE
# path's C, C 1 with D below one stage, and E 1 with C off the 128-row tile
GMM_GENERIC = [(4, 64, 96, 80, "none"), (2, 128, 256, 128, "silu"),
               (8, 40, 72, 200, "gelu"), (3, 70, 50, 33, "silu"),
               (2, 256, 2048, 768, "none"), (3, 1, 40, 24, "gelu"),
               (1, 200, 136, 100, "silu")]
# (B, S, W): tests/test_kernels.py's cases, one step, a chunk and a half
RGLRU_GENERIC = [(2, 64, 128), (1, 100, 48), (3, 256, 512), (2, 1, 300),
                 (1, 192, 1000)]


def _smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def _card_line() -> str:
    return _smi("name,power.limit")


def _clocks_line() -> str:
    """The SM clock, its maximum and the temperature, as nvidia-smi reads
    them now."""
    return _smi("clocks.sm,clocks.max.sm,temperature.gpu")


def _costs(gen, shape, device, *, ties=False, p_inf=0.2):
    """Cost-like float64 matrices on the card: non-negative values (small
    integers when ``ties``, so that many sums tie) with +inf holes."""
    if ties:
        x = torch.randint(0, 3, shape, generator=gen).double()
    else:
        x = torch.rand(shape, generator=gen, dtype=torch.float64) * 10.0
    x[torch.rand(shape, generator=gen) < p_inf] = float("inf")
    return x.to(device)


PAD_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel
PAD_LAUNCHES = 4
# profiler windows a timing may take: even between PAD_KERNEL launches the
# profiler lost 2 of 300 device events in one window on an H100
PROFILE_WINDOWS = 3
# PAD_KERNEL cycles that hold the stream while the host enqueues the calls
# of a held-queue timing (_held_queue_ms); about 10 ms at the H100's clock,
# four times more on each of HOLD_TRIES tries when the host is slower
HOLD_CYCLES = 20_000_000
HOLD_TRIES = 3
# launches a held-queue timing may queue behind its hold: a stream's queue
# holds about a thousand, and past it the host waits for the card, so the
# hold ends before the last call is enqueued (on an H100, 20 calls of the
# RG-LRU plain version, 1,200 launches, outlasted every hold)
HELD_LAUNCHES = 512


def _pad() -> None:
    """PAD_LAUNCHES short launches of PAD_KERNEL, then a synchronise."""
    for _ in range(PAD_LAUNCHES):
        torch.cuda._sleep(1)
    torch.cuda.synchronize()


def _device_events(fn) -> tuple[float, dict, collections.Counter]:
    """Run ``fn`` once under ``torch.profiler``: (wall us, device us by
    kernel name, device events by kernel name).  The profiler can miss the
    device events at the edges of its window (on an H100 it recorded 18 of
    20 launches of one kernel, each time), so ``fn`` runs between two runs
    of PAD_KERNEL launches, which are left out of the counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _pad()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e6
        _pad()
    by_name: dict = {}
    count: collections.Counter = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and PAD_KERNEL not in e.name:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
            count[e.name] += 1
    return wall, by_name, count


def _device_us(fn) -> tuple[float, float, dict]:
    """Run ``fn`` once under ``torch.profiler``: (wall us, device us summed
    over every kernel and copy, device us by kernel name)."""
    wall, by_name, _ = _device_events(fn)
    return wall, sum(by_name.values()), by_name


def _time_ms(fn, reps=21, inner=50) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back calls,
    by CUDA events, after a warm-up.  When the host takes longer per call
    than the card, this is the time per call the caller sees."""
    for _ in range(5):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _pin_argmin(device) -> None:
    inf = float("inf")
    x = torch.tensor([[2.0, 1.0, 1.0, 3.0], [inf, inf, inf, inf],
                      [5.0, inf, 5.0, 4.0]], dtype=torch.float64,
                     device=device)
    if x.argmin(dim=1).tolist() != [1, 0, 3]:
        raise AssertionError("torch.argmin on cuda is not first-occurrence")


def _compare(mp, pairs) -> tuple[int, int, float]:
    """(cases, mismatches, max_abs_err) of the kernel against its plain
    version on each ``(a, b)`` pair, ``val`` and ``idx`` compared by ==."""
    mismatches, max_err = 0, 0.0
    for a, b in pairs:
        val, idx = mp.minplus_matmul(a, b)
        rval, ridx = mp.minplus_reference(a, b)
        torch.cuda.synchronize()
        if not (torch.equal(val, rval) and torch.equal(idx, ridx)):
            mismatches += 1
        fin = torch.isfinite(rval)
        if fin.any():
            max_err = max(max_err, float((val[fin] - rval[fin]).abs().max()))
    return len(pairs), mismatches, max_err


def _random_pairs(gen, shape, device) -> list:
    """Random costs and tie-forcing small integers at ``(batch, M, K, N)``,
    each with +inf holes and, where M > 1, an all-+inf row."""
    batch, m, k, n = shape
    out = []
    for ties in (False, True):
        a = _costs(gen, batch + (m, k), device, ties=ties)
        b = _costs(gen, batch + (k, n), device, ties=ties)
        if m > 1:
            a[..., 0, :] = float("inf")
        out.append((a, b))
    return out


def check_minplus_matmul(mp, device) -> dict:
    """Phase 3 for the min-plus product: the tie rule of torch's own argmin
    pinned on the card, then ``==`` against the plain version at shapes off
    any tile of 256 threads and at EXTRA_SHAPE.  Since the fused scan no
    path launches it; its kernels-line entry says so, with the paths'
    launches and its times at EXTRA_SHAPE (:func:`time_minplus_matmul`)
    filled in later."""
    _pin_argmin(device)
    gen = torch.Generator().manual_seed(0)
    sizes = (1, 3, 16, 17, 33)
    extra = ((EXTRA_SHAPE[0],),) + EXTRA_SHAPE[1:]
    pairs = [p for batch in [(), (3,), (2, 2)] for m in sizes for k in sizes
             for n in sizes for p in _random_pairs(gen, (batch, m, k, n),
                                                   device)]
    pairs += _random_pairs(gen, extra, device)
    n, mismatches, max_err = _compare(mp, pairs)
    if mismatches:
        raise AssertionError(f"minplus kernel disagrees with its plain "
                             f"version in {mismatches} of {n} generic cases")
    print(f"minplus_matmul generic: {n} cases == plain version (EXTRA_SHAPE "
          f"{EXTRA_SHAPE} among them), max_abs_err {max_err!r}")
    return {"name": "minplus", "route": "cuda",
            "source": KERNELS["minplus"].source,
            "replaces": KERNELS["minplus"].replaces,
            "max_abs_err": max_err, "mismatches": mismatches,
            "shape": [list(extra[0]), *extra[1:]], "library_ms": None,
            "note": "minplus_matmul: no path launches it since the fused "
                    "scan (minplus_scan); timed at EXTRA_SHAPE"}


def time_minplus_matmul(mp, device, row: dict) -> None:
    """The min-plus product timed at EXTRA_SHAPE, into its ``row``."""
    extra = ((EXTRA_SHAPE[0],),) + EXTRA_SHAPE[1:]
    a, b = _random_pairs(torch.Generator().manual_seed(4), extra, device)[0]
    ms = _kernel_device_ms(lambda: mp.minplus_matmul(a, b), 200,
                           "minplus_kernel")
    plain = _kernel_device_ms(lambda: mp.minplus_reference(a, b), 200, None)
    held = _held_queue_ms(lambda: mp.minplus_matmul(a, b), 200)
    bound, by, n_bytes = _bound_ms(extra)
    print(f"minplus_matmul {extra} float64 (off the paths): device time per "
          f"launch (torch.profiler) kernel {ms!r} ms, plain {plain!r} ms; "
          f"kernel on a held stream (CUDA events) {held!r} ms; bound "
          f"{bound!r} ms by {by} ({n_bytes} B at 3.35 TB/s)")
    row.update(ms=ms, plain_ms=plain, held_ms=held, bound_ms=bound,
               bound_by=by)


def _held_queue_ms(fn, calls) -> float:
    """Device time per call of ``fn`` by CUDA events: one long PAD_KERNEL
    holds the stream while the host enqueues ``calls`` calls between two
    events, so the events bracket the card's work alone, back to back (the
    card's own gaps between launches included, the host's time not).  The
    hold is checked: the first event must still be waiting when the last
    call is enqueued, else the hold is made four times longer, up to
    HOLD_TRIES tries, and then this raises."""
    for _ in range(3):
        fn()
    cycles = HOLD_CYCLES
    for _ in range(HOLD_TRIES):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        held = not start.query()
        end.synchronize()
        if held:
            return start.elapsed_time(end) / calls
        cycles *= 4
    raise AssertionError(f"the host took longer to enqueue {calls} calls "
                         f"than a hold of {cycles // 4} cycles")


def _kernel_device_ms(fn, calls, must_see: str | None) -> float:
    """Device time per call of ``fn`` under ``torch.profiler``, summed over
    every device kernel (or only those whose name holds ``must_see``).
    Every call launches the same kernels, so a window with no device event
    of them, or with a count that is no multiple of ``calls``, lost some
    (the profiler has done both on an H100), which would read as no time or
    a shorter time: such a window is timed again, up to PROFILE_WINDOWS
    times, and never read.  When every window lost events (on one H100
    run, all three windows of the min-plus kernel), the calls are timed by
    :func:`_held_queue_ms` instead, which counts every kernel of the calls
    and adds the card's gaps between launches (on an H100 about 1 us a
    launch); the line printed says so.  It times as many of the calls as
    keep the launches queued behind its hold within HELD_LAUNCHES, the
    launches of a call counted from the fullest window.  A ``must_see``
    that matches none of the kernels the windows saw raises, naming those
    of the last window."""
    what = must_see or "the plain version"
    matched = any_events = False
    most = 0  # the most events of ``what`` a window saw
    for _ in range(PROFILE_WINDOWS):
        _, by_name, count = _device_events(
            lambda: [fn() for _ in range(calls)])
        seen = [name for name in by_name
                if must_see is None or must_see in name]
        matched = matched or bool(seen)
        any_events = any_events or bool(by_name)
        us = sum(by_name[name] for name in seen)
        events = sum(count[name] for name in seen)
        most = max(most, events)
        if events and events % calls == 0 and us > 0.0:
            return us / calls / 1e3
        print(f"profiler: {events} device events of {what} over {calls} "
              f"calls, some lost: timed again")
    if any_events and not matched:
        raise AssertionError(f"no profiler window saw a device event of "
                             f"{what}; the last saw {sorted(by_name)}")
    per_call = max(1, -(-most // calls))
    held_calls = max(1, min(calls, HELD_LAUNCHES // per_call))
    ms = _held_queue_ms(fn, held_calls)
    print(f"profiler: device events of {what} lost in each of "
          f"{PROFILE_WINDOWS} windows: timed by CUDA events on a held "
          f"stream instead, {held_calls} calls of {per_call} launches, "
          f"{ms!r} ms per call")
    return ms


def _bound_ms(shape) -> tuple[float, str, int]:
    batch, m, k, n = shape
    nb = 1
    for d in batch:
        nb *= d
    n_bytes = 8 * nb * (m * k + k * n) + (8 + 4) * nb * m * n
    n_ops = 2 * nb * m * n * k  # one add and one compare per (b, m, n, k)
    byte_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    op_ms = n_ops / FP64_OPS_PER_S * 1e3
    return (max(byte_ms, op_ms), "bytes" if byte_ms >= op_ms else
            "operations", n_bytes)


def _scan_bound(key) -> tuple[float, str, int, int]:
    """The fused scan at (N, K, S): comp, D and tail read once, total,
    tail_src (int64) and srcs (int32) written once; an add and a compare
    per candidate of each step (S per output), an add of comp per output,
    and the tail's add and the last minimum's compare per candidate."""
    N, K, S = key
    n_bytes = (8 * N * (K * S + (K - 1) * S * S + S) + 16 * N
               + 4 * (K - 1) * N * S)
    n_ops = 2 * N * (K - 1) * S * S + N * (K - 1) * S + 2 * N * S
    byte_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    op_ms = n_ops / FP64_OPS_PER_S * 1e3
    return (max(byte_ms, op_ms), "bytes" if byte_ms >= op_ms else
            "operations", n_ops, n_bytes)


def _scan_cases(gen, key, device) -> list:
    """Operands of the fused scan at ``(N, K, S)``: random costs and
    tie-forcing small integers, each with +inf holes and, where N > 1, a
    first tour whose every candidate is +inf (total +inf, tail_src 0)."""
    N, K, S = key
    out = []
    for ties in (False, True):
        comp, D, tail = (_costs(gen, shape, device, ties=ties)
                         for shape in ((N, K, S), (N, K - 1, S, S), (N, S)))
        if N > 1:
            comp[0] = float("inf")
        out.append((comp, D, tail))
    return out


def _compare_scan(mp, cases) -> tuple[int, int, float]:
    """(cases, mismatches, max_abs_err) of the scan kernel against its
    plain version on each ``(comp, D, tail)``: all three outputs compared
    by ==, with their shapes and types."""
    mismatches, max_err = 0, 0.0
    for ops in cases:
        got = mp.minplus_scan(*ops)
        want = mp.minplus_scan_reference(*ops)
        torch.cuda.synchronize()
        mismatches += not all(
            g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)
            for g, w in zip(got, want))
        fin = torch.isfinite(want[0])
        if fin.any():
            max_err = max(max_err, float((got[0][fin] - want[0][fin]).abs()
                                         .max()))
    return len(cases), mismatches, max_err


def _top_shape(shapes) -> tuple:
    """The shape with the most launches (the smallest of equals)."""
    return min(shapes, key=lambda s: (-shapes[s], s))


def check_scan_path(mp, device, recorded, launches_by_path: dict,
                    headline: tuple) -> dict:
    """Phase 6 for the fused scan: ``==`` against the plain version at
    every shape paths 1, 2, 5 and 6 gave it (on the recorded operands and on
    random and tie-forcing ones) and at SCAN_GENERIC; then each path shape
    timed.  Returns the kernels-line entry: the numbers of ``headline``
    (path 1's most launched shape, so that the scalar replans of path 5 do
    not move the line from one shape to another), and every shape's, in
    order of launches, under ``shapes``."""
    shapes, operands = recorded
    gen = torch.Generator().manual_seed(1)
    order = sorted(shapes, key=lambda s: (s != headline, -shapes[s], s))
    cases = [args for s in order for args, _ in operands[s]]
    for s in order + SCAN_GENERIC:
        cases += _scan_cases(gen, s, device)
    n, mismatches, max_err = _compare_scan(mp, cases)
    if mismatches:
        raise AssertionError(f"minplus scan kernel disagrees with its plain "
                             f"version in {mismatches} of {n} cases")
    print(f"minplus_scan at the paths' shapes and SCAN_GENERIC: {n} cases == "
          f"plain version (recorded operands, random, ties; values, indices, "
          f"shapes and types), max_abs_err {max_err!r}")

    rows = {}
    for s in order:
        ops = _scan_cases(gen, s, device)[0]
        ms = _kernel_device_ms(lambda: mp.minplus_scan(*ops), 200,
                               "minplus_scan")
        plain = _kernel_device_ms(lambda: mp.minplus_scan_reference(*ops),
                                  200, None)
        held = _held_queue_ms(lambda: mp.minplus_scan(*ops), 200)
        bound, by, n_ops, n_bytes = _scan_bound(s)
        rows[s] = {"shape": list(s), "launches": shapes[s], "ms": ms,
                   "plain_ms": plain, "held_ms": held, "bound_ms": bound,
                   "bound_by": by, "library_ms": None,
                   "bound_share": bound / ms}
        print(f"minplus_scan (N, K, S) {s} float64, {shapes[s]} launches on "
              f"the paths: device time per launch (torch.profiler) kernel "
              f"{ms!r} ms, plain {plain!r} ms; kernel on a held stream (CUDA "
              f"events) {held!r} ms; bound {bound!r} ms by {by} ({n_ops} "
              f"operations, {n_bytes} B): {bound / ms!r} of the bound")
    top = order[0]
    ops = _scan_cases(gen, top, device)[0]
    call_ms = _time_ms(lambda: mp.minplus_scan(*ops))
    plain_call_ms = _time_ms(lambda: mp.minplus_scan_reference(*ops))
    print(f"minplus_scan at {top}, per call seen by the caller (CUDA "
          f"events): kernel {call_ms!r} ms, plain {plain_call_ms!r} ms")
    return {"name": "minplus_scan", "route": "cuda",
            "source": KERNELS["minplus_scan"].source,
            "replaces": KERNELS["minplus_scan"].replaces,
            "launches": sum(launches_by_path.values()),
            "max_abs_err": max_err, "mismatches": mismatches,
            **{k: v for k, v in rows[top].items() if k != "launches"},
            "launches_by_path": launches_by_path,
            "call_ms": call_ms, "plain_call_ms": plain_call_ms,
            "shapes": [rows[s] for s in order]}


def build_population(C) -> list:
    """The solver benchmark's population (benchmarks/solver_throughput.py),
    built with the port's own classes: (K, per_stage) in {(3, 6), (5, 4)},
    IF/TR, b in {8, 128}, seeds 1-8, then the 32 TR-pipe instances, M = 4."""
    net = C.nsfnet(source=C.SOURCE)
    profile = C.resnet101_profile()

    def inst(K, per_stage, seed, **req):
        cands = C.candidate_sets(K, seed, C.NSFNET_NODES, C.SOURCE, C.DEST,
                                 per_stage=per_stage)
        return C.ProblemInstance(net, profile, C.ServiceChainRequest(
            profile.model_id, C.SOURCE, C.DEST, **req), K, cands)

    configs, seeds = [(3, 6), (5, 4)], range(1, 9)
    out = [inst(K, ps, s, batch_size=b, mode=mode)
           for K, ps in configs for mode in (C.IF, C.TR) for b in (8, 128)
           for s in seeds]
    out += [inst(K, ps, s, batch_size=b, mode=C.TR, schedule=C.PIPE,
                 n_microbatches=4)
            for K, ps in configs for b in (8, 128) for s in seeds]
    return out


def _plain(out) -> tuple:
    if out.plan is None:
        return (False,)
    p, lb = out.plan, out.latency
    return (True, tuple(map(tuple, p.segments)), tuple(p.placement),
            tuple(map(tuple, p.paths)), tuple(p.tail_path),
            (lb.computation_s, lb.transmission_s, lb.propagation_s,
             lb.bubble_s))


# the host split of a warm dfts_torch pass: label -> function of
# repro_torch.core.torch_solvers timed inside the pass
HOST_SPLIT = {"encode": "_encode_seq", "capped-tour build": "_tour_operands",
              "scan (copies, launch, synchronisation)": "_run_dfts_scan",
              "decode": "_decode_eval_seq"}


@contextlib.contextmanager
def timed_calls(module, names: dict):
    """Inside the block, the seconds spent in each function ``names``
    (label -> name) of ``module``, summed per label in the yielded dict."""
    spent = dict.fromkeys(names, 0.0)
    originals = {name: getattr(module, name) for name in names.values()}

    def timed(label, fn):
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[label] += time.perf_counter() - t0
        return call

    for label, name in names.items():
        setattr(module, name, timed(label, originals[name]))
    try:
        yield spent
    finally:
        for name, fn in originals.items():
            setattr(module, name, fn)


def recorded_passes(C, TS, mp, passes, device) -> dict:
    """Run each ``(label, problems, solver)`` of ``passes`` through
    ``solve_batch`` on ``device`` with every ``minplus_scan`` call recorded.
    Returns the outcomes, seconds, scans (recorded calls) and scan-kernel
    launches of each pass, and the recorded shapes and operands."""
    out = {}
    with record_calls(TS, "minplus_scan", _scan_key) as (shapes, operands):
        for label, problems, solver in passes:
            scans, launches = sum(shapes.values()), mp.scan_launch_count
            t0 = time.perf_counter()
            got = C.solve_batch(problems, solver, dedup=False, device=device)
            out[label] = {"outcomes": got,
                          "seconds": time.perf_counter() - t0,
                          "scans": sum(shapes.values()) - scans,
                          "launches": mp.scan_launch_count - launches}
    return {"passes": out, "recorded": (shapes, operands)}


def run_main_path(C, TS, mp, device: str = "cuda") -> dict:
    """Phase 4: the planner on ``device``, held against the NumPy oracles
    on the CPU.  Returns the scan launches of the run, the min-plus product
    launches (none expected), and the recorded scan shapes and operands."""
    problems = build_population(C)
    if len(set(problems)) != 96:
        raise AssertionError("the population must hold 96 distinct instances")
    cycled = [problems[i % len(problems)] for i in range(1024)]
    for p in problems:
        if p.profile.L != 37 or len(p.net.nodes) != 14:
            raise AssertionError("ResNet-101 at full width on NSFNET expected")

    mp.scan_launch_count = mp.launch_count = 0
    run = recorded_passes(C, TS, mp, [
        ("dfts_torch 96 distinct", problems, "dfts_torch"),
        ("dfts_torch 1024 cycled", cycled, "dfts_torch"),
        ("bcd_torch 96 distinct", problems, "bcd_torch")], device)
    launches, matmul_launches = mp.scan_launch_count, mp.launch_count
    shapes = run["recorded"][0]
    if launches == 0:
        raise AssertionError("the main path launched no minplus scan kernel")
    for label, r in run["passes"].items():
        print(f"main path: {label} in {r['seconds']!r} s: {r['scans']} scans, "
              f"{r['launches']} minplus scan launches")
        if r["scans"] != r["launches"]:
            raise AssertionError(f"{label}: {r['scans']} recorded scans "
                                 f"against {r['launches']} launches")
    print("minplus scans on the main path by (N, K, S): " +
          ", ".join(f"{s}: {c}" for s, c in shapes.most_common()))
    print(f"main path: minplus scan launches in all {launches}; "
          f"minplus_matmul launches {matmul_launches}")

    cache = C.EvalCache()
    want_dfts = [C.solve(p, "dfts_np", cache=cache) for p in problems]
    t4 = time.perf_counter()
    want_bcd = [C.solve(p, "bcd", cache=C.EvalCache()) for p in problems]
    print(f"oracles on the CPU: bcd 96 distinct {time.perf_counter() - t4!r}"
          f" s")
    outs = {label: r["outcomes"] for label, r in run["passes"].items()}
    mismatches = 0
    for got, want in [(outs["dfts_torch 96 distinct"], want_dfts),
                      (outs["dfts_torch 1024 cycled"], want_dfts * 11),
                      (outs["bcd_torch 96 distinct"], want_bcd)]:
        for g, w in zip(got, want):
            mismatches += _plain(g) != _plain(w)
    dfts_distinct = outs["dfts_torch 96 distinct"]
    n_feasible = sum(o.feasible for o in dfts_distinct)
    for o in dfts_distinct + outs["bcd_torch 96 distinct"]:
        if o.feasible and not (0.0 < o.objective < float("inf")):
            raise AssertionError(f"non-finite latency {o.objective!r}")
    if mismatches:
        raise AssertionError(f"{mismatches} outcomes differ from the NumPy "
                             f"oracles")
    print(f"parity: 96 + 1024 dfts_torch and 96 bcd_torch outcomes == "
          f"dfts_np / bcd ({n_feasible} of 96 feasible)")

    # warm throughput: the recurring 1024-instance batch, best of 3 passes
    def warm_pass():
        return C.solve_batch(cycled, "dfts_torch", dedup=False, device=device)

    warm_torch = min(_wall(warm_pass) for _ in range(3))
    warm_np = min(_wall(lambda: [C.solve(p, "dfts_np", cache=cache)
                                 for p in cycled]) for _ in range(3))
    print(f"warm instances/s at batch 1024: dfts_torch ({device}) "
          f"{1024 / warm_torch!r}, dfts_np (cpu) {1024 / warm_np!r}")
    # the host split first: a profiled pass comes after every host timing
    with timed_calls(TS, HOST_SPLIT) as spent:
        wall = _wall(warm_pass)
    rest = wall - sum(spent.values())
    print(f"host split of a warm dfts_torch pass at batch 1024 ({device}), "
          f"wall {wall!r} s: " + ", ".join(
              f"{label} {s!r} s" for label, s in spent.items()) +
          f", the rest (tour enumeration, waves, control flow) {rest!r} s")
    before = mp.scan_launch_count
    if device == "cuda":
        wall, dev, by_name = _device_us(warm_pass)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        print(f"warm dfts_torch pass at batch 1024 under the profiler: wall "
              f"{wall!r} us, device busy {dev!r} us (share {dev / wall!r}, "
              f"idle {1.0 - dev / wall!r}); top device time: {top}")
    else:
        warm_pass()
    warm_scans = mp.scan_launch_count - before
    print(f"warm dfts_torch pass at batch 1024: {warm_scans} minplus scan "
          f"launches (at most {MAX_WARM_SCANS})")
    if warm_scans > MAX_WARM_SCANS:
        raise AssertionError(f"the warm pass made {warm_scans} scans, more "
                             f"than {MAX_WARM_SCANS}")
    return {"launches": launches, "matmul_launches": matmul_launches,
            "recorded": run["recorded"]}


def _wall(fn) -> float:
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


# ---------------------------------------------------------------- path 5
class StackRun(NamedTuple):
    """One fleet of path 5 through one entry class of ``repro_torch.serve``
    on NSFNET x ResNet-101 (source v4, destination v13): ``driver`` is
    ``"admit"`` (one static ``ServePlanner.admit`` round), ``"gateway"``
    (``ServeGateway.run_stream``) or ``"sim"`` (``ServeSim.run``), under
    the ``fcfs`` policy, with the retry queue where ``retry``; ``fleet``
    the keyword arguments of ``generate_fleet`` beyond the fabric and the
    endpoints; ``failures`` those of ``generate_failures`` beyond the
    fabric (none: no failures); ``pairs`` the (card solver, its NumPy
    oracle) pairs it runs with, each once on the card and once on the
    host."""
    label: str
    driver: str
    fleet: dict
    pairs: tuple
    window_s: float = 0.0
    failures: dict | None = None
    retry: bool = True


STACK_PAIRS = (("dfts_torch", "dfts_np"), ("bcd_torch", "bcd"))
STACK_HOLD_S = 4.0  # nsfnet_gateway's mean hold (src/repro/sweep/suites.py)


def _stack_runs() -> list:
    """Path 5's traffic: the quick tier of ``nsfnet_gateway`` (Poisson
    fleets of 16 and 32, batch 2 spread 1/2/4, IF, K 3, candidate seed 0:
    each fleet's static round, then the gateway at windows 0.0 and 0.5 s
    with exponential holds of mean 4 s and the retry queue), a 512-request
    stream at 64 requests/s through the gateway at window 0.5 s (K 5, 4
    candidates a stage, half of it TR, about 32 presolve misses a tick) and
    the ``nsfnet_failures`` quick tier's failure cell (16 requests, holds
    of mean 6 s, failures at 0.2/s recovering after 12 s on average) at
    seed 2, the first seed whose failures take chains of both oracles down
    (at seed 0 none of ``dfts_np``'s), so that live migration replans.

    The stream runs without the retry queue: NSFNET holds a few of its
    chains at a time, and with retries every departure re-attempts the
    whole queue, one replan (a scan of one instance) per waiting request:
    259,504 such scans for this stream, 340 s through ``dfts_torch`` and
    225 s through ``dfts_np`` on a CPU, where its presolve waves make 17
    scans."""
    base = dict(batch_size=2, mode="IF", K=3, seed=0, arrival="poisson",
                model_id="resnet101")
    churn = dict(hold_model="exp", hold_time_s=STACK_HOLD_S)
    runs = []
    for n in (16, 32):
        runs.append(StackRun(f"static n{n}", "admit",
                             dict(base, n_requests=n), STACK_PAIRS))
        runs += [StackRun(f"gateway n{n} window {w}", "gateway",
                          dict(base, n_requests=n, **churn), STACK_PAIRS, w)
                 for w in (0.0, 0.5)]
    runs.append(StackRun(
        "stream n512 64/s window 0.5 no retry", "gateway",
        dict(base, n_requests=512, K=5, candidates_per_stage=4,
             arrival_rate_rps=64.0, train_share=0.5, **churn),
        (("dfts_torch", "dfts_np"),), 0.5, retry=False))
    runs.append(StackRun(
        "failures n16 rate 0.2 seed 2", "sim",
        dict(base, n_requests=16, seed=2, hold_model="exp", hold_time_s=6.0),
        (("dfts_torch", "dfts_np"),),
        failures=dict(rate_per_s=0.2, mean_downtime_s=12.0)))
    return runs


# what two runs of one fleet may differ in: wall-clock fields, the
# engine's EvalCache counters (the torch solvers do not use the cache) and
# the solver's name
STACK_UNCOMPARED = ("wall_time_s", "wall_s", "tick_wall_total_s",
                    "tick_wall_mean_s", "tick_wall_pct", "admissions_per_s",
                    "eval_cache", "solver")


def _without(value, keys):
    if isinstance(value, dict):
        return {k: _without(v, keys) for k, v in value.items()
                if k not in keys}
    if isinstance(value, list):
        return [_without(v, keys) for v in value]
    return value


def serve_view(outcome, ticks=(), solves=()) -> dict:
    """An outcome of either package's serve stack as plain values: every
    served record (request, decision, latency, plan, reason, status, admit
    and depart times, migrations), the summary, the event timeline, the
    per-tick counts and the solves (``stack_solves``), STACK_UNCOMPARED
    left out."""
    return _without({"served": [s.to_dict() for s in outcome.served],
                     "summary": outcome.summary(),
                     "timeline": list(getattr(outcome, "timeline", [])),
                     "ticks": list(ticks), "solves": list(solves)},
                    STACK_UNCOMPARED)


@contextlib.contextmanager
def stack_solves(S):
    """Inside the block, every outcome the serve package ``S`` gets from its
    solver registry (presolves, replans, the replans of failure victims),
    in order, as (plan and breakdown, objective, status).  A served record
    carries the latency its plan has on the residual fabric, not the
    solver's, so a solver's own numbers are held here."""
    sites = [(S.planner, "solve"), (S.planner, "solve_batch"),
             (S.admission, "solve_batch")]
    originals = [getattr(module, name) for module, name in sites]
    log: list = []

    def logged(fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            log.extend((_plain(o), o.objective, o.status)
                       for o in (out if isinstance(out, list) else [out]))
            return out
        return call

    for (module, name), fn in zip(sites, originals):
        setattr(module, name, logged(fn))
    try:
        yield log
    finally:
        for (module, name), fn in zip(sites, originals):
            setattr(module, name, fn)


def drive_stack(S, run: StackRun, net, profile, fleet, failures, solver,
                solver_kwargs) -> tuple:
    """One run of ``run``'s fleet through its entry class with ``solver``:
    (outcome, the gateway's per-tick rows, the solves)."""
    with stack_solves(S) as solves:
        if run.driver == "admit":
            planner = S.ServePlanner(net, profile, solver=solver,
                                     solver_kwargs=solver_kwargs)
            return planner.admit(fleet, policy="fcfs"), [], solves
        if run.driver == "gateway":
            gw = S.ServeGateway(
                net, profile, solver=solver, policy="fcfs",
                config=S.GatewayConfig(batch_window_s=run.window_s,
                                       retry=run.retry),
                solver_kwargs=solver_kwargs)
            outcome = gw.run_stream(fleet, failures=failures)
            return outcome, gw.stats.ticks, solves
        sim = S.ServeSim(net, profile, solver=solver, retry=run.retry,
                         solver_kwargs=solver_kwargs)
        return sim.run(fleet, policy="fcfs", failures=failures), [], solves


def run_serve_stack_path(C, TS, mp, device: str = "cuda",
                         runs: list | None = None) -> dict:
    """Path 5: the serving control plane through its entry classes, each
    fleet once with the card solver on ``device`` and once with its NumPy
    oracle on the host, every served record, the summary, the timeline,
    the per-tick counts and the solver outcomes ``==`` between the two
    (``serve_view``); the card's traces replayed
    (``replay_verify`` / ``replay_verify_sim``); every card run must launch
    the scan kernel as often as it made scans.  Returns the scan launches
    of the path and the recorded scan shapes and operands."""
    import repro_torch.serve as S
    from repro_torch.serve import planner as SP

    net = C.nsfnet(source=C.SOURCE)
    profile = C.resnet101_profile()
    if profile.L != 37 or len(net.nodes) != 14:
        raise AssertionError("ResNet-101 at full width on NSFNET expected")
    mp.scan_launch_count = mp.launch_count = 0
    total = 0
    runs = runs if runs is not None else _stack_runs()
    # the gated card run of the longest fleet runs under the profiler
    longest = max(runs, key=lambda r: r.fleet["n_requests"])
    with record_calls(TS, "minplus_scan", _scan_key) as (shapes, operands):
        for run in runs:
            fleet = S.generate_fleet(net, source=C.SOURCE,
                                     destination=C.DEST, **run.fleet)
            failures = None
            if run.failures is not None:
                horizon = (max(r.arrival_s for r in fleet)
                           + run.fleet["hold_time_s"])
                failures = S.generate_failures(
                    net, horizon_s=horizon, seed=run.fleet["seed"],
                    protect=(C.SOURCE, C.DEST), **run.failures)
            for card, oracle in run.pairs:
                scans, launches = sum(shapes.values()), mp.scan_launch_count
                out = []

                def card_run():
                    out.extend(drive_stack(S, run, net, profile, fleet,
                                           failures, card,
                                           {"device": device}))

                profiled = (device == "cuda" and run is longest
                            and card == run.pairs[0][0])
                with timed_calls(SP.ServePlanner,
                                 {"presolve": "presolve"}) as spent:
                    if profiled:
                        wall_us, dev_us, by_name = _device_us(card_run)
                        wall = wall_us / 1e6
                    else:
                        wall = _wall(card_run)
                got, ticks, solves = out
                scans = sum(shapes.values()) - scans
                launches = mp.scan_launch_count - launches
                with timed_calls(SP.ServePlanner,
                                 {"presolve": "presolve"}) as host:
                    t0 = time.perf_counter()
                    want, want_ticks, want_solves = drive_stack(
                        S, run, net, profile, fleet, failures, oracle, None)
                    host_wall = time.perf_counter() - t0
                what = f"serve stack: {run.label}, {card}"
                if (serve_view(got, ticks, solves)
                        != serve_view(want, want_ticks, want_solves)):
                    raise AssertionError(f"{what} differs from {oracle}")
                if launches == 0 or scans != launches:
                    raise AssertionError(f"{what}: {scans} scans, "
                                         f"{launches} scan launches")
                ok = (S.replay_verify(net, profile, got.served)
                      if run.driver == "admit" else
                      S.replay_verify_sim(net, profile, got.served, failures))
                if not ok:
                    raise AssertionError(f"{what}: the trace does not replay")
                if failures and not got.failure_summary()["n_restored"]:
                    raise AssertionError(f"{what}: no chain was migrated")
                total += launches
                pc = (got.gateway_stats.get("plan_cache", {})
                      if run.driver == "gateway" else {})
                print(f"{what} ({device}) == {oracle} (cpu): wall {wall!r} s "
                      f"({oracle} {host_wall!r} s), presolve "
                      f"{spent['presolve']!r} s ({oracle} "
                      f"{host['presolve']!r} s), {got.n_presolved} instances "
                      f"presolved, {len(solves)} solver outcomes, {scans} "
                      f"scans, {launches} minplus scan launches, plan-cache "
                      f"hit rate "
                      f"{pc.get('hit_rate', 'n/a')}, {len(ticks)} ticks, "
                      f"admitted {got.n_accepted} of {got.n_requests} "
                      f"({got.acceptance_ratio!r})")
                if profiled:
                    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
                    print(f"{what} ran under the profiler: device busy "
                          f"{dev_us!r} us of the wall {wall_us!r} us (idle "
                          f"{1.0 - dev_us / wall_us!r}); top device time "
                          f"(us): {top}")
    if mp.scan_launch_count != total:
        raise AssertionError("minplus scan launches outside the card runs")
    print(f"serve stack: minplus scan launches in all {total}; the gated "
          f"runs' by (N, K, S): " + ", ".join(
              f"{s}: {c}" for s, c in shapes.most_common()))
    return {"launches": total, "matmul_launches": mp.launch_count,
            "recorded": (shapes, operands)}


# ---------------------------------------------------------------- path 6
# the BCD scheme of the port's suites and its host oracle: `bcd_torch` is
# the JAX package's `bcd` with its DP scans on the device
SWEEP_NAMES = {"bcd_torch": "bcd"}
# of the paper's 10 candidate seeds, those path 6's nsfnet_paper grid runs:
# as many as fit a budget of SWEEP_BUDGET_S for the whole path on an H100
# (5 seeds passed it in one run of three); a run past it prints a warning
SWEEP_SEEDS = 4
SWEEP_BUDGET_S = 60.0
SWEEP_FLEETS = ("nsfnet_gateway", "nsfnet_mixed_training")  # quick tiers
SWEEP_WORKERS = 2  # processes of the pool run
# what two runs of one sweep with the same solvers, each in a fresh
# context, may differ in: the wall clocks and what the report derives from
# them (speedups, Pareto fronts)
SWEEP_WALL = ("wall_time_s", "wall_s", "tick_wall_total_s",
              "tick_wall_mean_s", "tick_wall_pct", "admissions_per_s",
              "speedup_vs_ref", "mean_speedup_vs_ref", "pareto_front",
              "pareto_count")
# and what a card solver's run and its host oracle's may also differ in:
# the engine's EvalCache counters, which the torch solvers do not touch
# and which count what earlier scenarios of the same process left in the
# shared cache
SWEEP_UNCOMPARED = SWEEP_WALL + ("eval_cache", "eval_cache_hit_rate")


def sweep_names(results, names: dict = SWEEP_NAMES) -> dict:
    """``names`` (card solver -> its host oracle) and, for each result of
    a card solver, its scenario id -> the id of the same spec with the
    oracle (the id hashes the solver)."""
    out = dict(names)
    for r in results:
        if r.spec.solver in names:
            twin = type(r.spec).from_dict(
                {**r.spec.to_dict(), "solver": names[r.spec.solver]})
            out[r.spec.scenario_id()] = twin.scenario_id()
    return out


def _renamed(value, names: dict):
    if isinstance(value, dict):
        return {names.get(k, k): _renamed(v, names) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_renamed(v, names) for v in value]
    if isinstance(value, str):
        return names.get(value, value)
    return value


def sweep_view(W, results, out_dir, names: dict | None = None,
               uncompared=SWEEP_UNCOMPARED) -> dict:
    """A sweep of either package as plain values (``W``: its sweep
    package): every result with its spec, the comparison report and the
    CSV rows of its artifact (written to ``out_dir``), ``uncompared`` left
    out and every key or string of ``names`` renamed (``sweep_names``)."""
    art = importlib.import_module(f"{W.__name__}.artifacts")
    paths = art.write_artifacts(out_dir, "view", results)
    with open(paths["csv"], newline="") as fh:
        rows = list(csv.DictReader(fh))
    view = {"results": [r.to_dict() for r in results],
            "report": W.comparison_report(results), "csv": rows}
    return _renamed(_without(view, uncompared), names or {})


@contextlib.contextmanager
def presolved_maps(WR):
    """Inside the block, every map ``SweepRunner._batch_presolve`` of the
    runner module ``WR`` returns, in order, and the seconds it spent."""
    maps: list = []
    original = WR.SweepRunner._batch_presolve
    spent = {"presolve": 0.0}

    def watched(self, specs):
        t0 = time.perf_counter()
        out = original(self, specs)
        spent["presolve"] += time.perf_counter() - t0
        maps.append(out)
        return out

    WR.SweepRunner._batch_presolve = watched
    try:
        yield maps, spent
    finally:
        WR.SweepRunner._batch_presolve = original


def presolve_eligible(C, specs) -> list:
    """The specs ``_batch_presolve`` takes: single-chain specs of a solver
    with a batch entry, in a (solver, solver_kwargs) group of at least two
    (a group of one has nothing to amortise)."""
    groups: dict = {}
    for s in specs:
        if s.n_requests == 1 and C.get_solver(s.solver).batch_fn is not None:
            kw = json.dumps(s.solver_kwargs, sort_keys=True, default=str)
            groups.setdefault((s.solver, kw), []).append(s)
    return [s for g in groups.values() if len(g) >= 2 for s in g]


def _check_presolved(C, WR, specs, maps) -> int:
    """Every spec of ``specs`` that ``_batch_presolve`` takes must be in a
    map it returned, so that a fault of the batch entry cannot hide behind
    the scalar loop that its ``except`` falls back to."""
    merged: dict = {}
    for m in maps:
        merged.update(m)
    eligible = presolve_eligible(C, specs)
    missing = [s.scenario_id() for s in eligible
               if WR._presolve_key(s, s.problem(*WR._context(s)[:2]))
               not in merged]
    if missing:
        raise AssertionError(f"{len(missing)} of {len(eligible)} specs of the "
                             f"batched presolve were solved one by one, e.g. "
                             f"{missing[:3]}")
    return len(eligible)


def _verified(W, result) -> bool:
    """``verify_result``, a plan it rejects by raising counted as False."""
    try:
        return W.verify_result(result)
    except (AssertionError, ValueError):
        return False


def _sweep_errors(W, what: str, runner, results) -> None:
    if runner.last_stats["n_errors"]:
        raise AssertionError(f"{what}: {runner.last_stats['errors']}")
    bad = [r.spec.scenario_id() for r in results if not _verified(W, r)]
    if bad:
        raise AssertionError(f"{what}: verify_result fails on {len(bad)} "
                             f"results, e.g. {bad[:3]}")


def _spawned_ready(device: str) -> float:
    """In a worker: import the sweep runner and make ``device`` ready (a
    CUDA context on the card); the seconds that took."""
    t0 = time.perf_counter()
    importlib.import_module("repro_torch.sweep.runner")
    torch.zeros(1, device=device).sum().item()
    return time.perf_counter() - t0


def _sweep_suite(W, WR, C, mp, name, specs, oracle_specs, device, tmp,
                 shapes) -> tuple:
    """One suite of path 6 on ``device`` and with the host's ``bcd``, held
    ``==``; its artifact written and reloaded ``==``.  Returns the card's
    results, the presolved maps and the scan launches."""
    from repro_torch.sweep.artifacts import load_artifact, write_artifacts
    from repro_torch.sweep.suites import BCD

    runner = W.SweepRunner(workers=0, device=device)
    scans, launches = sum(shapes.values()), mp.scan_launch_count
    with presolved_maps(WR) as (maps, spent):
        t0 = time.perf_counter()
        got = runner.run(specs)
        wall = time.perf_counter() - t0
    scans = sum(shapes.values()) - scans
    launches = mp.scan_launch_count - launches
    what = f"sweep: {name} ({device})"
    _sweep_errors(W, what, runner, got)
    n_presolved = _check_presolved(C, WR, specs, maps)
    if launches == 0 or scans != launches:
        raise AssertionError(f"{what}: {scans} scans, {launches} scan "
                             f"launches")
    host_runner = W.SweepRunner(workers=0, device="cpu")
    with presolved_maps(WR) as (_, host_spent):
        t0 = time.perf_counter()
        want = host_runner.run(oracle_specs)
        host_wall = time.perf_counter() - t0
    _sweep_errors(W, f"sweep: {name} (host)", host_runner, want)
    if (sweep_view(W, got, tmp / "card", sweep_names(got))
            != sweep_view(W, want, tmp / "host")):
        raise AssertionError(f"{what} differs from the host's bcd")
    n_single = sum(s.solver == BCD and s.n_requests == 1 for s in specs)
    print(f"{what} == the host's bcd (cpu) in {len(got)} results, the "
          f"report and the CSV rows: wall {wall!r} s (host {host_wall!r} s), "
          f"presolve {spent['presolve']!r} s (host "
          f"{host_spent['presolve']!r} s), {n_presolved} of {n_single} "
          f"single-chain {BCD} scenarios presolved, {scans} scans, "
          f"{launches} minplus scan launches")
    paths = write_artifacts(tmp / "artifacts", name, got,
                            meta={"stats": runner.last_stats})
    meta, back = load_artifact(paths["json"])
    if ([r.to_dict() for r in back]
            != json.loads(json.dumps([r.to_dict() for r in got]))
            or meta["report"] != json.loads(json.dumps(
                W.comparison_report(got)))):
        raise AssertionError(f"{what}: the artifact does not reload ==")
    return got, maps, launches


def _profiled_presolve(W, WR, mp, specs, presolved, device) -> None:
    """The presolve of ``specs`` again, under the profiler on the card: its
    outcomes must be the gated run's (``presolved``); prints the card's
    busy time and idle share."""
    runner = W.SweepRunner(workers=0, device=device)
    before = mp.scan_launch_count
    again = {}
    if device == "cuda":
        wall_us, dev_us, by_name = _device_us(
            lambda: again.update(runner._batch_presolve(specs)))
    else:
        again.update(runner._batch_presolve(specs))
    keys = {WR._presolve_key(s, s.problem(*WR._context(s)[:2]))
            for s in specs}
    if set(again) != keys or any(_plain(again[k]) != _plain(presolved[k])
                                 for k in keys):
        raise AssertionError("sweep: the profiled presolve differs from the "
                             "gated one")
    if device == "cuda":
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
        print(f"sweep: the presolve of {len(specs)} instances of seed "
              f"{specs[0].candidate_seed} under the profiler, "
              f"{mp.scan_launch_count - before} scans: device busy "
              f"{dev_us!r} us of the wall {wall_us!r} us (idle "
              f"{1.0 - dev_us / wall_us!r}); top device time (us): {top}")


def _pool_check(W, specs, serial, device, tmp) -> None:
    """A spawned worker's start-up, then ``specs`` through SWEEP_WORKERS
    spawned workers on ``device``, ``==`` their ``serial`` results."""
    t0 = time.perf_counter()
    with ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool:
        inside = pool.submit(_spawned_ready, str(device)).result()
    print(f"sweep: a spawned worker ready in {time.perf_counter() - t0!r} s, "
          f"{inside!r} s of it importing repro_torch.sweep and making "
          f"{device} ready")
    runner = W.SweepRunner(workers=SWEEP_WORKERS, device=device)
    t0 = time.perf_counter()
    pooled = runner.run(specs)
    wall = time.perf_counter() - t0
    _sweep_errors(W, "sweep: the pool", runner, pooled)
    if (sweep_view(W, pooled, tmp / "pool")
            != sweep_view(W, [serial[s.scenario_id()] for s in specs],
                          tmp / "serial")):
        raise AssertionError("sweep: the pool's results differ from the "
                             "serial run's")
    print(f"sweep: {len(specs)} scenarios through {SWEEP_WORKERS} spawned "
          f"workers ({device}) == the serial run: wall {wall!r} s")


def run_sweep_path(C, TS, mp, device: str = "cuda", card: str = "",
                   quick: bool = False, fleets=SWEEP_FLEETS) -> dict:
    """Path 6: the sweep engine, ``repro_torch.sweep.SweepRunner`` on
    ``device``.  The ``nsfnet_paper`` grid (K 2-7, b 1-256, both modes, the
    first SWEEP_SEEDS candidate seeds; ``quick`` its quick tier) with
    ``exact`` and ``bcd_torch``, then the quick tiers of ``fleets``, each
    suite ``==`` the same suite run with the host ``bcd`` on the CPU
    (``_sweep_suite``); the presolve of the first seed's ``bcd_torch``
    specs again under the profiler; a few specs through a pool of
    SWEEP_WORKERS spawned workers ``==`` the serial run.  Returns the scan
    launches of the gated runs and the recorded scan shapes and
    operands."""
    import tempfile

    import repro_torch.sweep as W
    from repro_torch.sweep import runner as WR
    from repro_torch.sweep import suites as WS

    t_path = time.perf_counter()
    host_bcd = SWEEP_NAMES[WS.BCD]
    grid = WS.nsfnet_paper(quick=quick, seeds=SWEEP_SEEDS,
                           schemes=("exact", WS.BCD))
    net, profile = grid[0].build_network(), grid[0].build_profile()
    if profile.L != 37 or len(net.nodes) != 14:
        raise AssertionError("ResNet-101 at full width on NSFNET expected")
    suites = [("nsfnet_paper", grid, WS.nsfnet_paper(
        quick=quick, seeds=SWEEP_SEEDS, schemes=("exact", host_bcd)))] + [
        (name, WS.SUITES[name](quick=True),
         WS.SUITES[name](quick=True, schemes=(host_bcd,)))
        for name in fleets]
    n_seeds = len({s.candidate_seed for s in grid})
    print(f"sweep: nsfnet_paper with {n_seeds} of the paper's 10 seeds, "
          f"{len(grid)} scenarios (K {sorted({s.K for s in grid})}, b "
          f"{sorted({s.batch_size for s in grid})}, modes IF and TR, exact "
          f"and {WS.BCD}), then the quick tiers of {', '.join(fleets)}")

    mp.scan_launch_count = mp.launch_count = 0
    total, card_results, presolved = 0, {}, {}
    with tempfile.TemporaryDirectory() as tmp_dir:
        tmp = Path(tmp_dir)
        with record_calls(TS, "minplus_scan", _scan_key) as (shapes,
                                                             operands):
            for name, specs, oracle_specs in suites:
                got, maps, launches = _sweep_suite(
                    W, WR, C, mp, name, specs, oracle_specs, device, tmp,
                    shapes)
                total += launches
                card_results[name] = got
                for m in maps:
                    presolved.update(m)
        if mp.scan_launch_count != total:
            raise AssertionError("minplus scan launches outside the card "
                                 "sweeps")
        gap = W.comparison_report(
            card_results["nsfnet_paper"])["summary"][WS.BCD]
        print(f"sweep: nsfnet_paper, {WS.BCD} against exact (the paper's "
              f"Figs. 4 and 5): mean gap {gap['mean_gap_pct']!r} %, max gap "
              f"{gap['max_gap_pct']!r} % over {gap['n_feasible']} feasible "
              f"of {gap['n']}; card {card}")
        _profiled_presolve(W, WR, mp, [
            s for s in grid if s.solver == WS.BCD
            and s.candidate_seed == grid[0].candidate_seed], presolved,
            device)
        _pool_check(W, [s for s in grid if s.solver == WS.BCD][:2]
                    + [s for s in grid if s.solver == "exact"][:1]
                    + [s for s in suites[-1][1] if s.solver == WS.BCD][:1],
                    {r.spec.scenario_id(): r
                     for rs in card_results.values() for r in rs},
                    device, tmp)
    spent = time.perf_counter() - t_path
    print(f"sweep: minplus scan launches in all {total}; path 6 in "
          f"{spent!r} s ({n_seeds} seeds); the gated runs' scans by (N, K, "
          f"S): " + ", ".join(f"{s}: {c}" for s, c in shapes.most_common(8)))
    if not quick and spent > SWEEP_BUDGET_S:
        print(f"sweep: warning: path 6 took {spent!r} s, past its budget of "
              f"{SWEEP_BUDGET_S} s; lower SWEEP_SEEDS")
    return {"launches": total, "matmul_launches": mp.launch_count,
            "recorded": (shapes, operands)}


# ------------------------------------------------------------------ builds --
def build_kernels(mods: dict) -> None:
    """Phase 2: every kernel built at once, one ``nvcc`` per source (a
    module's forward ``LIBRARY`` and, where it has one, its
    ``BWD_LIBRARY``); the first failure raises."""
    t0 = time.perf_counter()
    libs = [lib for m in mods.values()
            for lib in (m.LIBRARY, getattr(m, "BWD_LIBRARY", None)) if lib]
    with ThreadPoolExecutor(len(libs)) as pool:
        list(pool.map(lambda lib: lib.build(), libs))
    for lib in libs:
        info = lib.build_info
        print(f"build: {lib.source.name} in {info['seconds']!r} s "
              f"({info['path']})")
        if info["log"]:
            print(info["log"].strip())
    print(f"build: all kernels in {time.perf_counter() - t0!r} s of wall "
          f"time")


# ------------------------------------------------ flash attention and SSD --
def _flash_operands(gen, shape, device):
    B, Sq, Sk, Hq, Hkv, hd = shape[:6]
    return tuple(torch.randn(s, generator=gen).to(device, torch.bfloat16)
                 for s in ((B, Sq, Hq, hd), (B, Sk, Hkv, hd),
                           (B, Sk, Hkv, hd)))


def _flash_kw(shape) -> dict:
    return dict(zip(("causal", "window", "softcap"), shape[6:]))


def _flash_errors(got, want) -> tuple[float, float]:
    """(the worst (batch, query, head) row's ||got - want|| / ||want||,
    max |got - want| / max |want|), in float32."""
    g, w = got.float(), want.float()
    d = g - w
    rows = d.norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)
    return float(rows.max()), float(d.abs().max() / w.abs().max())


def _flash_within(errors) -> bool:
    return errors[0] < FLASH_TOL[0] and errors[1] <= FLASH_TOL[1]


def _flash_check(fa, cases, what: str) -> float:
    """The kernel against its plain version on each ``((q, k, v), kw)`` at
    FLASH_TOL; raises on a failure, else returns the max_abs_err."""
    failures, worst, max_err = 0, (0.0, 0.0), 0.0
    for (q, k, v), kw in cases:
        out = fa.flash_attention(q, k, v, **kw)
        want = fa.reference_attention(q, k, v, **kw)
        errors = _flash_errors(out, want)
        failures += not _flash_within(errors)
        worst = tuple(map(max, worst, errors))
        max_err = max(max_err, float((out.float() - want.float()).abs().max()))
    line = (f"flash_attention {what}: {len(cases)} bf16 cases, worst row "
            f"{worst[0]!r} (limit {FLASH_TOL[0]}), max error {worst[1]!r} of "
            f"the largest |want| (limit {FLASH_TOL[1]}), max_abs_err "
            f"{max_err!r}")
    if failures:
        raise AssertionError(f"{line}: {failures} cases past the limits")
    print(line)
    return max_err


def _flash_rejects_wrong_outputs(fa, args, kw) -> None:
    """FLASH_TOL must reject two deliberately wrong outputs on these causal
    operands: the plain version with the normaliser l off by 5 %, and
    attention with each row's diagonal key tile dropped (rows past the
    first tile; the tile the kernel would skip if its causal walk stopped
    one tile short)."""
    q, k, v = args
    if not kw.get("causal") or kw.get("window") or kw.get("softcap"):
        raise ValueError(f"plain causal attention expected, got {kw}")
    want = fa.reference_attention(q, k, v, **kw)
    B, Sq, Hq, hd = q.shape
    Hkv = k.shape[2]
    qi = torch.arange(Sq, device=q.device)[:, None]
    ki = torch.arange(k.shape[1], device=q.device)[None, :]
    diagonal = (qi // FLASH_TILE == ki // FLASH_TILE) & (qi >= FLASH_TILE)
    s = torch.einsum("bqkgh,bskh->bkgqs",
                     q.float().reshape(B, Sq, Hkv, Hq // Hkv, hd), k.float())
    s = s * (kw.get("scale") or hd ** -0.5)
    w = torch.softmax(s.masked_fill((qi < ki) | diagonal, -1e30), dim=-1)
    dropped = torch.einsum("bkgqs,bskh->bqkgh", w, v.float())
    wrong = {"l off by 5 %": (want.float() / 1.05).to(want.dtype),
             "diagonal key tile dropped":
                 dropped.reshape(q.shape).to(want.dtype)}
    for what, out in wrong.items():
        errors = _flash_errors(out, want)
        if _flash_within(errors):
            raise AssertionError(f"FLASH_TOL passes a wrong output ({what}): "
                                 f"{errors}")
        print(f"flash_attention check rejects a wrong output ({what}): worst "
              f"row {errors[0]!r}, max error {errors[1]!r} of the largest "
              f"|want|")


def _ssd_operands(gen, shape, device):
    B, S, H, P, N, Q = shape
    nc = S // Q
    return (torch.randn((B, nc, H, Q, P), generator=gen).to(device),
            (torch.randn((B, nc, Q, N), generator=gen) * 0.3).to(device),
            (torch.randn((B, nc, Q, N), generator=gen) * 0.3).to(device),
            (torch.rand((B, nc, H, Q), generator=gen) * 0.19 + 0.01
             ).to(device),
            (torch.rand((H,), generator=gen) * 3.5 + 0.5).to(device))


def _ssd_check(ssd, cases, what: str) -> float:
    """The kernel against its plain version on each case, each output at
    its tolerance in SSD_TOL; raises on a failure, else returns the
    max_abs_err."""
    failures, max_err = 0, 0.0
    for args in cases:
        got = ssd.ssd_intra_chunk(*args)
        want = ssd.reference_ssd_intra_chunk(*args)
        for g, w, tol in zip(got, want, SSD_TOL):
            failures += not torch.allclose(g, w, atol=tol, rtol=tol)
            max_err = max(max_err, float((g - w).abs().max()))
    line = (f"ssd {what}: {len(cases)} float32 cases within {SSD_TOL} of the "
            f"plain version, max_abs_err {max_err!r}")
    if failures:
        raise AssertionError(f"{line}: {failures} outputs past the limits")
    print(line)
    return max_err


def _by_head(t):
    """The largest |t| of each head (axis 2 of an SSD output)."""
    return t.abs().amax(dim=(0, 1, 3, 4))


def _ssd_witness(got, want, exact) -> list:
    """For y and the chunk states: (name, the largest error of ``got``
    against the float64 values ``exact``, its limit: SSD_WITNESS times the
    plain version ``want``'s own largest error, or eps of the largest value
    where the plain version is exact)."""
    rows = []
    for name, g, w, e in zip(("y", "chunk states"), got, want, exact):
        err_k = float((g.double() - e).abs().max())
        err_p = float((w.double() - e).abs().max())
        rows.append((name, err_k, SSD_WITNESS * max(
            err_p, FP32_EPS * float(e.abs().max()))))
    return rows


def _ssd_check_witness(ssd, cases, what: str) -> float:
    """The kernel and its plain version against the plain version computed
    in float64: over each case's y and chunk states, the kernel's largest
    error may be SSD_WITNESS times the plain version's (or eps of the
    largest value, where the plain version is exact), so the kernel is
    within (1 + SSD_WITNESS) times the plain version's own error of it; the
    decay is held to the plain version at SSD_TOL[2].  Prints the errors
    per head.  Raises on a failure, else returns the max_abs_err against
    the plain version."""
    failures, max_err = 0, 0.0
    for n, args in enumerate(cases):
        got = ssd.ssd_intra_chunk(*args)
        want = ssd.reference_ssd_intra_chunk(*args)
        exact = ssd.reference_ssd_intra_chunk(*args, dtype=torch.float64)
        cum_max = float((args[4][None, None, :, None].double()
                         * args[3].double()).sum(-1).max())
        for (name, worst_k, limit), g, w, e in zip(
                _ssd_witness(got, want, exact), got, want, exact):
            err_k, err_p = _by_head(g.double() - e), _by_head(w.double() - e)
            worst_p = float(err_p.max())
            failures += not worst_k <= limit
            vs_plain = float((g - w).abs().max())
            max_err = max(max_err, vs_plain)
            ratio = err_k / err_p.clamp_min(1e-300)
            print(f"ssd {what}, case {n}, {name} against float64: kernel "
                  f"{worst_k!r} (limit {limit!r}), plain {worst_p!r}; kernel "
                  f"vs plain {vs_plain!r}; largest |value| "
                  f"{float(e.abs().max())!r}, |cum|max {cum_max!r}; per "
                  f"head, kernel over plain error {float(ratio.min())!r} to "
                  f"{float(ratio.max())!r}:")
            print("  " + " ".join(f"{a:.3g}/{b:.3g}" for a, b in
                                  zip(err_k.tolist(), err_p.tolist())))
        if not torch.allclose(got[2], want[2], atol=SSD_TOL[2],
                              rtol=SSD_TOL[2]):
            failures += 1
        max_err = max(max_err, float((got[2] - want[2]).abs().max()))
    if failures:
        raise AssertionError(f"ssd {what}: {failures} outputs past the "
                             f"limits")
    return max_err


def _ssd_y_without_diagonal(x, Bm, Cm, dt, A):
    """The plain version's y with each query tile's diagonal SSD_TILE x
    SSD_TILE score tile left out, in float32."""
    x32, B32, C32, dt32 = (t.float() for t in (x, Bm, Cm, dt))
    cum = torch.cumsum(dt32 * (-A.float())[None, None, :, None], dim=-1)
    scores = torch.einsum("bcqn,bckn->bcqk", C32, B32)
    qi = torch.arange(x.shape[3], device=x.device)[:, None]
    ki = torch.arange(x.shape[3], device=x.device)[None, :]
    keep = (qi >= ki) & (qi // SSD_TILE != ki // SSD_TILE)
    decay = torch.exp((cum[..., :, None] - cum[..., None, :]).masked_fill(
        ~keep, float("-inf")))
    w = scores[:, :, None] * decay * dt32[:, :, :, None, :]
    return torch.einsum("bchqk,bchkp->bchqp", w, x32)


def _ssd_wrong_outputs(ssd, args) -> dict:
    """Two deliberately wrong outputs on these operands, built from the
    plain version: head 1 computed with head 0's dt and A (a slip in the
    indexing of a block's group of heads), and y with each query tile's
    diagonal score tile dropped (the tile the causal walk would miss if it
    stopped one tile short)."""
    x, Bm, Cm, dt, A = args
    if x.shape[2] < 2:
        raise ValueError(f"two heads at least expected, got {tuple(x.shape)}")
    dt_slip, A_slip = dt.clone(), A.clone()
    dt_slip[:, :, 1], A_slip[1] = dt[:, :, 0], A[0]
    want = ssd.reference_ssd_intra_chunk(*args)
    return {"head 1 with head 0's dt and A": ssd.reference_ssd_intra_chunk(
                x, Bm, Cm, dt_slip, A_slip),
            "each query tile's diagonal score tile dropped": (
                _ssd_y_without_diagonal(*args), want[1], want[2])}


def _ssd_rejects_wrong_outputs(ssd, args) -> None:
    """The witness check must reject the two wrong outputs of
    ``_ssd_wrong_outputs`` on these operands; prints the error of each."""
    want = ssd.reference_ssd_intra_chunk(*args)
    exact = ssd.reference_ssd_intra_chunk(*args, dtype=torch.float64)
    for what, out in _ssd_wrong_outputs(ssd, args).items():
        rows = _ssd_witness(out, want, exact)
        if all(err <= limit for _, err, limit in rows):
            raise AssertionError(f"SSD_WITNESS passes a wrong output "
                                 f"({what}): {rows}")
        print(f"ssd check rejects a wrong output ({what}; x "
              f"{tuple(args[0].shape)}): " + ", ".join(
                  f"{name} error {err!r} against float64 (limit {limit!r})"
                  for name, err, limit in rows))


def _gmm_operands(gen, shape, device):
    """x and w of an expert matmul at ``(E, C, D, F, activation)`` in bf16,
    w scaled by D^-1/2 (outputs of order 1), with the activation as kw."""
    E, C, D, F_, act = shape
    x = torch.randn((E, C, D), generator=gen).to(device, torch.bfloat16)
    w = (torch.randn((E, D, F_), generator=gen) * D ** -0.5).to(
        device, torch.bfloat16)
    return (x, w), {"activation": act}


def _gmm_within(got, want) -> bool:
    """Every element within GMM_TOL of |want| plus GMM_TOL of max |want|."""
    got, want = got.float(), want.float()
    top = float(want.abs().max())
    return bool(((got - want).abs() <= GMM_TOL * (want.abs() + top)).all())


def _gmm_check(gmm, cases, what: str) -> float:
    """The kernel against its plain version on each ``((x, w), kw)`` at
    GMM_TOL; raises on a failure, else returns the max_abs_err."""
    failures, max_err, worst = 0, 0.0, 0.0
    for (x, w), kw in cases:
        got = gmm.expert_matmul(x, w, **kw).float()
        want = gmm.reference_expert_matmul(x, w, **kw).float()
        d = (got - want).abs()
        failures += not _gmm_within(got, want)
        max_err = max(max_err, float(d.max()))
        worst = max(worst, float(d.max()) / float(want.abs().max()))
    line = (f"moe_gmm {what}: {len(cases)} bf16 cases, max error {worst!r} of "
            f"the largest |want| (elementwise limit {GMM_TOL} of |want| + "
            f"{GMM_TOL} of the largest), max_abs_err {max_err!r}")
    if failures:
        raise AssertionError(f"{line}: {failures} cases past the limit")
    print(line)
    return max_err


def _gmm_rejects_wrong_outputs(gmm, args, kw) -> None:
    """GMM_TOL must reject two deliberately wrong outputs on these operands,
    both built from the plain version: the product with one GMM_TILE slice
    of D left out (a ring stage skipped), and with one counted twice (a
    stale stage read again)."""
    x, w = args
    if x.shape[2] < 3 * GMM_TILE:
        raise ValueError(f"a depth of 3 GMM_TILE at least expected, got "
                         f"{tuple(x.shape)}")
    want = gmm.reference_expert_matmul(x, w, **kw)
    sl = slice(GMM_TILE, 2 * GMM_TILE)  # the second stage
    left_out = x.clone()
    left_out[..., sl] = 0
    wrong = {"one GMM_TILE slice of D left out":
                 gmm.reference_expert_matmul(left_out, w, **kw),
             "one GMM_TILE slice of D counted twice":
                 gmm.reference_expert_matmul(
                     torch.cat([x, x[..., sl]], dim=2),
                     torch.cat([w, w[:, sl]], dim=1), **kw)}
    w32 = want.float()
    limit = GMM_TOL * (w32.abs() + w32.abs().max())
    for what, out in wrong.items():
        if _gmm_within(out, want):
            raise AssertionError(f"GMM_TOL passes a wrong output ({what})")
        d = (out.float() - w32).abs()
        print(f"moe_gmm check rejects a wrong output ({what}; "
              f"{tuple(x.shape)} x {tuple(w.shape)}, {kw}): max error "
              f"{float(d.max() / w32.abs().max())!r} of the largest |want|, "
              f"{float((d > limit).float().mean())!r} of the elements past "
              f"the limit")


def _rglru_operands(gen, shape, device):
    """a in [0.7, 0.999) and b of an RG-LRU scan at ``(B, S, W)``."""
    return ((torch.rand(shape, generator=gen) * 0.299 + 0.7).to(device),
            (torch.randn(shape, generator=gen) * 0.1).to(device))


def _rglru_check(rglru, cases, what: str) -> float:
    """The kernel against its plain version on each ``(a, b)`` at RGLRU_TOL
    of the largest |h|; raises on a failure, else returns the
    max_abs_err."""
    failures, max_err, worst = 0, 0.0, 0.0
    for a, b in cases:
        got, want = rglru.rglru_scan(a, b), rglru.reference_rglru_scan(a, b)
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        failures += not rel <= RGLRU_TOL
        max_err, worst = max(max_err, err), max(worst, rel)
    line = (f"rglru {what}: {len(cases)} float32 cases, max error {worst!r} "
            f"of the largest |h| (limit {RGLRU_TOL}), max_abs_err {max_err!r}")
    if failures:
        raise AssertionError(f"{line}: {failures} cases past the limit")
    print(line)
    return max_err


def _rglru_check_witness(rglru, cases, what: str) -> float:
    """The kernel and its plain version against the plain version computed
    in float64: the kernel's largest error at most RGLRU_WITNESS times the
    plain version's (or eps of the largest value, where the plain version
    is exact).  Raises on a failure, else returns the max_abs_err against
    the plain version."""
    failures, max_err = 0, 0.0
    for n, (a, b) in enumerate(cases):
        got, want = rglru.rglru_scan(a, b), rglru.reference_rglru_scan(a, b)
        exact = rglru.reference_rglru_scan(a, b, dtype=torch.float64)
        top = float(exact.abs().max())
        err_k = float((got.double() - exact).abs().max())
        err_p = float((want.double() - exact).abs().max())
        limit = RGLRU_WITNESS * max(err_p, FP32_EPS * top)
        failures += not err_k <= limit
        vs_plain = float((got - want).abs().max())
        max_err = max(max_err, vs_plain)
        print(f"rglru {what}, case {n}, against float64: kernel {err_k!r} "
              f"(limit {limit!r}), plain {err_p!r}; kernel vs plain "
              f"{vs_plain!r}; largest |h| {top!r}, a in "
              f"[{float(a.min())!r}, {float(a.max())!r}]")
    if failures:
        raise AssertionError(f"rglru {what}: {failures} cases past the "
                             f"limit")
    return max_err


# ------------------------------------------------------ backward kernels --
def _flash_bwd_operands(fa, gen, shape, kw, device):
    """(q, k, v, lse, dout) at a FLASH_GENERIC shape: q, k, v and the
    cotangent random bf16, lse from the forward kernel."""
    q, k, v = _flash_operands(gen, shape, device)
    dout = torch.randn(q.shape, generator=gen).to(device, torch.bfloat16)
    _, lse = fa.flash_attention_with_lse(q, k, v, **kw)
    return q, k, v, lse, dout


FLASH_GRADS = ("dQ", "dK", "dV")


def _flash_bwd_witness(got, want, exact) -> list:
    """For each gradient: (name, the largest error of the kernel's ``got``
    and of the fp32 plain version's ``want`` against the float64 values
    ``exact``, each over the largest |exact|)."""
    rows = []
    for name, g, w, e in zip(FLASH_GRADS, got, want, exact):
        top = float(e.abs().max()) or 1.0
        rows.append((name, float((g.double() - e).abs().max()) / top,
                     float((w.double() - e).abs().max()) / top))
    return rows


def _flash_bwd_check(fa, cases, what: str, witness: bool = False) -> float:
    """The backward kernel against autograd through the plain version on
    each ``(args, kw)``: dQ, dK and dV each within FLASH_BWD_TOL of its
    largest magnitude, and a second launch the same bits.  With
    ``witness``, each case's errors of the kernel and of the plain version
    against the plain version run in float64 are printed beside the gate,
    which they do not decide.  Raises on a failure, else returns the
    max_abs_err."""
    failures, worst, max_err = 0, [0.0] * 3, 0.0
    for n, (args, kw) in enumerate(cases):
        got = fa.flash_attention_bwd(*args, **kw)
        again = fa.flash_attention_bwd(*args, **kw)
        want = fa.reference_attention_bwd(*args, **kw)
        for i, (g, a, w) in enumerate(zip(got, again, want)):
            rel = _rel(g, w)
            failures += not (rel <= FLASH_BWD_TOL and torch.equal(g, a)
                             and bool(torch.isfinite(g).all()))
            worst[i] = max(worst[i], rel)
            max_err = max(max_err, float((g.float() - w).abs().max()))
        if witness:
            exact = fa.reference_attention_bwd(*args, **kw,
                                               dtype=torch.float64)
            print(f"flash_attention_bwd {what}, case {n} (q "
                  f"{tuple(args[0].shape)}), against float64, of the "
                  f"largest magnitude: " + "; ".join(
                      f"{name} kernel {err_k!r}, plain {err_p!r}"
                      for name, err_k, err_p in _flash_bwd_witness(
                          got, want, exact)))
            del exact
    line = (f"flash_attention_bwd {what}: {len(cases)} bf16 cases, max error "
            f"of dQ, dK, dV {worst!r} of their largest magnitude (limit "
            f"{FLASH_BWD_TOL}), two launches the same bits, max_abs_err "
            f"{max_err!r}")
    if failures:
        raise AssertionError(f"{line}: {failures} gradients past the limit "
                             f"or not repeated")
    print(line)
    return max_err


def _flash_bwd_wrong_outputs(fa, args, kw) -> dict:
    """Two deliberately wrong gradients, from the plain version: dK and dV
    of the first query head of each group alone (the sum over the G heads
    of a kv head left out), and dQ of the attention without its causal
    mask."""
    q, k, v, lse, dout = args
    B, Sq, Hq, hd = q.shape
    G = Hq // k.shape[2]
    if G < 2 or not kw.get("causal", True):
        raise ValueError(f"causal GQA operands expected, got {tuple(q.shape)}"
                         f", {tuple(k.shape)}, {kw}")
    want = fa.reference_attention_bwd(*args, **kw)
    first = dout.clone().reshape(B, Sq, Hq // G, G, hd)
    first[:, :, :, 1:] = 0
    alone = fa.reference_attention_bwd(q, k, v, lse,
                                       first.reshape(dout.shape), **kw)
    no_mask = fa.reference_attention_bwd(*args, **dict(kw, causal=False))
    return {"dK and dV without the sum over the G query heads":
                (want[0], alone[1], alone[2]),
            "dQ that ignores the causal mask": (no_mask[0], want[1],
                                                want[2])}


def _flash_bwd_rejects_wrong_outputs(fa, args, kw) -> None:
    """FLASH_BWD_TOL must reject both wrong gradients of
    ``_flash_bwd_wrong_outputs`` on these operands."""
    want = fa.reference_attention_bwd(*args, **kw)
    for what, grads in _flash_bwd_wrong_outputs(fa, args, kw).items():
        errors = [_rel(g, w) for g, w in zip(grads, want)]
        if all(e <= FLASH_BWD_TOL for e in errors):
            raise AssertionError(f"FLASH_BWD_TOL passes a wrong gradient "
                                 f"({what}): {errors}")
        print(f"flash_attention_bwd check rejects a wrong output ({what}; q "
              f"{tuple(args[0].shape)}): errors of dQ, dK, dV {errors!r} of "
              f"their largest magnitude (limit {FLASH_BWD_TOL})")


def _ssd_bwd_operands(gen, shape, device):
    """(x, B, C, dt, A, gy, ghc, gdec) at an SSD_GENERIC shape: the forward's
    operands and random cotangents of its three outputs."""
    x, Bm, Cm, dt, A = _ssd_operands(gen, shape, device)
    Bsz, nc, H, Q, P = x.shape
    N = Bm.shape[-1]
    return (x, Bm, Cm, dt, A,
            *(torch.randn(s, generator=gen).to(device) for s in (
                (Bsz, nc, H, Q, P), (Bsz, nc, H, N, P), (Bsz, nc, H, Q))))


SSD_GRADS = ("dx", "dB", "dC", "ddt", "dA")


def _ssd_bwd_check(ssd, cases, what: str, witness: bool = False) -> float:
    """The backward kernel against autograd through the plain version on
    each case, a second launch the same bits: every gradient within
    SSD_BWD_TOL of its largest magnitude, or, with ``witness`` (the path's
    recorded operands, as the forward's are held), within SSD_BWD_WITNESS
    times the plain version's own error of its float64 value (or eps of
    the largest value, where the plain version is exact), the difference
    from the plain version printed.  On the path's operands the float32
    plain version is the less exact of the two in places (ddt and dA sum
    many terms that cancel), so it cannot be the yardstick there.  Raises
    on a failure, else returns the max_abs_err."""
    failures, worst, max_err = 0, [0.0] * 5, 0.0
    for n, args in enumerate(cases):
        got = ssd.ssd_intra_chunk_bwd(*args)
        again = ssd.ssd_intra_chunk_bwd(*args)
        want = ssd.reference_ssd_intra_chunk_bwd(*args)
        exact = (ssd.reference_ssd_intra_chunk_bwd(*args,
                                                   dtype=torch.float64)
                 if witness else None)
        for i, (g, a, w) in enumerate(zip(got, again, want)):
            rel = _rel(g, w)
            failures += not ((witness or rel <= SSD_BWD_TOL)
                             and torch.equal(g, a)
                             and bool(torch.isfinite(g).all()))
            worst[i] = max(worst[i], rel)
            max_err = max(max_err, float((g - w).abs().max()))
        if witness:
            rows = _ssd_bwd_witness(got, want, exact)
            failures += sum(not err <= limit for _, err, limit, _ in rows)
            print(f"ssd_bwd {what}, case {n} (x {tuple(args[0].shape)}), "
                  f"against float64: " + "; ".join(
                      f"{name} kernel {err!r} (limit {limit!r}), plain "
                      f"{err_p!r}" for name, err, limit, err_p in rows))
    limit = "held to float64 instead" if witness else f"limit {SSD_BWD_TOL}"
    line = (f"ssd_bwd {what}: {len(cases)} float32 cases, max error of "
            f"{', '.join(SSD_GRADS)} against the plain version {worst!r} of "
            f"their largest magnitude ({limit}), two launches the same "
            f"bits, max_abs_err {max_err!r}")
    if failures:
        raise AssertionError(f"{line}: {failures} gradients past a limit or "
                             f"not repeated")
    print(line)
    return max_err


def _ssd_bwd_witness(got, want, exact) -> list:
    """For each gradient: (name, the largest error of ``got`` against the
    float64 values ``exact``, its limit: SSD_BWD_WITNESS times the plain
    version ``want``'s own largest error, or eps of the largest value where
    the plain version is exact, and the plain version's error)."""
    rows = []
    for name, g, w, e in zip(SSD_GRADS, got, want, exact):
        err_k = float((g.double() - e).abs().max())
        err_p = float((w.double() - e).abs().max())
        rows.append((name, err_k, SSD_BWD_WITNESS * max(
            err_p, FP32_EPS * float(e.abs().max())), err_p))
    return rows


def _ssd_ddt_without_cumsum(ssd, args):
    """The plain version's ddt with the term through cum = cumsum(-A dt)
    left out (cum built from a detached dt), in float32."""
    x, Bm, Cm, dt, A, gy, ghc, gdec = args
    with torch.enable_grad():
        dt_ = dt.detach().float().requires_grad_()
        x32, B32, C32 = x.float(), Bm.float(), Cm.float()
        cum = torch.cumsum(dt.detach().float() * (-A.float())[
            None, None, :, None], dim=-1)
        Q = x.shape[3]
        causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                       device=x.device))
        decay = torch.exp((cum[..., :, None] - cum[..., None, :]).masked_fill(
            ~causal, float("-inf")))
        w = torch.einsum("bcqn,bckn->bcqk", C32, B32)[:, :, None] * decay \
            * dt_[:, :, :, None, :]
        y = torch.einsum("bchqk,bchkp->bchqp", w, x32)
        end = torch.exp(cum[..., -1:] - cum) * dt_
        hc = torch.einsum("bchq,bcqn,bchqp->bchnp", end, B32, x32)
        (ddt,) = torch.autograd.grad((y, hc), dt_, (gy.float(), ghc.float()))
    return ddt


def _ssd_bwd_wrong_outputs(ssd, args) -> dict:
    """Two deliberately wrong gradients, from the plain version: ddt
    without its reverse-cumsum term, and dA with its sign flipped."""
    want = list(ssd.reference_ssd_intra_chunk_bwd(*args))
    no_cum, flipped = list(want), list(want)
    no_cum[3] = _ssd_ddt_without_cumsum(ssd, args)
    flipped[4] = -want[4]
    return {"ddt without the reverse-cumsum term": no_cum,
            "dA with its sign flipped": flipped}


def _ssd_bwd_rejects_wrong_outputs(ssd, args) -> None:
    """Both gates must reject both wrong gradients of
    ``_ssd_bwd_wrong_outputs`` on these operands: SSD_BWD_TOL against the
    plain version, and the float64 witness at SSD_BWD_WITNESS."""
    want = ssd.reference_ssd_intra_chunk_bwd(*args)
    exact = ssd.reference_ssd_intra_chunk_bwd(*args, dtype=torch.float64)
    for what, grads in _ssd_bwd_wrong_outputs(ssd, args).items():
        errors = [_rel(g, w) for g, w in zip(grads, want)]
        rows = _ssd_bwd_witness(grads, want, exact)
        if all(e <= SSD_BWD_TOL for e in errors) or all(
                err <= limit for _, err, limit, _ in rows):
            raise AssertionError(f"an SSD backward gate passes a wrong "
                                 f"gradient ({what}): {errors}, {rows}")
        print(f"ssd_bwd check rejects a wrong output ({what}; x "
              f"{tuple(args[0].shape)}): errors of {', '.join(SSD_GRADS)} "
              f"{errors!r} of their largest magnitude (limit "
              f"{SSD_BWD_TOL}); against float64 " + ", ".join(
                  f"{name} {err!r} (limit {limit!r})"
                  for name, err, limit, _ in rows))


def check_generic(mods, device) -> dict:
    """Phase 3 for the kernels of paths 2-4: each against its plain version
    on random operands at shapes off the path (the backward kernels
    against autograd through theirs)."""
    gen = torch.Generator().manual_seed(2)
    return {
        "flash_attention": _flash_check(
            mods["flash_attention"], [(_flash_operands(gen, s, device),
                                       _flash_kw(s)) for s in FLASH_GENERIC],
            "generic"),
        "ssd": _ssd_check(mods["ssd"], [_ssd_operands(gen, s, device)
                                        for s in SSD_GENERIC], "generic"),
        "moe_gmm": _gmm_check(mods["moe_gmm"], [
            _gmm_operands(gen, s, device) for s in GMM_GENERIC], "generic"),
        "rglru": _rglru_check(mods["rglru"], [
            _rglru_operands(gen, s, device) for s in RGLRU_GENERIC],
            "generic"),
        "flash_attention_bwd": _flash_bwd_check(
            mods["flash_attention"], [
                (_flash_bwd_operands(mods["flash_attention"], gen, s,
                                     _flash_kw(s), device), _flash_kw(s))
                for s in FLASH_GENERIC], "generic"),
        "ssd_bwd": _ssd_bwd_check(mods["ssd"], [
            _ssd_bwd_operands(gen, s, device) for s in SSD_GENERIC],
            "generic")}


@contextlib.contextmanager
def record_calls(module, name: str, key_fn):
    """Record every call of ``module.<name>`` inside the block: a count per
    ``key_fn(*args, **kw)`` and up to RECORDED_OPERANDS clones of its
    operands per key, detached from any autograd graph.  The recorder calls
    the function it replaced, so the wrappers' launch counts are
    untouched."""
    shapes: collections.Counter = collections.Counter()
    operands: dict = collections.defaultdict(list)
    wrapped = getattr(module, name)

    def recorder(*args, **kw):
        key = key_fn(*args, **kw)
        shapes[key] += 1
        if len(operands[key]) < RECORDED_OPERANDS:
            operands[key].append((tuple(a.detach().clone()
                                        if torch.is_tensor(a) else a
                                        for a in args), dict(kw)))
        return wrapped(*args, **kw)

    setattr(module, name, recorder)
    try:
        yield shapes, operands
    finally:
        setattr(module, name, wrapped)


def _flash_key(q, k, v, *, causal=True, window=None, softcap=None,
               scale=None):
    return (*q.shape[:3], k.shape[1], k.shape[2], q.shape[3], causal, window,
            softcap)  # (B, Sq, Hq, Skv, Hkv, hd, ...)


def _ssd_key(x, Bm, Cm, dt, A):
    B, nc, H, Q, P = x.shape
    return (B, nc, H, Q, P, Bm.shape[-1])


def _flash_bwd_key(q, k, v, lse, dout, **kw):
    return _flash_key(q, k, v, **kw)


def _ssd_bwd_key(x, Bm, Cm, dt, A, gy, ghc, gdec):
    return _ssd_key(x, Bm, Cm, dt, A)


def _minplus_key(a, b):
    return (tuple(a.shape[:-2]), a.shape[-2], a.shape[-1], b.shape[-1])


def _scan_key(comp, D, tail, *, out=None):
    return tuple(comp.shape)  # (N, K, S)


def _gmm_key(x, w, activation="none"):
    return (*x.shape, w.shape[2], activation)  # (E, C, D, F, activation)


def _rglru_key(a, b):
    return tuple(a.shape)  # (B, S, W)


@contextlib.contextmanager
def record_routes(replay=None):
    """Record every MoE layer's routing inside the block: yields a list of
    ``layers.Routing``, one per layer in order.  With ``replay`` (another
    run's routings of the same layers) each layer sends its tokens to that
    run's experts instead, through ``layers.routing_of_picks``, whose
    buffer places and capacity drops must then be ``==`` that run's."""
    from repro_torch.models import layers as ML

    routes: list = []
    route = ML.moe_route

    def recorder(router, cfg, toks):
        r = route(router, cfg, toks)
        if replay is not None:
            want = replay[len(routes)]
            r = ML.routing_of_picks(r.logits, r.probs,
                                    want.idx.to(r.idx.device), r.capacity)
            if not (torch.equal(r.pos, want.pos.to(r.pos.device))
                    and torch.equal(r.keep, want.keep.to(r.keep.device))):
                raise AssertionError(f"MoE layer {len(routes)}: the replayed "
                                     f"picks give other buffer places or "
                                     f"drops")
        routes.append(r)
        return r

    ML.moe_route = recorder
    try:
        yield routes
    finally:
        ML.moe_route = route


def _rel(out, ref) -> float:
    """max |out - ref| over max |ref| (0 over no token)."""
    if not len(ref):
        return 0.0
    return float((out - ref).abs().max() / ref.abs().max())


def _moe_gate(got, own, replayed, card_routes, cpu_routes, rows: int) -> str:
    """The card-vs-CPU gate of a model with MoE layers, on the tokens
    (rows of ``rows`` sequences, each a row of ``got``): ``own`` is the
    CPU's output with its own routing, ``replayed`` with the card's expert
    picks.  Every pick of the card that the CPU's router would not make
    must be a near tie there (within CHECK_TOL of the largest |logit|),
    half the tokens at least must route alike at every layer, the tokens of
    each sequence before its first token that routes otherwise must be
    within CHECK_TOL of ``own`` (attention carries a differing pick to
    every later token of its sequence), and every token within CHECK_TOL
    of ``replayed``.  Raises on a failure, else returns the readings."""
    from repro_torch.models import layers as ML

    ra = ML.routing_agreement([(r.logits, r.idx, r.keep) for r in card_routes],
                              [(r.logits, r.idx, r.keep) for r in cpu_routes])
    first = ((~ra.agree).reshape(rows, -1).cumsum(1) == 0).flatten()
    err_first = _rel(got[first], own[first])
    err_all = _rel(got, replayed)
    line = (f"routing: {ra.flips} of {ra.picks} expert picks differ by slot, "
            f"{ra.diverged} of {len(own)} tokens keep other experts at some "
            f"layer, each first at a near tie (the largest distance of a "
            f"differing expert from the CPU's top-k cut {ra.worst_gap!r} of "
            f"the largest |logit|, limit {CHECK_TOL}), "
            f"{int(ra.agree.sum())} keep the same experts at every layer; "
            f"the {int(first.sum())} tokens before their sequence's first "
            f"that routes otherwise {err_first!r}, every token with the "
            f"card's picks replayed on the CPU {err_all!r} of the largest "
            f"magnitude (limit {CHECK_TOL})")
    if not ra.flips_are_near_ties(CHECK_TOL) \
            or 2 * int(ra.agree.sum()) < len(own):
        raise AssertionError(f"the card's routing is not the CPU's up to "
                             f"near ties; {line}")
    if not (err_first < CHECK_TOL and err_all < CHECK_TOL):
        raise AssertionError(f"card and CPU differ past the limit; {line}")
    return line


def _check_on_cpu(name, cfg, params, tokens, pos) -> None:
    """The first two groups at S = CHECK_SEQ on the card (kernels) against
    the same groups on the CPU (plain versions), within CHECK_TOL of the
    largest magnitude.  Where they hold MoE layers the CPU runs twice, with
    its own routing and with the card's expert picks replayed, and
    ``_moe_gate`` holds every token."""
    from repro_torch.models import layers as ML
    from repro_torch.models import transformer as MT

    n = 2 * len(cfg.pattern)
    sub = {"layers": params["stack"]["layers"][:n]}
    x = MT.embed_tokens(params, cfg, tokens[:, :CHECK_SEQ])
    ctx = ML.Ctx(mode="prefill", positions=pos[:, :CHECK_SEQ])
    cpu_sub = MT.tree_map(lambda t: t.cpu(), sub)
    cpu_ctx = ML.Ctx(mode="prefill", positions=ctx.positions.cpu())
    t0 = time.perf_counter()
    with record_routes() as card_routes:
        on_card, _, _ = MT.apply_stack(sub, cfg, n, cfg.pattern, x, ctx,
                                       None)
    with record_routes() as cpu_routes:
        on_cpu, _, _ = MT.apply_stack(cpu_sub, cfg, n, cfg.pattern, x.cpu(),
                                      cpu_ctx, None)
    got = on_card.float().cpu().reshape(-1, cfg.d_model)
    want = on_cpu.float().reshape(-1, cfg.d_model)
    if cpu_routes:
        with record_routes(replay=card_routes):
            replayed, _, _ = MT.apply_stack(cpu_sub, cfg, n, cfg.pattern,
                                            x.cpu(), cpu_ctx, None)
        try:
            line = _moe_gate(got, want, replayed.float().reshape(
                -1, cfg.d_model), card_routes, cpu_routes, tokens.shape[0])
        except AssertionError as e:
            raise AssertionError(f"{name}: {e}") from None
    else:
        err = _rel(got, want)
        if not err < CHECK_TOL:
            raise AssertionError(f"{name}: first two groups on the card "
                                 f"differ from the CPU by {err!r} of the "
                                 f"largest magnitude (limit {CHECK_TOL})")
        line = f"{err!r} of the largest magnitude (limit {CHECK_TOL})"
    print(f"{name}: first {n} blocks at S {CHECK_SEQ}, card (kernels) vs CPU "
          f"(plain versions) in {cfg.compute_dtype}: {line}, in "
          f"{time.perf_counter() - t0!r} s")


def run_model_path(name: str, mods: dict, device) -> dict:
    """Phase 5 for one model: plan and run its chain on ``device`` with the
    kernels' counts taken over exactly that, then the checks.  Returns the
    counts and the recorded kernel calls."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import layers as ML
    from repro_torch.models import transformer as MT
    from repro_torch.msl import ChainSimulator, plan_pipeline

    spec = MODELS[name]
    cfg = dataclasses.replace(ARCHS[name], **spec.overrides)
    B, S = spec.batch, spec.seq
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = MT.init_params(torch.Generator(device=device).manual_seed(0),
                            cfg, device=device)
    n_params = sum(t.numel() for t in MT.tree_leaves(params))
    n_bytes = sum(t.numel() * t.element_size()
                  for t in MT.tree_leaves(params))
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(1)
                           ).to(device)
    torch.cuda.synchronize()
    print(f"{name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params} parameters, {n_bytes} B ({cfg.param_dtype}, compute "
          f"{cfg.compute_dtype}; changed from the published config: "
          f"{spec.overrides or 'nothing'}) on the card in "
          f"{time.perf_counter() - t0!r} s; B {B} x S {S}")

    with contextlib.ExitStack() as stack:
        recorded = {k: stack.enter_context(record_calls(
            importlib.import_module(ks.site[0]), ks.site[1], ks.key))
            for k, ks in KERNELS.items()}
        _zero_counts(mods)
        t1 = time.perf_counter()
        pp = plan_pipeline(cfg, seq_len=S, microbatch=B, mode="IF",
                           device=device)
        t2 = time.perf_counter()
        sim = ChainSimulator(cfg, params, pp.problem.net, pp.problem.profile,
                             pp.problem.request)
        out = sim.run_plan(pp.plan, tokens)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        launches = _counts(mods)
    for k in ("minplus_scan",) + spec.kernels:
        if launches[k] == 0:
            raise AssertionError(f"{name}: path 2 launched no {k} kernel")
    for k, (shapes, _) in recorded.items():
        if sum(shapes.values()) != launches[k]:
            raise AssertionError(f"{name}: {sum(shapes.values())} recorded "
                                 f"{k} calls against {launches[k]} launches")
    print(f"{name}: plan_pipeline (bcd_torch on cuda) K {pp.K}, groups "
          f"{pp.segments} on {pp.placement}, predicted "
          f"{pp.predicted_latency_s!r} s, in {t2 - t1!r} s; chain run in "
          f"{t3 - t2!r} s; launches on path 2 {launches}")
    for t in out.traces:
        print(f"{name}: stage {t.stage} on {t.node}, groups {t.groups}: "
              f"measured compute {t.compute_s_measured!r} s, predicted "
              f"{t.compute_s_predicted!r} s; transfer charged "
              f"{t.transfer_s_charged!r} s, smashed {t.smashed_bytes!r} B")

    wall, busy, by_name = _device_us(lambda: sim.run_plan(pp.plan, tokens))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"{name}: warm chain run under the profiler: wall {wall!r} us, "
          f"device busy {busy!r} us (share {busy / wall!r}); top device "
          f"time: {top}")
    warm = sim.run_plan(pp.plan, tokens)
    for t in warm.traces:
        print(f"{name}: warm stage {t.stage}, groups {t.groups}: measured "
              f"compute {t.compute_s_measured!r} s")

    h = out.hidden
    if h.shape != (B, S, cfg.d_model) or not torch.isfinite(h).all():
        raise AssertionError(f"{name}: hidden state {tuple(h.shape)} is not "
                             f"finite of shape {(B, S, cfg.d_model)}")
    pos = torch.arange(S, device=device).expand(B, S)
    ctx = ML.Ctx(mode="prefill", positions=pos)
    mono, _, _ = MT.apply_stack(params["stack"], cfg, cfg.n_layers,
                                cfg.pattern, MT.embed_tokens(params, cfg,
                                                             tokens), ctx,
                                None)
    if not torch.equal(h, mono):
        raise AssertionError(f"{name}: the chain's hidden state differs from "
                             f"apply_stack by up to "
                             f"{float((h.float() - mono.float()).abs().max())}")
    print(f"{name}: chain's hidden state == monolithic apply_stack on the card "
          f"(max |h| {float(h.float().abs().max())!r}); peak device memory "
          f"{torch.cuda.max_memory_allocated()} B")
    _check_on_cpu(name, cfg, params, tokens, pos)
    del sim, out, warm, h, mono
    torch.cuda.empty_cache()
    serve = train = None
    if name in SERVE:
        serve = run_serve_path(name, cfg, params, SERVE[name], spec.kernels,
                               mods, device)
    if name in TRAIN:
        train = run_train_path(name, cfg, params, TRAIN[name], mods, device)
    del params
    torch.cuda.empty_cache()
    return {"launches": launches, "recorded": recorded, "serve": serve,
            "train": train}


def serve_prompts(traffic: ServeTraffic, vocab: int) -> list:
    """Path 3's prompts, from ``numpy.random.default_rng(2)``."""
    import numpy as np

    rng = np.random.default_rng(2)
    lengths = rng.integers(traffic.shortest, traffic.longest + 1,
                           traffic.batch)
    lengths[0] = traffic.longest
    return [rng.integers(1, vocab, n) for n in lengths]


def _row_err(got, want) -> torch.Tensor:
    """Per row of the last axis: max |got - want| over max |want|."""
    return (got - want).abs().amax(-1) / want.abs().amax(-1)


def _logits_at(params, cfg, tokens, first: int, n: int):
    """The cache-free forward's logits at positions first .. first+n-1,
    (B, n, V) float32, as ``logits_last`` takes them at the last one."""
    from repro_torch.models import layers as ML
    from repro_torch.models import transformer as MT

    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device).expand(B, S)
    with torch.inference_mode():
        hidden, _, _ = MT.forward(params, cfg, tokens,
                                  ML.Ctx(mode="prefill", positions=pos))
        W = MT.head_matrix(params, cfg).to(ML.cdt(cfg))
        logits = (hidden[:, first:first + n] @ W).float()
        if cfg.final_softcap:
            logits = ML.softcap(logits, cfg.final_softcap)
    return logits


@contextlib.contextmanager
def plain_kernels():
    """Inside the block the model calls each kernel's plain version at the
    site path 2 records (flash attention with fp32 p, SSD and RG-LRU in
    their plain summation orders)."""
    saved = []
    for name, spec in KERNELS.items():
        if spec.plain:
            site = importlib.import_module(spec.site[0])
            kernel = importlib.import_module(
                f"repro_torch.kernels.{_module(name)}")
            saved.append((site, spec.site[1], getattr(site, spec.site[1])))
            setattr(site, spec.site[1], getattr(kernel, spec.plain))
    try:
        yield
    finally:
        for site, name, fn in saved:
            setattr(site, name, fn)


def serve_loop(params, cfg, toks, traffic: ServeTraffic, device) -> dict:
    """``prefill`` of the padded prompts, then ``max_new - 1`` greedy
    ``decode_step``s: the served logits (B, max_new, V), the generated
    tokens (B, max_new), the last cache and the host times (the host reads
    each step's tokens once)."""
    from repro_torch import serving as SV

    B, S = toks.shape
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = SV.prefill(params, cfg, toks, traffic.cache_len)
    cur = torch.argmax(logits[:, -1], dim=-1)
    tokens = [cur.tolist()]
    prefill_ms = (time.perf_counter() - t0) * 1e3
    served, steps_ms = [logits[:, -1]], []
    for t in range(1, traffic.max_new):
        t1 = time.perf_counter()
        pos = torch.full((B, 1), S + t - 1, device=device)
        logits, cache = SV.decode_step(params, cfg, cache, cur[:, None], pos)
        cur = torch.argmax(logits[:, -1], dim=-1)
        tokens.append(cur.tolist())
        steps_ms.append((time.perf_counter() - t1) * 1e3)
        served.append(logits[:, -1])
    return {"served": torch.stack(served, dim=1),
            "generated": torch.tensor(tokens, device=device).T,
            "cache": cache, "prefill_ms": prefill_ms, "steps_ms": steps_ms}


def teacher_forced(params, cfg, toks, run: dict) -> dict:
    """One cache-free forward over prompt + generated tokens: the served
    logits' row errors against its logits at positions S-1 .. S+n-2
    (``err``, (B, n)), and the largest gap, over the greedy tokens that are
    not its argmax, between its top logit and its logit of the token, over
    the row's largest |logit| (``worst_gap``, 0 where there is none)."""
    served, generated = run["served"], run["generated"]
    S, n = toks.shape[1], generated.shape[1]
    want = _logits_at(params, cfg, torch.cat([toks, generated], dim=1),
                      S - 1, n)
    if not torch.isfinite(want).all():
        raise AssertionError("the teacher-forced forward's logits are not "
                             "finite")
    gap = (want.amax(-1) - torch.gather(want, -1, generated[..., None])[
        ..., 0]) / want.abs().amax(-1)
    other = generated != want.argmax(-1)
    return {"want": want, "err": _row_err(served, want),
            "off": int(other.sum()),
            "worst_gap": float(gap[other].max()) if other.any() else 0.0}


def run_serve_path(name: str, cfg, params, traffic: ServeTraffic,
                   kernels: tuple, mods: dict, device) -> dict:
    """Path 3 for one model, on the weights path 2 ran: the counts set to
    0, ``serve_loop``, the counts read; then the gates (any failure
    raises), each row held to its own largest |logit|:

    1. the prefill launched each of ``kernels``;
    2. the prefill's logits within CHECK_TOL of a cache-free forward over
       the prompts;
    3. teacher-forced (one cache-free forward over prompt + generated),
       at SERVE_CHECK_DEPTH pattern repetitions of the same weights (full
       width, the caches and their rings as at full depth): the served
       logits within CHECK_TOL, each greedy token the forward's argmax or
       within CHECK_TOL of it (a near tie, counted); at full depth, where
       bf16 rounding is amplified past CHECK_TOL, within FLOOR_FACTOR of
       the floor (the same forward through the kernels against through the
       plain versions, in this run) and never tighter than CHECK_TOL;
    4. ``ServingEngine.generate`` returns the loop's tokens;
    5. every logit is finite.

    Returns the counts, the recorded kernel calls and the numbers."""
    from repro_torch import serving as SV
    from repro_torch.models import transformer as MT

    t_path = time.perf_counter()
    B, n_new = traffic.batch, traffic.max_new
    prompts = serve_prompts(traffic, cfg.vocab_size)
    toks = torch.from_numpy(SV.left_pad(prompts, B)).to(device)
    S = toks.shape[1]
    torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as stack:
        recorded = {k: stack.enter_context(record_calls(
            importlib.import_module(ks.site[0]), ks.site[1], ks.key))
            for k, ks in KERNELS.items()}
        _zero_counts(mods)
        run = serve_loop(params, cfg, toks, traffic, device)
        launches = _counts(mods)
    for k in kernels:
        if launches[k] == 0:
            raise AssertionError(f"{name}: path 3's prefill launched no {k} "
                                 f"kernel")
    for k, (shapes, _) in recorded.items():
        if sum(shapes.values()) != launches[k]:
            raise AssertionError(f"{name}: {sum(shapes.values())} recorded "
                                 f"{k} calls on path 3 against {launches[k]} "
                                 f"launches")
    if not torch.isfinite(run["served"]).all():
        raise AssertionError(f"{name}: path 3 served logits that are not "
                             f"finite")
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in MT.tree_leaves(run["cache"]))
    peak = torch.cuda.max_memory_allocated()

    t2 = time.perf_counter()
    fresh = _logits_at(params, cfg, toks, S - 1, 1)[:, 0]
    err_prefill = float(_row_err(run["served"][:, 0], fresh).max())
    if not err_prefill < CHECK_TOL:
        raise AssertionError(f"{name}: the prefill's logits differ from the "
                             f"cache-free forward's by {err_prefill!r} of "
                             f"the largest (limit {CHECK_TOL})")
    full = teacher_forced(params, cfg, toks, run)
    seq = torch.cat([toks, run["generated"]], dim=1)
    with plain_kernels():
        plain = _logits_at(params, cfg, seq, S - 1, n_new)
    floor = float(_row_err(full["want"], plain).max())
    limit = max(CHECK_TOL, FLOOR_FACTOR * floor)
    err_full = float(full["err"].max())
    print(f"{name}: path 3 at full depth, teacher-forced over {S} + {n_new} "
          f"tokens: served logits vs the cache-free forward {err_full!r} of "
          f"each row's largest (prefill {float(full['err'][:, 0].max())!r}); "
          f"the floor, that forward through the kernels vs the plain "
          f"versions, {floor!r} (limit {FLOOR_FACTOR} x floor, at least "
          f"{CHECK_TOL}: {limit!r}); {full['off']} of {B * n_new} greedy "
          f"tokens off the forward's argmax (largest gap "
          f"{full['worst_gap']!r}); the prefill vs a forward over the "
          f"prompts alone {err_prefill!r}")
    if not err_full <= limit:
        raise AssertionError(f"{name}: path 3's cached decode differs from "
                             f"the teacher-forced forward past {limit!r}")
    del full, plain

    n_cut = min(cfg.n_layers, SERVE_CHECK_DEPTH * len(cfg.pattern))
    cut_cfg = dataclasses.replace(cfg, n_layers=n_cut)
    cut_params = dict(params, stack={"layers": params["stack"]["layers"][
        :n_cut]})
    cut = teacher_forced(cut_params, cut_cfg, toks, serve_loop(
        cut_params, cut_cfg, toks, traffic, device))
    err_cut = float(cut["err"].max())
    print(f"{name}: path 3 at {n_cut} layers, teacher-forced: served logits "
          f"vs the cache-free forward {err_cut!r} of each row's largest "
          f"(limit {CHECK_TOL}); {cut['off']} of {B * n_new} greedy tokens "
          f"off the forward's argmax, each a near tie (largest gap "
          f"{cut['worst_gap']!r}, limit {CHECK_TOL}); checks in "
          f"{time.perf_counter() - t2!r} s")
    if not (err_cut < CHECK_TOL and cut["worst_gap"] <= CHECK_TOL):
        raise AssertionError(f"{name}: path 3's cached decode at {n_cut} "
                             f"layers differs from the teacher-forced "
                             f"forward past {CHECK_TOL}")
    del cut

    engine = SV.ServingEngine(cfg, params, B, traffic.cache_len, eos_id=-1,
                              device=device)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    outs = engine.generate(prompts, n_new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t3
    if outs != run["generated"].tolist():
        raise AssertionError(f"{name}: ServingEngine.generate's tokens "
                             f"differ from the prefill / decode_step loop's")
    n_tok = sum(len(row) for row in outs)
    deciles = statistics.quantiles(run["steps_ms"], n=10, method="inclusive")
    p50, p90 = deciles[4], deciles[8]
    print(f"{name}: path 3 on {_card_line()}: B {B}, prompts "
          f"{[len(p) for p in prompts]} padded to {S}, {n_new} new tokens, "
          f"cache_len {traffic.cache_len}; prefill {run['prefill_ms']!r} ms; "
          f"decode step (one token for each of the {B} rows) p50 {p50!r} "
          f"ms, p90 {p90!r} ms over {len(run['steps_ms'])} steps; "
          f"ServingEngine.generate {n_tok} tokens in {gen_s!r} s = "
          f"{n_tok / gen_s!r} tokens/s, the same tokens as the loop; cache "
          f"{cache_bytes} B; peak device memory {peak} B; launches "
          f"{launches}; path 3 in {time.perf_counter() - t_path!r} s")
    return {"launches": launches, "recorded": recorded,
            "prefill_ms": run["prefill_ms"], "decode_ms_p50": p50,
            "decode_ms_p90": p90, "tokens_per_s": n_tok / gen_s,
            "cache_bytes": cache_bytes, "peak_bytes": peak}


# ------------------------------------------------------------------ path 4 --
# the block kinds that run each forward kernel of path 4's models
KERNEL_KINDS = {"flash_attention": ("attn", "local_attn", "moe", "moe_dense"),
                "ssd": ("ssd",)}


def _train_launches(cfg, kernel: str) -> tuple[int, int]:
    """A train step's (forward, backward) launches of ``kernel``: every
    layer of its kinds once each way, and the forward once more in every
    full pattern repetition that ``cfg.remat`` recomputes."""
    from repro_torch.models import transformer as MT

    full = cfg.n_layers // len(cfg.pattern) * len(cfg.pattern)
    layers = [i for i, kind in enumerate(MT.layer_kinds(cfg.n_layers,
                                                        cfg.pattern))
              if kind in KERNEL_KINDS[kernel]]
    return (sum(2 if cfg.remat and i < full else 1 for i in layers),
            len(layers))


def _charged_transfer_s(ev, path, cut_after: int, direction: str) -> float:
    """The evaluator's charge for one cut's smashed data in one direction:
    each link's transmission (``link_trans_dir_s``) plus its propagation."""
    size = ev.request.batch_size * ev.profile.cut_bytes(cut_after, direction)
    trans = prop = 0.0
    for u, v in zip(path, path[1:]):
        trans += ev.net.link_trans_dir_s(u, v, size, direction)
        prop += ev.net.links[(u, v)].delay(direction)
    return trans + prop


def _round_trip_gates(name: str, sim, plan, rt) -> str:
    """The round trip's traces in the order FW (chain order), BW (reverse),
    each charge ``==`` ``segment_comp_dir_s`` and the evaluator's transfer
    in its direction (the two directions of a cut summing to the fused
    ``cut_transfer_s``), and the event replay ``executed_round_trip_s``
    within 1e-9 of ``evaluate_round_trip``'s closed form at M 1 and 4.
    Raises on a failure, else returns a summary."""
    from repro_torch.core import BW, FW
    from repro_torch.core.trainpipe import (
        evaluate_round_trip,
        segment_comp_dir_s,
    )
    from repro_torch.msl import executed_round_trip_s

    K, ev = plan.K, sim.ev
    order = [(k, FW) for k in range(K)] + [(k, BW) for k in reversed(
        range(K))]
    if [(t.stage, t.direction) for t in rt.traces] != order:
        raise AssertionError(f"{name}: round-trip traces "
                             f"{[(t.stage, t.direction) for t in rt.traces]}"
                             f" against {order}")
    by = {}
    for t in rt.traces:
        cut = t.stage if t.direction == FW else t.stage - 1
        want_t = (_charged_transfer_s(ev, plan.paths[cut],
                                      plan.segments[cut][1], t.direction)
                  if 0 <= cut < K - 1 else 0.0)
        want_c = segment_comp_dir_s(ev, t.node, *t.groups, t.direction)
        if (t.compute_s_predicted, t.transfer_s_charged) != (want_c, want_t):
            raise AssertionError(f"{name}: round-trip stage {t.stage} "
                                 f"{t.direction} charged "
                                 f"{(t.compute_s_predicted, t.transfer_s_charged)}"
                                 f" against {(want_c, want_t)}")
        by[(t.stage, t.direction)] = t
    for c in range(K - 1):
        fused = sum(ev.cut_transfer_s(plan.paths[c], plan.segments[c][1]))
        both = (by[(c, FW)].transfer_s_charged
                + by[(c + 1, BW)].transfer_s_charged)
        if not abs(both - fused) <= 1e-12 * fused:
            raise AssertionError(f"{name}: cut {c} charged {both!r} both "
                                 f"ways against {fused!r} fused")
    replays = []
    for M in (1, 4):
        replay = executed_round_trip_s(ev, plan, M)
        closed = evaluate_round_trip(ev, plan, M).total_s
        if not abs(replay - closed) <= 1e-9 * closed:
            raise AssertionError(f"{name}: the event replay {replay!r} s "
                                 f"against the closed form {closed!r} s at "
                                 f"M {M}")
        replays.append((M, replay, closed))
    return (f"charges == segment_comp_dir_s and the evaluator's transfers; "
            f"charged FW {rt.charged_s(FW)!r} s, BW {rt.charged_s(BW)!r} s; "
            f"executed_round_trip_s vs evaluate_round_trip (M, replay, "
            f"closed) {replays}")


def _rel2(out, ref) -> float:
    """||out - ref|| / ||ref||, in float64."""
    d = (out.double() - ref.double()).norm()
    return float(d / ref.double().norm().clamp_min(1e-300))


def _train_check_on_cpu(name, cfg, params, tokens, stage) -> str:
    """The first TRAIN_CHECK_DEPTH pattern repetitions at S = CHECK_SEQ on
    the card (kernels) against the same on the CPU (plain versions): the
    round trip's ``grad_in`` through the chain's stage function (seed
    ones) within CHECK_TOL of its largest magnitude, as path 2 holds the
    forward; and every parameter's gradient in train mode (rematerialised)
    for a fixed random cotangent of the output (the head left out), each
    leaf within CHECK_TOL in 2-norm (||card - CPU|| / ||CPU||).  A
    parameter's gradient sums its terms over every token, and where they
    cancel, bf16 rounding is amplified in single elements (a bias's
    largest element can be far below the terms it sums), so the leaves
    are held as the vectors the optimizer takes; their largest element's
    error, and the same gradients through the plain versions on the card
    against the CPU (the floor of two bf16 evaluations), are printed
    beside.  Raises on a failure, else returns the readings."""
    from repro_torch.models import layers as ML
    from repro_torch.models import transformer as MT

    t0 = time.perf_counter()
    n = min(cfg.n_layers, TRAIN_CHECK_DEPTH * len(cfg.pattern))
    sub = {"layers": params["stack"]["layers"][:n]}
    cpu_sub = MT.tree_map(lambda t: t.detach().cpu(), sub)
    sub_cfg = dataclasses.replace(cfg, n_layers=n)
    toks = tokens[:, :CHECK_SEQ]
    B, S = toks.shape
    with torch.no_grad():
        x = MT.embed_tokens(params, cfg, toks)
    cot = torch.randn((B, S, cfg.d_model),
                      generator=torch.Generator().manual_seed(5))

    def grad_in(stack, h):
        h = h.detach().requires_grad_()
        with torch.enable_grad():
            out = stage(stack, h)
        return torch.autograd.grad(out, h, torch.ones_like(out))[0]

    def param_grads(stack, h):
        leaves = [t.detach().requires_grad_() for t in MT.tree_leaves(stack)]
        it = iter(leaves)
        tree = MT.tree_map(lambda _: next(it), stack)
        pos = torch.arange(S, device=h.device).expand(B, S)
        with torch.enable_grad():
            out, _, _ = MT.apply_stack(tree, sub_cfg, n, cfg.pattern, h,
                                       ML.Ctx(mode="train", positions=pos),
                                       None)
            loss = (out.float() * cot.to(h.device)).sum()
        return torch.autograd.grad(loss, leaves)

    cpu_in = grad_in(cpu_sub, x.cpu()).float()
    cpu_p = [g.float() for g in param_grads(cpu_sub, x.cpu())]
    err_in = _rel(grad_in(sub, x).float().cpu(), cpu_in)
    card_p = [g.float().cpu() for g in param_grads(sub, x)]
    with plain_kernels():
        floor_in = _rel(grad_in(sub, x).float().cpu(), cpu_in)
        floor_p = [g.float().cpu() for g in param_grads(sub, x)]
    names = [".".join(map(str, path)) for path, _ in MT.tree_paths(sub)]
    errs = [_rel2(a, b) for a, b in zip(card_p, cpu_p)]
    tops = [_rel(a, b) for a, b in zip(card_p, cpu_p)]
    floors = [_rel2(a, b) for a, b in zip(floor_p, cpu_p)]
    worst = max(range(len(errs)), key=errs.__getitem__)
    top = max(range(len(tops)), key=tops.__getitem__)
    line = (f"first {n} blocks at S {CHECK_SEQ}, card (kernels) vs CPU "
            f"(plain versions) in {cfg.compute_dtype}: grad_in {err_in!r} "
            f"of its largest magnitude (limit {CHECK_TOL}; the plain "
            f"versions on the card {floor_in!r}); the {len(errs)} parameter "
            f"gradients up to {errs[worst]!r} ({names[worst]}) in 2-norm "
            f"(limit {CHECK_TOL}; the plain versions on the card up to "
            f"{max(floors)!r}), their largest element up to {tops[top]!r} "
            f"({names[top]}) of each one's largest magnitude; in "
            f"{time.perf_counter() - t0!r} s")
    if not (err_in < CHECK_TOL and errs[worst] < CHECK_TOL):
        raise AssertionError(f"{name}: path 4's gradients on the card differ "
                             f"from the CPU's past the limit; {line}; every "
                             f"leaf: {dict(zip(names, errs))}")
    return line


def _recorded_run(mods, fn) -> tuple:
    """``fn()`` with every kernel's calls recorded and the counts set to 0
    just before it and read just after: (its result, launches, recorded),
    each kernel's recorded calls checked against its launches."""
    with contextlib.ExitStack() as stack:
        recorded = {k: stack.enter_context(record_calls(
            importlib.import_module(ks.site[0]), ks.site[1], ks.key))
            for k, ks in KERNELS.items()}
        _zero_counts(mods)
        out = fn()
        torch.cuda.synchronize()
        launches = _counts(mods)
    for k, (shapes, _) in recorded.items():
        if sum(shapes.values()) != launches[k]:
            raise AssertionError(f"{sum(shapes.values())} recorded {k} calls "
                                 f"against {launches[k]} launches")
    return out, launches, recorded


def run_train_path(name: str, cfg, params, traffic: TrainTraffic, mods: dict,
                   device) -> dict:
    """Path 4 for one model, on the weights paths 2 and 3 ran, which the
    train steps then update in place:

    1. ``plan_pipeline(mode="TR")`` and ``ChainSimulator.round_trip`` at
       full depth, the counts set to 0 just before and read just after
       (one forward and one backward launch a layer); its charges and
       event replay gated (``_round_trip_gates``); ``grad_in`` finite;
    2. ``_train_check_on_cpu`` on the same weights: grad_in and the
       parameter gradients of the first TRAIN_CHECK_DEPTH repetitions,
       card against CPU.  It runs before the steps because the weights
       they leave depend, through AdamW, on the last bits of every
       gradient the card computed: any change of a kernel's rounding moves
       the bf16 floor of card against CPU there (PERF.md, ROADMAP C3);
    3. ``traffic.steps`` steps of ``make_train_step`` with AdamW at
       TRAIN_LR on ``SyntheticLM`` batches ``batch_at(i % 2)``, counted
       likewise (``_train_launches`` a step): every loss and grad norm
       finite, and the loss on ``batch_at(0)`` lower at step 3 than at
       step 1;
    4. one more step under the profiler (device busy time and the top
       kernels).

    Returns each part's counts and recorded kernel calls, and the
    numbers."""
    from repro_torch.data import BatchSpec, SyntheticLM, shard_batch
    from repro_torch.msl import ChainSimulator, plan_pipeline
    from repro_torch.optim import make_optimizer
    from repro_torch.train import make_train_step

    t_path = time.perf_counter()
    B, S = traffic.batch, traffic.seq
    fwd, bwd = traffic.kernels
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(4)).to(
        device)
    pp = plan_pipeline(cfg, seq_len=S, microbatch=B, mode="TR", device=device)
    sim = ChainSimulator(cfg, params, pp.problem.net, pp.problem.profile,
                         pp.problem.request)
    torch.cuda.reset_peak_memory_stats()
    rt, rt_launches, rt_recorded = _recorded_run(
        mods, lambda: sim.round_trip(pp.plan, tokens))
    rt_peak = torch.cuda.max_memory_allocated()
    per_layer = _train_launches(dataclasses.replace(cfg, remat=False), fwd)
    if (rt_launches[fwd], rt_launches[bwd]) != per_layer:
        raise AssertionError(f"{name}: the round trip launched "
                             f"{rt_launches[fwd]} {fwd} and "
                             f"{rt_launches[bwd]} {bwd} kernels, not "
                             f"{per_layer}")
    gates = _round_trip_gates(name, sim, pp.plan, rt)
    if rt.grad_in.shape != (B, S, cfg.d_model) or not bool(
            torch.isfinite(rt.grad_in).all()):
        raise AssertionError(f"{name}: the round trip's grad_in "
                             f"{tuple(rt.grad_in.shape)} is not finite of "
                             f"shape {(B, S, cfg.d_model)}")
    print(f"{name}: path 4 round trip, plan_pipeline(mode=TR) K {pp.K}, "
          f"groups {pp.segments} on {pp.placement}; {gates}; grad_in "
          f"finite (max |g| {float(rt.grad_in.float().abs().max())!r}); "
          f"launches {rt_launches}; peak device memory {rt_peak} B")
    del rt
    warm = sim.round_trip(pp.plan, tokens)  # the first run grew the heap
    for t in warm.traces:
        print(f"{name}: warm round trip stage {t.stage} {t.direction} on "
              f"{t.node}, groups {t.groups}: measured compute "
              f"{t.compute_s_measured!r} s, charged compute "
              f"{t.compute_s_predicted!r} s + transfer "
              f"{t.transfer_s_charged!r} s, smashed {t.smashed_bytes!r} B")
    stage = sim._stage_fn(1, TRAIN_CHECK_DEPTH)
    measured = {d: sum(t.compute_s_measured for t in warm.traces
                       if t.direction == d) for d in ("FW", "BW")}
    del warm, sim
    torch.cuda.empty_cache()
    print(f"{name}: path 4 "
          f"{_train_check_on_cpu(name, cfg, params, tokens, stage)}")

    opt = make_optimizer(cfg.optimizer, lr=TRAIN_LR, warmup=1, total=50)
    state = opt.init(params, cfg)
    step = make_train_step(cfg, opt)
    stream = SyntheticLM(BatchSpec(B, S, cfg.vocab_size), seed=0)
    batches = [shard_batch(stream.batch_at(i), device) for i in range(2)]
    torch.cuda.reset_peak_memory_stats()

    def steps():
        nonlocal state
        losses, norms, ms = [], [], []
        for i in range(traffic.steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, state, m = step(params, state, batches[i % 2])
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return losses, norms, ms

    (losses, norms, step_ms), launches, recorded = _recorded_run(mods, steps)
    peak = torch.cuda.max_memory_allocated()
    per_step = _train_launches(cfg, fwd)
    want = tuple(traffic.steps * n for n in per_step)
    if (launches[fwd], launches[bwd]) != want:
        raise AssertionError(f"{name}: {traffic.steps} train steps launched "
                             f"{launches[fwd]} {fwd} and {launches[bwd]} "
                             f"{bwd} kernels, not {want}")
    if not all(map(math.isfinite, losses + norms)):
        raise AssertionError(f"{name}: losses {losses}, grad norms {norms} "
                             f"are not all finite")
    if not losses[2] < losses[0]:
        raise AssertionError(f"{name}: the loss on batch_at(0) did not fall "
                             f"from step 1 to step 3: {losses}")
    p50 = statistics.median(step_ms[1:])
    wall, busy, by_name = _device_us(lambda: step(params, state, batches[0]))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    print(f"{name}: one more train step under the profiler: wall {wall!r} "
          f"us, device busy {busy!r} us (share {busy / wall!r}); top device "
          f"time: {top}")
    print(f"{name}: path 4 on {_card_line()}: {traffic.steps} train steps "
          f"({cfg.optimizer}, lr {TRAIN_LR}, remat {cfg.remat}) at B {B} x S "
          f"{S}: losses {losses}, grad norms {norms}; step ms {step_ms}, p50 "
          f"over steps 2-{traffic.steps} {p50!r} ms = "
          f"{B * S / (p50 * 1e-3)!r} tokens/s; peak device memory {peak} B; "
          f"launches {launches} ({per_step} a step)")
    print(f"{name}: path 4 in {time.perf_counter() - t_path!r} s")
    del state, opt, step, batches
    torch.cuda.empty_cache()
    return {"round trip": {"launches": rt_launches, "recorded": rt_recorded},
            "train": {"launches": launches, "recorded": recorded},
            "round_trip_measured_s": measured, "round_trip_peak": rt_peak,
            "losses": losses, "grad_norms": norms, "step_ms": step_ms,
            "step_ms_p50": p50, "tokens_per_s": B * S / (p50 * 1e-3),
            "peak_bytes": peak}


def _flash_bound(key) -> tuple[float, str, int, int]:
    B, Sq, Hq, Skv, Hkv, hd, causal, window, _ = key
    qi = torch.arange(Sq)[:, None]
    ki = torch.arange(Skv)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool)
    if causal:
        mask &= qi >= ki
    if window is not None:
        mask &= qi - ki < window
    pairs = int(mask.sum())
    n_ops = 4 * B * Hq * hd * pairs  # q.k and p.v, a multiply-add each
    n_bytes = 2 * (2 * B * Sq * Hq * hd + 2 * B * Skv * Hkv * hd)
    op_ms = n_ops / BF16_OPS_PER_S * 1e3
    byte_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return (max(op_ms, byte_ms), "operations" if op_ms >= byte_ms else
            "bytes", n_ops, n_bytes)


def _ssd_work(key) -> tuple[int, int]:
    """The least work, (operations, bytes): C B^T counted once per (batch,
    chunk), as the heads share it, and every product over causal pairs
    only."""
    B, nc, H, Q, P, N = key
    pairs = Q * (Q + 1) // 2
    n_ops = (2 * N * pairs * B * nc + 2 * P * pairs * B * nc * H
             + 2 * Q * N * P * B * nc * H)
    n_bytes = 4 * (B * nc * H * Q * P * 2 + 2 * B * nc * Q * N
                   + 2 * B * nc * H * Q + H + B * nc * H * N * P)
    return n_ops, n_bytes


def _ssd_bound(key) -> tuple[float, str, int, int]:
    """The least work done as the kernel computes it: SSD_TF32_PASSES TF32
    products on the tensor cores for each fp32 product."""
    n_ops, n_bytes = _ssd_work(key)
    op_ms = SSD_TF32_PASSES * n_ops / TF32_OPS_PER_S * 1e3
    byte_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return (max(op_ms, byte_ms), "operations" if op_ms >= byte_ms else
            "bytes", n_ops, n_bytes)


def _ssd_fp32_bound(key) -> tuple[float, str]:
    """The same work at the fp32 rate outside the tensor cores: not a bound
    of this kernel (it can beat it), the yardstick of a kernel on fp32
    FMAs, printed beside the bound."""
    n_ops, n_bytes = _ssd_work(key)
    op_ms = n_ops / FP32_OPS_PER_S * 1e3
    byte_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return max(op_ms, byte_ms), "operations" if op_ms >= byte_ms else "bytes"


def _gmm_bound(key) -> tuple[float, str, int, int]:
    """Every row of the buffers, filled or not, as the function computes
    them: 2 E C D F operations, x and w read and the output written once."""
    E, C, D, F_, _ = key
    n_ops = 2 * E * C * D * F_
    n_bytes = 2 * (E * C * D + E * D * F_ + E * C * F_)
    op_ms = n_ops / BF16_OPS_PER_S * 1e3
    byte_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return (max(op_ms, byte_ms), "operations" if op_ms >= byte_ms else
            "bytes", n_ops, n_bytes)


def _rglru_bound(key) -> tuple[float, str, int, int]:
    """a and b read and h written once; a multiply-add per element."""
    n = key[0] * key[1] * key[2]
    n_ops, n_bytes = 2 * n, 12 * n
    op_ms = n_ops / FP32_OPS_PER_S * 1e3
    byte_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return (max(op_ms, byte_ms), "operations" if op_ms >= byte_ms else
            "bytes", n_ops, n_bytes)


def _flash_bwd_bound(key) -> tuple[float, str, int, int]:
    """Five products over the visible pairs (S = Q K^T, dP = dO V^T, dV =
    P^T dO, dQ = dS K, dK = dS^T Q), 2.5 times the forward's operations;
    q, k, v, dO and lse read and dQ, dK, dV written once."""
    B, Sq, Hq, Skv, Hkv, hd = key[:6]
    _, _, fwd_ops, _ = _flash_bound(key)
    n_ops = fwd_ops * 5 // 2
    q_bytes, kv_bytes = 2 * B * Sq * Hq * hd, 2 * B * Skv * Hkv * hd
    n_bytes = (2 * q_bytes + 2 * kv_bytes + 4 * B * Hq * Sq
               + q_bytes + 2 * kv_bytes)
    op_ms = n_ops / BF16_OPS_PER_S * 1e3
    byte_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return (max(op_ms, byte_ms), "operations" if op_ms >= byte_ms else
            "bytes", n_ops, n_bytes)


def _ssd_bwd_work(key) -> tuple[int, int]:
    """The least work of the backward, its products counted as
    ``_ssd_work`` counts the forward's (over causal pairs; the head-free
    C B^T, dC = (sum_h dS) B and dB = (sum_h dS)^T C once per (batch,
    chunk)): C B^T, dC and dB; G = gy x^T and W^T gy per head; the chunk
    states' ghc^T B and ghc x per head.  Operands and cotangents read and
    gradients written once."""
    B, nc, H, Q, P, N = key
    pairs = Q * (Q + 1) // 2
    n_ops = (3 * 2 * N * pairs * B * nc + 2 * 2 * P * pairs * B * nc * H
             + 2 * 2 * Q * N * P * B * nc * H)
    reads = (2 * B * nc * H * Q * P + 2 * B * nc * Q * N
             + 2 * B * nc * H * Q + H + B * nc * H * N * P)
    writes = B * nc * H * Q * P + 2 * B * nc * Q * N + B * nc * H * Q + H
    return n_ops, 4 * (reads + writes)


def _ssd_bwd_bound(key) -> tuple[float, str, int, int]:
    """The least work at the forward's rate: SSD_TF32_PASSES TF32 products
    on the tensor cores for each fp32 product (fp32 accuracy)."""
    n_ops, n_bytes = _ssd_bwd_work(key)
    op_ms = SSD_TF32_PASSES * n_ops / TF32_OPS_PER_S * 1e3
    byte_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return (max(op_ms, byte_ms), "operations" if op_ms >= byte_ms else
            "bytes", n_ops, n_bytes)


def _ssd_bwd_fp32_bound(key) -> tuple[float, str]:
    """The same work at the fp32 rate outside the tensor cores, the rate
    the first, plain SIMT version computed at: printed beside the bound."""
    n_ops, n_bytes = _ssd_bwd_work(key)
    op_ms = n_ops / FP32_OPS_PER_S * 1e3
    byte_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return max(op_ms, byte_ms), "operations" if op_ms >= byte_ms else "bytes"


def _flash_path_check(fa, recorded, random) -> float:
    err = _flash_check(fa, recorded + random, "at path 2's shapes (recorded "
                       "operands and random)")
    _flash_rejects_wrong_outputs(fa, *next(
        case for case in recorded if case[1].get("causal", True)
        and not case[1].get("window") and not case[1].get("softcap")))
    return err


def _gmm_path_check(gmm, recorded, random) -> float:
    err = _gmm_check(gmm, recorded + random, "at path 2's shapes (recorded "
                     "operands and random)")
    _gmm_rejects_wrong_outputs(gmm, *recorded[0])
    return err


def _rglru_path_check(rglru, recorded, random) -> float:
    err = _rglru_check_witness(rglru, [args for args, _ in recorded],
                               "recorded at path 2's shapes")
    return max(err, _rglru_check(rglru, [args for args, _ in random],
                                 "random at path 2's shapes"))


def _ssd_path_check(ssd, recorded, random) -> float:
    err = _ssd_check_witness(ssd, [args for args, _ in recorded],
                             "recorded at path 2's shapes")
    _ssd_rejects_wrong_outputs(ssd, recorded[0][0])
    return max(err, _ssd_check(ssd, [args for args, _ in random],
                               "random at path 2's shapes"))


def _flash_bwd_path_check(fa, recorded, random) -> float:
    err = max(_flash_bwd_check(fa, recorded, "recorded at path 4's shapes",
                               witness=True),
              _flash_bwd_check(fa, random, "random at path 4's shapes"))
    _flash_bwd_rejects_wrong_outputs(fa, *next(
        case for case in recorded if case[1].get("causal", True)
        and case[0][0].shape[2] > case[0][1].shape[2]))
    return err


def _ssd_bwd_path_check(ssd, recorded, random) -> float:
    err = _ssd_bwd_check(ssd, [args for args, _ in recorded],
                         "recorded at path 4's shapes", witness=True)
    _ssd_bwd_rejects_wrong_outputs(ssd, recorded[0][0])
    return max(err, _ssd_bwd_check(ssd, [args for args, _ in random],
                                   "random at path 4's shapes"))


def _flash_library(args, kw):
    """One ``scaled_dot_product_attention`` call on the same operands, the
    library yardstick (never called by the port): causal, or with the
    causal window as a boolean mask; None where the options have no such
    call (a softcap, or no causal mask)."""
    if not kw.get("causal", True) or kw.get("softcap"):
        return None
    qt, kt, vt = (t.transpose(1, 2) for t in args)
    window = kw.get("window")
    if window is None:
        return lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=True, enable_gqa=True).transpose(1, 2)
    qi = torch.arange(qt.shape[2], device=qt.device)[:, None]
    ki = torch.arange(kt.shape[2], device=qt.device)[None, :]
    mask = (qi >= ki) & (qi - ki < window)
    return lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask, enable_gqa=True).transpose(1, 2)


def _flash_bwd_library(args, kw):
    """The backward of one ``scaled_dot_product_attention`` call on the same
    operands (its forward run once beforehand), the library yardstick of
    the backward kernel (never called by the port); None where the
    forward has no such call."""
    q, k, v, _, dout = args
    if _flash_library((q, k, v), kw) is None:
        return None
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        out = _flash_library(leaves, kw)()

    def grads():
        return tuple(torch.autograd.grad(out, leaves, dout,
                                         retain_graph=True))

    return grads


def _gmm_library(args, kw):
    """One ``torch.bmm`` (with the activation, for the gate) on the same
    operands, the library yardstick (never called by the port)."""
    x, w = args
    act = {"none": lambda t: t, "silu": F.silu,
           "gelu": lambda t: F.gelu(t, approximate="tanh")}[
        kw.get("activation", "none")]
    return lambda: act(torch.bmm(x, w))  # noqa: E731


class Kernel(NamedTuple):
    """What the script knows of one kernel: where it comes from, where path
    2 calls it (the function recorded), and, for the kernels of path 2's
    models, how it is checked, timed and bounded at the recorded shapes."""
    source: str
    replaces: str
    site: tuple[str, str]   # (module, name) of the call that is recorded
    key: Callable           # a recorded call -> its shape key
    profiled: str = ""      # part of the kernel's name in the profiler
    wrapper: str = ""       # the wrapper's and the plain version's names
    plain: str = ""
    random_operands: Callable | None = None  # (gen, key, kw, device)
    check: Callable | None = None  # (module, recorded, random) -> max err
    bound: Callable | None = None  # key -> (ms, by, operations, bytes)
    library: Callable = lambda args, kw: None  # noqa: E731
    # key -> (ms, by) of the same work at the fp32 rate, or None
    fp32_bound: Callable = lambda key: None  # noqa: E731
    module: str = ""  # module of repro_torch.kernels, if not the kernel's name
    counter: str = "launch_count"  # the module's count of this kernel


def _tuple(out) -> tuple:
    """A kernel's result as a tuple of tensors (a backward gives three or
    five)."""
    return tuple(out) if isinstance(out, (tuple, list)) else (out,)


def _module(name: str) -> str:
    return KERNELS[name].module or name


def _zero_counts(mods: dict) -> None:
    for name, spec in KERNELS.items():
        setattr(mods[_module(name)], spec.counter, 0)


def _counts(mods: dict) -> dict:
    """Each kernel's launches since its count was last set to 0."""
    return {name: getattr(mods[_module(name)], spec.counter)
            for name, spec in KERNELS.items()}


KERNELS = {
    "minplus_scan": Kernel(
        "src/repro_torch/kernels/csrc/minplus.cu",
        "src/repro/kernels/minplus.py:35",
        ("repro_torch.core.torch_solvers", "minplus_scan"), _scan_key,
        module="minplus", counter="scan_launch_count"),
    "minplus": Kernel(
        "src/repro_torch/kernels/csrc/minplus.cu",
        "src/repro/kernels/minplus.py:35",
        ("repro_torch.kernels.minplus", "minplus_matmul"), _minplus_key,
        module="minplus"),
    "flash_attention": Kernel(
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:29",
        ("repro_torch.models.layers", "flash_attention"), _flash_key,
        "flash_attention_kernel", "flash_attention", "reference_attention",
        lambda gen, s, kw, device: (_flash_operands(
            gen, (s[0], s[1], s[3], s[2], s[4], s[5]), device), kw),
        _flash_path_check, _flash_bound, _flash_library),
    "ssd": Kernel(
        "src/repro_torch/kernels/csrc/ssd.cu",
        "src/repro/kernels/ssd.py:25",
        ("repro_torch.kernels.ops", "ssd_intra_chunk"), _ssd_key,
        "ssd_intra_chunk_kernel", "ssd_intra_chunk",
        "reference_ssd_intra_chunk",
        lambda gen, s, kw, device: (_ssd_operands(
            gen, (s[0], s[1] * s[3], s[2], s[4], s[5], s[3]), device), kw),
        _ssd_path_check, _ssd_bound, fp32_bound=_ssd_fp32_bound),
    "moe_gmm": Kernel(
        "src/repro_torch/kernels/csrc/moe_gmm.cu",
        "src/repro/kernels/moe_gmm.py:22",
        ("repro_torch.models.layers", "expert_matmul"), _gmm_key,
        "expert_matmul_kernel", "expert_matmul", "reference_expert_matmul",
        lambda gen, s, kw, device: _gmm_operands(gen, s, device),
        _gmm_path_check, _gmm_bound, _gmm_library),
    "rglru": Kernel(
        "src/repro_torch/kernels/csrc/rglru.cu",
        "src/repro/kernels/rglru.py:23",
        ("repro_torch.models.layers", "rglru_scan"), _rglru_key,
        "rglru_chunk", "rglru_scan", "reference_rglru_scan",
        lambda gen, s, kw, device: (_rglru_operands(gen, s, device), kw),
        _rglru_path_check, _rglru_bound),
    # the backward kernels (path 4): the gradients of the TPU kernels, which
    # have none of their own
    "flash_attention_bwd": Kernel(
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention.py:29",
        ("repro_torch.kernels.flash_attention", "flash_attention_bwd"),
        _flash_bwd_key, "flash_bwd_", "flash_attention_bwd",
        "reference_attention_bwd",
        lambda gen, s, kw, device: (_flash_bwd_operands(
            importlib.import_module("repro_torch.kernels.flash_attention"),
            gen, (s[0], s[1], s[3], s[2], s[4], s[5]), kw, device), kw),
        _flash_bwd_path_check, _flash_bwd_bound, _flash_bwd_library,
        module="flash_attention", counter="bwd_launch_count"),
    "ssd_bwd": Kernel(
        "src/repro_torch/kernels/csrc/ssd_bwd.cu",
        "src/repro/kernels/ssd.py:25",
        ("repro_torch.kernels.ssd", "ssd_intra_chunk_bwd"), _ssd_bwd_key,
        "ssd_bwd_", "ssd_intra_chunk_bwd", "reference_ssd_intra_chunk_bwd",
        lambda gen, s, kw, device: (_ssd_bwd_operands(
            gen, (s[0], s[1] * s[3], s[2], s[4], s[5], s[3]), device), kw),
        _ssd_bwd_path_check, _ssd_bwd_bound, fp32_bound=_ssd_bwd_fp32_bound,
        module="ssd", counter="bwd_launch_count"),
}


def check_model_path(name: str, mod, recorded, launches_by_path: dict,
                     generic_err: float, device) -> dict:
    """Phase 6 for a kernel of paths 2 and 3: the kernel against its plain
    version at every shape they launched (recorded operands and random ones),
    then each shape timed.  Returns the kernels-line entry: the numbers of
    the shape with the most launches, and every shape's under ``shapes``."""
    spec = KERNELS[name]
    shapes, operands = recorded
    gen = torch.Generator().manual_seed(3)
    order = sorted(shapes, key=lambda s: (-shapes[s], str(s)))
    err = spec.check(mod, [case for s in order for case in operands[s]],
                     [spec.random_operands(gen, s, operands[s][0][1], device)
                      for s in order])
    rows = {}
    for s in order:
        args, kw = operands[s][0]
        wrapper, plain = getattr(mod, spec.wrapper), getattr(mod, spec.plain)
        ms = _kernel_device_ms(lambda: wrapper(*args, **kw), 20,
                               spec.profiled)
        plain_ms = _kernel_device_ms(lambda: plain(*args, **kw), 20, None)
        held_ms = _held_queue_ms(lambda: wrapper(*args, **kw), 20)
        bound, by, n_ops, n_bytes = spec.bound(s)
        library = spec.library(args, kw)
        library_ms = None
        if library is not None:
            lib_err = max(float((a.float() - b.float()).abs().max())
                          for a, b in zip(_tuple(library()),
                                          _tuple(plain(*args, **kw))))
            library_ms = _kernel_device_ms(library, 20, None)
            print(f"{name} {s}: library yardstick (never called by the port) "
                  f"{library_ms!r} ms, max_abs_err vs plain {lib_err!r}")
        rate, share = n_ops / (ms * 1e-3), bound / ms
        byte_rate = n_bytes / (ms * 1e-3)
        rows[s] = {"shape": list(s), "launches": shapes[s], "ms": ms,
                   "plain_ms": plain_ms, "held_ms": held_ms,
                   "bound_ms": bound, "bound_by": by,
                   "library_ms": library_ms, "ops_per_s": rate,
                   "bytes_per_s": byte_rate, "bound_share": share}
        fp32 = spec.fp32_bound(s)
        if fp32 is not None:
            rows[s].update(fp32_bound_ms=fp32[0], fp32_bound_by=fp32[1],
                           fp32_bound_share=fp32[0] / ms)
            print(f"{name} {s}: the same work at the fp32 rate outside the "
                  f"tensor cores would take {fp32[0]!r} ms by {fp32[1]}: "
                  f"{fp32[0] / ms!r} of the kernel's time")
        print(f"{name} {s}, {shapes[s]} launches on paths 2-3: device time "
              f"per launch (torch.profiler) kernel {ms!r} ms, plain "
              f"{plain_ms!r} "
              f"ms, library {library_ms!r} ms; kernel on a held stream "
              f"(CUDA events) {held_ms!r} ms; bound {bound!r} ms by {by} "
              f"({n_ops} operations, {n_bytes} B); achieved "
              f"{rate / 1e12!r} T operations/s, {byte_rate / 1e12!r} TB/s, "
              f"{share!r} of the bound")
    top = rows[order[0]]
    return {"name": name, "route": "cuda", "source": spec.source,
            "replaces": spec.replaces,
            "launches": sum(launches_by_path.values()),
            "max_abs_err": max(err, generic_err), "mismatches": 0,
            **{k: v for k, v in top.items() if k != "launches"},
            "launches_by_path": launches_by_path,
            "shapes": [rows[s] for s in order]}


def _merge(recorded: list) -> tuple:
    """One kernel's recorded calls of several models, as one record."""
    shapes: collections.Counter = collections.Counter()
    operands: dict = {}
    for s, ops in recorded:
        shapes.update(s)
        operands.update(ops)
    return shapes, operands


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core as C
    import repro_torch.core.torch_solvers as TS

    t_start = time.perf_counter()
    device = torch.device("cuda")
    card = _card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card}; torch {torch.__version__}, cuda "
          f"{torch.version.cuda}; TF32 off for float32 products")

    mods = {m: importlib.import_module(f"repro_torch.kernels.{m}")
            for m in dict.fromkeys(map(_module, KERNELS))}
    mp = mods["minplus"]
    build_kernels(mods)
    matmul = check_minplus_matmul(mp, device)
    generic_new = check_generic(mods, device)

    path = run_main_path(C, TS, mp)
    stack = run_serve_stack_path(C, TS, mp)
    sweep = run_sweep_path(C, TS, mp, card=card)
    by_model = {}
    for name in MODELS:
        by_model[name] = run_model_path(name, mods, device)
    matmul["launches_by_path"] = {
        "planner": path["matmul_launches"],
        "serve-stack": stack["matmul_launches"],
        "sweep": sweep["matmul_launches"], **{
            name: by_model[name]["launches"]["minplus"] for name in MODELS}}
    matmul["launches"] = sum(matmul["launches_by_path"].values())
    print(f"clocks before the kernel timings (sm, max sm, temperature): "
          f"{_clocks_line()}")
    time_minplus_matmul(mp, device, matmul)
    kernels = [check_scan_path(
        mp, device, _merge([path["recorded"], stack["recorded"],
                            sweep["recorded"]] + [
            by_model[name]["recorded"]["minplus_scan"] for name in MODELS]),
        {"planner": path["launches"], "serve-stack": stack["launches"],
         "sweep": sweep["launches"], **{
            name: by_model[name]["launches"]["minplus_scan"]
            for name in MODELS}}, _top_shape(path["recorded"][0])), matmul]
    print(f"clocks after the minplus_scan timings (sm, max sm, "
          f"temperature): {_clocks_line()}")
    for kernel in ("flash_attention", "ssd", "moe_gmm", "rglru",
                   "flash_attention_bwd", "ssd_bwd"):
        runs = []
        for m, spec in MODELS.items():
            res = by_model[m]
            if kernel in spec.kernels:
                runs.append((m, res))
                if res["serve"] is not None:
                    runs.append((f"serve/{m}", res["serve"]))
            if res["train"] is not None and kernel in TRAIN[m].kernels:
                runs += [(f"{part}/{m}", res["train"][part])
                         for part in ("round trip", "train")]
        kernels.append(check_model_path(
            kernel, mods[_module(kernel)],
            _merge([run["recorded"][kernel] for _, run in runs]),
            {path: run["launches"][kernel] for path, run in runs},
            generic_new[kernel], device))
        print(f"clocks after the {kernel} timings (sm, max sm, "
              f"temperature): {_clocks_line()}")

    order = ["name", "route", "source", "replaces", "launches", "mismatches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "ops_per_s", "bytes_per_s", "bound_share",
             "fp32_bound_ms", "fp32_bound_by", "fp32_bound_share", "shape",
             "launches_by_path", "call_ms", "plain_call_ms", "held_ms",
             "note", "shapes"]
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start!r} s")
    print(json.dumps({"kernels": [{k: kern[k] for k in order if k in kern}
                                  for kern in kernels]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
