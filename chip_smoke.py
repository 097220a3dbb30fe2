#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's nine paths once on an NVIDIA GPU; check them.

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

Path 3 is serving, inside the turns of all four models on the same
weights (SERVE): ``repro_torch.serving.prefill`` of left-padded prompts
through the flash, SSD, RG-LRU and expert-matmul kernels, then greedy
``decode_step``s over the KV rings and the SSD and RG-LRU states, in plain
PyTorch but for qwen3-moe-30b-a3b's expert products (three expert-matmul
launches an MoE layer in every step: 32 prompts of 128-960 tokens, each
step routing its 32 tokens at capacity 2), then ``ServingEngine.generate``
on the same prompts.

Path 4 is training (float32 weights, bf16 compute; TRAIN): inside the
turns of qwen2-1.5b and mamba2-370m after path 3, on the same weights at
full depth, B 2 x S 2048; inside the turns of qwen3-moe-30b-a3b and
recurrentgemma-9b after path 7's forward, once path 2's weights are freed,
on fresh seeded weights at full width and reduced depth (4 of 48 layers at
B 2 x S 2048; 6 of 38 at B 1 x S 4096): ``plan_pipeline(mode="TR")`` and
``ChainSimulator.round_trip`` (each stage forward under autograd, then the
backward wave in reverse chain order), then four steps of
``repro_torch.train.make_train_step`` with AdamW on ``SyntheticLM``
batches, through the forward kernels and the backward kernels of flash
attention, SSD, the expert matmul and the RG-LRU scan
(``csrc/flash_attention_bwd.cu``, ``csrc/ssd_bwd.cu``,
``csrc/moe_gmm_bwd.cu``, ``csrc/rglru_bwd.cu``).

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

Path 7 is the pipeline runtime, inside every model's turn (PIPELINE):
right after path 2, on its weights, ``plan_pipeline(mode="TR")`` at a
microbatch of B / PIPE_MICRO rows and ``msl.pipeline_forward`` of the
batch in PIPE_MICRO microbatches through the plan's stages (recurrentgemma-9b
at B 2 x S 4096, its two remainder layers a 13th group); for the models of
TRAIN right after path 4, PIPE_STEPS steps of
``msl.make_pipeline_train_step`` from the seeded weights; after the last
model, ``repro_torch.launch.train`` (``--mode msl-pp``, straight and
resumed) and ``repro_torch.launch.serve`` at ``--reduced`` (the JAX
package's reduced config, head width 16).

Path 8 is the encoder-decoder and vision families, after path 7 (CROSS):
whisper-small at its published size (12 encoder and 12 decoder layers,
d 768; B 8 x 1500 frames of memory, B 8 x 448 tokens) and
llama-3.2-vision-90b at full width and 30 of its 100 layers (6 repetitions
of attn x 4, xattn; bf16 weights, 55.5 GB; B 1 x 4096 patches, B 1 x 2048
tokens), random weights from seed 0 with every cross-attention gate
``xgate`` opened to CROSS_XGATE (it is 0 at init, which takes out every
cross output): ``forward(memory=...)`` through the flash kernel (the
encoder's non-causal blocks, the decoder's self- and cross-attention at
Sq != Skv), serving (``prefill(memory=...)``, then greedy ``decode_step``s
over the cross K/V the prefill projected, one flash launch at Sq 1 a cross
block), and whisper's training (AdamW steps with memory, through the flash
backward).

Path 9 is the dry run of H100 clusters (``repro_torch.launch.dryrun``),
after path 8, on the host and never on the card: two full-width cells of
the single mesh (DRYRUN_CELLS: 256 cards over a fake process group),
each ``ok`` with FLOPs, bytes and collective bytes above 0 and its
per-card FLOPs within DRYRUN_BAND of the model's share; and path 4's
qwen2-1.5b step and path 3's qwen3-moe-30b-a3b decode step dry-run on a
one-rank mesh, their argument bytes ``==`` the storages of the card's
arguments, their compute term at least the model's FLOPs at the card's
peak over ONE_CARD_SLACK, and the card's p50 at least the dry run's
bound (the larger of its compute and memory terms).  The four dry runs
run in subprocesses started together just before path 8, on the host
while the card runs path 8; their gates come after it.

The lint phase is the port's repro-lint (``python -m repro_torch.analysis
--strict src/repro_torch``, pure stdlib) on the host, never the card: a
subprocess started with the smoke, beside the card paths, that must exit
0 under ``lint_baseline_torch.txt``; it is gated before the summary, its
findings, files and wall printed on a line of their own.

Phases, in order; any failure exits non-zero:

1. device: a CUDA card is required; its name and power limit are printed;
   TF32 is switched off for float32 products and convolutions;
2. build: every kernel is built from the sources in the checkout, one
   ``nvcc`` per source, all started together (sm_90a, ``build/kernels/``);
3. kernel vs plain, generic: the min-plus product (``minplus_matmul``, no
   longer launched on a path) held with ``==`` against its plain version
   (ties, +inf holes, off-tile shapes, EXTRA_SHAPE); flash attention in bf16 at FLASH_TOL, SSD in float32 at
   SSD_TOL, the expert matmul in bf16 at GMM_TOL and the RG-LRU scan at
   RGLRU_TOL (two launches the same bits), at ``tests/test_kernels.py``'s
   shapes and a few more (for the RG-LRU scan a W off 4, an S off its
   stage and a base off 16 bytes, which take its ``cp.async`` route); the
   backward kernels against autograd through the plain versions, flash at
   FLASH_BWD_TOL on FLASH_GENERIC, SSD at SSD_BWD_TOL on SSD_GENERIC, the
   expert matmul at GMM_BWD_TOL on GMM_GENERIC and the RG-LRU scan at
   RGLRU_BWD_TOL on RGLRU_GENERIC, each twice with the same bits;
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
   the loop's, every logit finite.  An MoE layer takes its capacity over
   a call's own tokens, so for qwen3-moe a cached decode and a cache-free
   forward rightly drop other slots, and the gates know the routing: the
   launches call by call (the prefill flash once and the expert matmul
   three times a layer, every decode step the expert matmul three times a
   layer and flash never), every layer call's capacity and drops the
   reference's over its own tokens; at full depth the served logits
   within FLOOR_FACTOR of the floor of the same cached decode through the
   plain versions with the served picks replayed; once the other layers'
   weights are freed (``run_moe_serve_cut``), at SERVE_CHECK_DEPTH
   repetitions with ``capacity_factor`` E / k (no slot can drop) on as
   many rows as fit, the cached decode against the teacher-forced forward
   route-aware (``_moe_gate``: the forward with the decode's picks
   replayed for every output), and card against CPU at the config's
   capacity over all rows, the CPU's plain prefill and first
   SERVE_CPU_STEPS decode steps fed the card's tokens, with its own
   routing and with the card's picks replayed call by call; its prefill
   ms, decode ms a step (p50, p90) beside the step's byte bound (weights,
   head and cache at HBM_BYTES_PER_S), tokens/s, cache bytes and peak
   memory printed beside the card; then path 4 where the model trains
   (``run_train_path``; for qwen3-moe and recurrentgemma after path 7's
   forward, ``run_fresh_train_path``: the training state counted and held
   to the card's free memory before fresh weights are drawn): the round
   trip with the counts set to 0 just before and read just after (one
   forward and one backward launch a layer of each kernel's kinds, three
   of the expert matmul's), its traces FW then BW, every charge ``==``
   ``segment_comp_dir_s`` and the evaluator's transfer in its direction,
   ``executed_round_trip_s`` within 1e-9 of ``evaluate_round_trip``,
   ``grad_in`` finite, each stage's measured FW and BW compute printed
   beside its charge; on the same weights, the first TRAIN_CHECK_DEPTH
   repetitions at S CHECK_SEQ, card (kernels) against CPU (plain
   versions): the round trip's ``grad_in`` and every parameter's gradient
   within CHECK_TOL, or GRAD_FLOOR_FACTOR times the plain versions' own
   distance from the CPU where that passes CHECK_TOL (every leaf printed
   by name beside it; MoE route-aware: the CPU replays the card's expert
   picks, its own router flipping them at near ties only); four train steps counted likewise (twice the
   forward launches under remat and one backward each), every loss and
   grad norm finite, the loss on ``batch_at(0)`` lower at step 3 than at
   step 1, the step's p50 ms over steps 2-4, tokens/s and peak memory
   printed; then path 7's pipelined forward (``run_pipeline_path``, after
   path 2's checks): the counts set to 0 just before the plan and read
   just after the forward, each microbatch's hidden state ``==``
   ``T.forward`` of its rows and the aux ``==`` theirs over M + K - 1, each
   kernel launched as in those forwards, the whole batch's forward within
   CHECK_TOL (MoE: printed at full depth, gated route-aware at
   TRAIN_CHECK_DEPTH repetitions); and after path 4 its train steps
   (``run_pipeline_train_path``): the pipelined loss and gradients at
   TRAIN_CHECK_DEPTH repetitions within CHECK_TOL of ``loss_fn``'s, the
   steps' launches counted (two forward and one backward a layer and
   microbatch), finite, the loss on ``batch_at(0)`` falling, the p50,
   tokens/s and peak printed beside path 4's; the model freed before the
   next; after the last model, the launchers (``run_launch_path``): the
   resumed run's final checkpoint ``==`` the straight run's, the flash
   forward and backward counted; then path 8 (``run_cross_path``), one
   model after the other: the parameters counted before they are
   allocated, the forward with the counts set to 0 just before and read
   just after (one flash launch an encoder layer, a self- and a
   cross-attention), the first SERVE_CHECK_DEPTH repetitions card
   (kernels) vs CPU (plain versions) within CHECK_TOL, the gates shown to
   gate (closed: two memories give ``==`` hidden states; open: they
   differ), path 3's serving gates over the memory (``generate`` raises,
   as the JAX package's takes no memory), a decode step ``==`` itself with
   the cache's memory zeroed (the cross K/V reused), and whisper's
   gradients at TRAIN_CHECK_DEPTH repetitions card vs CPU within CHECK_TOL
   (encoder and gates among them), then its 4 AdamW steps counted, the
   loss falling;
6. the min-plus product timed at EXTRA_SHAPE; kernel vs plain at the
   shapes of paths 1-3 and 5-8, on the recorded operands and random ones:
   the scan ``==`` its plain version at every shape paths 1, 2 and 5-7
   gave it (recorded, random with +inf holes and an all-+inf tour,
   tie-forcing) and at SCAN_GENERIC (K 1 and 2, S past a warp), then each
   path shape timed as below; flash attention at FLASH_TOL, which must also
   reject two wrong
   outputs (l off by 5 %, each row's diagonal key tile dropped); SSD's y and
   chunk states, and the RG-LRU scan, on the recorded operands against a
   float64 witness, at SSD_WITNESS and RGLRU_WITNESS times the plain
   version's own error (random operands at SSD_TOL and RGLRU_TOL), and the
   SSD witness must also reject two wrong outputs (one head with its
   neighbour's dt and A, each query tile's diagonal score tile dropped), and
   both RG-LRU gates three (the state restarted every RGLRU_STAGE steps, a
   slab carrying the previous slab's state, the last stage unwritten); the
   expert matmul at GMM_TOL, which must also reject two wrong outputs (one
   GMM_TILE slice of D left out, one counted twice); then each shape timed
   by ``torch.profiler`` device time (a time on a held stream by CUDA
   events beside it, the clock used when the profiler loses events in
   every window) beside its plain version, its bound, the operations and
   bytes per second it achieved and its share of the bound (SSD's bound is
   its TF32 tensor-core work; the same work at the fp32 rate is printed
   beside it), and its library
   yardstick (``scaled_dot_product_attention`` for flash attention,
   ``torch.bmm`` with the activation for the expert matmul, whose launch
   as the forward under grad, writing Z beside its output, is timed too;
   SSD and RG-LRU have no single library call), with the SM clock, its
   maximum and the temperature sampled before and after the timings; the backward kernels
   likewise at path 4's shapes (recorded operands and random, flash's
   rejecting dK and dV without the sum over the G query heads and a dQ
   that ignores the causal mask, with the kernel's and the fp32 plain
   version's errors against the plain version in float64 printed beside
   its gate on the recorded operands, SSD's held to its float64 witness at
   SSD_BWD_WITNESS and rejecting ddt without its reverse-cumsum term and
   dA with its sign flipped), the expert matmul's from the forward
   kernel's Z (that Z first held to the launch without it bit for bit and
   to the plain version at GMM_TOL) at GMM_BWD_TOL against the plain
   version and held to float64 at GMM_BWD_WITNESS, both from Z formed from
   x and w in their own type (rejecting dW without act', dX through W
   un-transposed, act' of Y instead of Z, and the kernel given Y or the
   next expert's Z as its Z), the RG-LRU scan's at RGLRU_BWD_TOL and
   held to float64 at RGLRU_BWD_WITNESS (rejecting da_t = lambda_t h_t
   and lambda without a's shift), flash's yardstick the backward of
   ``scaled_dot_product_attention``, the expert matmul's two ``torch.bmm``
   (dX and dW from the plain dZ);
7. the lint phase's gate; each phase's wall, one JSON line of per-kernel
   numbers, the card line, then the result line.
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
import os
import re
import statistics
import subprocess
import sys
import threading
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
# RG-LRU, float32: the kernel's sequential recurrence and the plain
# version's doubling scan round it in other orders: max |got - want|
# at most RGLRU_TOL of max |want| (tests/test_kernels.py's 1e-5).  On the
# path's recorded operands both are held to the float64 witness: the
# kernel's largest error at most RGLRU_WITNESS times the plain version's
# (or eps of the largest value, where the plain version is exact).
RGLRU_TOL = 1e-5
RGLRU_WITNESS = 4.0
# csrc/rglru.cu's ring stage (SB steps) and slab (WB channels): the wrong
# outputs its gates must reject lose a carry where a stage or a slab ends
RGLRU_STAGE = 128
RGLRU_SLAB = 64
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
# The expert matmul's backward, bf16, from the forward kernel's Z in bf16
# (the plain version forms its own Z from x and w in float32): the kernel
# rounds dZ = dY act'(Z) to bf16 as the operand of its two products, where
# the plain version keeps it fp32, and both round each gradient once to
# bf16: each of dX and dW within GMM_BWD_TOL of its largest magnitude.  On
# the path's recorded operands both are also held to the float64 values
# (Z formed in float64): the
# kernel's largest error at most GMM_BWD_WITNESS times the plain version's
# own (its bf16 rounding), or BF16_EPS of the largest value where that is
# larger.  The RG-LRU backward, float32 (the kernel's sequential reverse
# chunks against the plain version's doubling scan run from the end): da
# and db within RGLRU_BWD_TOL of their largest magnitude, and on the
# recorded operands held to float64 at RGLRU_BWD_WITNESS as the forward
# is.  PERF.md gives
# the readings on the card these were set from.
GMM_BWD_TOL = 2.0 ** -6
GMM_BWD_WITNESS = 4.0
BF16_EPS = 2.0 ** -8  # bf16's largest relative rounding error
RGLRU_BWD_TOL = 1e-5
RGLRU_BWD_WITNESS = 4.0
# Path 4's card-vs-CPU gradient gate holds grad_in and each parameter leaf
# within CHECK_TOL, save where the same gradients through the plain
# versions on the card (the floor: two bf16 evaluations in other orders)
# lie past CHECK_TOL from the CPU themselves; such a gradient is held to
# GRAD_FLOOR_FACTOR times its floor instead.  Only recurrentgemma-9b's six
# layers of d 4096 have such floors, three leaves of 0.0204-0.0207; there
# the kernels read 1.006-1.015 times the floor, every one of its 66 leaves
# 0.988-1.018 times (H100 80GB HBM3 at 700 W; PERF.md).
GRAD_FLOOR_FACTOR = 1.1


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


# path 3, inside its model's turn of path 2: qwen2 fills a KV cache of 0.5
# GB; mamba2's prompts are 7 SSD chunks and its teacher-forced forward 8;
# qwen3-moe's 32 prompts pad to 960 tokens, 30 whole MoE groups of 1,024
# at C 80 (a 1.27 GB dispatch buffer), its 48 KV rings hold 3.2 GB beside
# the 61.1 GB of weights, a decode step routes its 32 tokens at C 2, and
# prompt and generated tokens make 1,024 a row (whole groups for any rows);
# recurrentgemma's 2048-slot local ring wraps at every decode step
SERVE = {
    "qwen2-1.5b": ServeTraffic(8, 256, 2048, 128, 2176),
    "mamba2-370m": ServeTraffic(8, 256, 1792, 256, 2048),
    "qwen3-moe-30b-a3b": ServeTraffic(32, 128, 960, 64, 1024),
    "recurrentgemma-9b": ServeTraffic(1, 4096, 4096, 64, 4160),
}
# path 3's MoE card-vs-CPU gate at 2 layers runs the last SERVE_CPU_TOKENS
# tokens of every padded prompt (2 whole groups of 1,024 at C 80 over the
# 32 rows; every row's are its own prompt's, none shorter than 128) and the
# first SERVE_CPU_STEPS decode steps (N): the CPU's plain expert products
# run in float32 at 70-97 GFLOP/s on the card's host (PERF.md), so the
# whole prefill's 2.9 TFLOP a layer would take the CPU's two runs about
# 230 s, and at 128 tokens and 4 steps they took 44 s
SERVE_CPU_TOKENS = 64
SERVE_CPU_STEPS = 4
# rows at a time of path 3's MoE plain forwards (and their float32 scores)
SERVE_PLAIN_ROWS = 8
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
    and backward kernels named, in pairs (forward, its backward, ...).
    ``layers`` None trains path 2's weights at full depth; a depth draws
    fresh seeded weights at it, in the config's float32, after path 2's
    weights are freed."""
    batch: int
    seq: int
    steps: int
    kernels: tuple[str, ...]  # (forward, backward, forward, backward, ...)
    layers: int | None = None

    def pairs(self) -> list[tuple[str, str]]:
        return list(zip(self.kernels[::2], self.kernels[1::2]))


# path 4, inside its model's turn after path 3 (the train step updates the
# weights in place); the learning rate is the reference's default.  The MoE
# and RG-LRU families train at full width and reduced depth, in float32
# with AdamW (weights, gradients and two moments, 16 B a parameter):
# qwen3-moe-30b-a3b at 4 of 48 layers (3.11 B parameters, 49.8 GB) and
# recurrentgemma-9b at 6 of 38 (two repetitions of rglru, rglru,
# local_attn; 2.36 B, 37.8 GB), where their full depths need 490 GB and
# 150 GB
TRAIN = {
    "qwen2-1.5b": TrainTraffic(2, 2048, 4, ("flash_attention",
                                            "flash_attention_bwd")),
    "mamba2-370m": TrainTraffic(2, 2048, 4, ("ssd", "ssd_bwd")),
    "qwen3-moe-30b-a3b": TrainTraffic(
        2, 2048, 4, ("flash_attention", "flash_attention_bwd", "moe_gmm",
                     "moe_gmm_bwd"), layers=4),
    "recurrentgemma-9b": TrainTraffic(
        1, 4096, 4, ("flash_attention", "flash_attention_bwd", "rglru",
                     "rglru_bwd"), layers=6),
}
TRAIN_LR = 3e-4
TRAIN_CHECK_DEPTH = SERVE_CHECK_DEPTH  # repetitions of the card-vs-CPU
#                                        gradients, as paths 2 and 3 check
# (B, Sq, Skv, Hq, Hkv, hd, causal, window, softcap): tests/test_kernels.py's
# cases, rows that see no key, randomised GQA shapes, head width 16 (the
# reduced configs', 32-byte swizzled rows) causal and with Sq != Skv, and
# whisper-small's cross-attention (448 queries over 1500 frames, ragged
# against both tiles)
FLASH_GENERIC = [
    (1, 129, 129, 4, 2, 16, True, None, None),
    (1, 191, 300, 4, 2, 16, False, None, None),
    (2, 130, 130, 2, 2, 16, True, 40, 30.0),
    (2, 448, 1500, 12, 12, 64, False, None, None),
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
# path's C, C 1 with D below one stage, and E 1 with C off the 128-row tile;
# the backward's cases too (there C is dW's depth, one step at C 1)
GMM_GENERIC = [(4, 64, 96, 80, "none"), (2, 128, 256, 128, "silu"),
               (8, 40, 72, 200, "gelu"), (3, 70, 50, 33, "silu"),
               (2, 256, 2048, 768, "none"), (3, 1, 40, 24, "gelu"),
               (1, 200, 136, 100, "silu")]
# (B, S, W): tests/test_kernels.py's cases, one step, a stage and a half;
# W off a multiple of 4 with S off the stage, and (B, S, W, offset) a base
# ``offset`` floats into its storage (off 16 bytes): the last two take the
# forward kernel's cp.async route; the backward's cases too
RGLRU_GENERIC = [(2, 64, 128), (1, 100, 48), (3, 256, 512), (2, 1, 300),
                 (1, 192, 1000), (2, 77, 75), (3, 130, 96, 1)]


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
    of the last window.  Without ``must_see`` the calls may launch several
    kernels each, and a window that lost every event of one of them still
    counts a multiple of ``calls`` (the likely reason an H100 run read
    ``torch.bmm``, a memset and a GEMM a call, at half its time): such a
    window is read only
    when the window before it saw the same events, kernel by kernel."""
    what = must_see or "the plain version"
    matched = any_events = False
    most = 0  # the most events of ``what`` a window saw
    before = None  # the events by name of the last window, unnamed timings
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
        whole = events and events % calls == 0 and us > 0.0
        if whole and must_see is None:
            counts = {name: count[name] for name in seen}
            whole, before = counts == before, counts
            if not whole:
                continue
        if whole:
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


def _kernel_work():
    """``repro_torch.roofline.kernel_work``: the work formulas the dry run
    counts the kernels by (imported once ``src`` is on the path)."""
    from repro_torch.roofline import kernel_work

    return kernel_work


def _bound_ms(shape) -> tuple[float, str, int]:
    n_ops, n_bytes = _kernel_work().minplus_work(shape)
    byte_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    op_ms = n_ops / FP64_OPS_PER_S * 1e3
    return (max(byte_ms, op_ms), "bytes" if byte_ms >= op_ms else
            "operations", n_bytes)


def _scan_bound(key) -> tuple[float, str, int, int]:
    """The fused scan at (N, K, S), ``kernel_work.scan_work``."""
    n_ops, n_bytes = _kernel_work().scan_work(key)
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
    every shape paths 1, 2 and 5-7 gave it (on the recorded operands and on
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
# (5 seeds passed it in one run of three); a run past it prints a warning.
# 3 since path 7 came in, to hold the whole run near its length before it
# (4 seeds: 54.2-56.7 s for path 6, all phases 478.8-543.3 s); 2 since path
# 8 came in (3 seeds: 50.6 s for path 6, all phases 637.7 s)
SWEEP_SEEDS = 2
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
    """a in [0.7, 0.999) and b of an RG-LRU scan at ``(B, S, W)``; at
    ``(B, S, W, offset)`` each a contiguous view ``offset`` floats into
    its storage."""
    shape, offset = tuple(shape[:3]), (shape[3] if len(shape) > 3 else 0)

    def placed(t):
        if not offset:
            return t.to(device)
        flat = torch.empty(offset + t.numel(), device=device)
        flat[offset:] = t.reshape(-1).to(device)
        return flat[offset:].view(shape)

    return (placed(torch.rand(shape, generator=gen) * 0.299 + 0.7),
            placed(torch.randn(shape, generator=gen) * 0.1))


def _rglru_check(rglru, cases, what: str) -> float:
    """The kernel against its plain version on each ``(a, b)`` at RGLRU_TOL
    of the largest |h|; raises on a failure, else returns the
    max_abs_err."""
    failures, max_err, worst = 0, 0.0, 0.0
    for a, b in cases:
        got, again = rglru.rglru_scan(a, b), rglru.rglru_scan(a, b)
        want = rglru.reference_rglru_scan(a, b)
        err = float((got - want).abs().max())
        rel = err / float(want.abs().max())
        failures += not (rel <= RGLRU_TOL and torch.equal(got, again))
        max_err, worst = max(max_err, err), max(worst, rel)
    line = (f"rglru {what}: {len(cases)} float32 cases, max error {worst!r} "
            f"of the largest |h| (limit {RGLRU_TOL}), two launches the same "
            f"bits, max_abs_err {max_err!r}")
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
        got, again = rglru.rglru_scan(a, b), rglru.rglru_scan(a, b)
        want = rglru.reference_rglru_scan(a, b)
        exact = rglru.reference_rglru_scan(a, b, dtype=torch.float64)
        err_k, limit, err_p = _rglru_witness(got, want, exact)
        same = torch.equal(got, again)
        failures += not (err_k <= limit and same)
        vs_plain = float((got - want).abs().max())
        max_err = max(max_err, vs_plain)
        print(f"rglru {what}, case {n}, against float64: kernel {err_k!r} "
              f"(limit {limit!r}), plain {err_p!r}; kernel vs plain "
              f"{vs_plain!r}; two launches the same bits: {same}; largest "
              f"|h| {float(exact.abs().max())!r}, a in "
              f"[{float(a.min())!r}, {float(a.max())!r}]")
    if failures:
        raise AssertionError(f"rglru {what}: {failures} cases past the "
                             f"limit")
    return max_err


def _rglru_witness(got, want, exact) -> tuple[float, float, float]:
    """(the largest error of ``got`` against the float64 values ``exact``,
    its limit: RGLRU_WITNESS times the plain version ``want``'s own largest
    error, or eps of the largest value where the plain version is exact,
    the plain version's error)."""
    err_k = float((got.double() - exact).abs().max())
    err_p = float((want.double() - exact).abs().max())
    return err_k, RGLRU_WITNESS * max(
        err_p, FP32_EPS * float(exact.abs().max())), err_p


def _rglru_from(rglru, a, b, h0):
    """The plain version of the scan from the state ``h0`` (B, W) instead
    of 0: ``b_1`` takes ``a_1 h0`` in."""
    b = b.clone()
    b[:, 0] += a[:, 0] * h0
    return rglru.reference_rglru_scan(a, b)


def _rglru_wrong_outputs(rglru, args) -> dict:
    """Three deliberately wrong outputs on these operands, built from the
    plain version by RGLRU_STAGE-step stages: the state restarting from 0
    at every stage (a carry lost where a stage ends); each slab of
    RGLRU_SLAB channels but the first taking the previous slab's state
    into every stage (a channel offset slipped by a slab); the last stage
    left unwritten (zeros)."""
    a, b = args
    S, W = a.shape[1], a.shape[2]
    stages = range(0, S, RGLRU_STAGE)
    restarted = torch.cat([rglru.reference_rglru_scan(
        a[:, t:t + RGLRU_STAGE], b[:, t:t + RGLRU_STAGE]) for t in stages],
        dim=1)
    parts, h0 = [], torch.zeros_like(a[:, 0])
    for t in stages:
        if W > RGLRU_SLAB:
            h0 = torch.cat([h0[:, :RGLRU_SLAB], h0[:, :-RGLRU_SLAB]], dim=1)
        part = _rglru_from(rglru, a[:, t:t + RGLRU_STAGE],
                           b[:, t:t + RGLRU_STAGE], h0)
        parts.append(part)
        h0 = part[:, -1]
    unwritten = rglru.reference_rglru_scan(a, b)
    unwritten[:, (S - 1) // RGLRU_STAGE * RGLRU_STAGE:] = 0
    return {"the state restarted every stage": restarted,
            "a slab carrying the previous slab's state": torch.cat(parts,
                                                                   dim=1),
            "the last stage unwritten": unwritten}


def _rglru_rejects_wrong_outputs(rglru, args) -> None:
    """RGLRU_TOL against the plain version and the float64 witness at
    RGLRU_WITNESS must each reject the three wrong outputs of
    ``_rglru_wrong_outputs`` on these operands; prints the error of
    each."""
    want = rglru.reference_rglru_scan(*args)
    exact = rglru.reference_rglru_scan(*args, dtype=torch.float64)
    top = float(want.abs().max())
    for what, out in _rglru_wrong_outputs(rglru, args).items():
        rel = float((out - want).abs().max()) / top
        err_k, limit, _ = _rglru_witness(out, want, exact)
        if rel <= RGLRU_TOL or err_k <= limit:
            raise AssertionError(f"an RG-LRU gate passes a wrong output "
                                 f"({what}): {rel!r} of the largest |h| "
                                 f"(limit {RGLRU_TOL}), {err_k!r} against "
                                 f"float64 (limit {limit!r})")
        print(f"rglru check rejects a wrong output ({what}; "
              f"{tuple(args[0].shape)}): {rel!r} of the largest |h| (limit "
              f"{RGLRU_TOL}), {err_k!r} against float64 (limit {limit!r})")


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


def _ssd_bwd_run(ssd):
    def run(case, dtype):
        args, _ = case
        if dtype is None:
            return ssd.ssd_intra_chunk_bwd(*args)
        return ssd.reference_ssd_intra_chunk_bwd(*args, dtype=dtype)
    return run


def _ssd_bwd_check(ssd, cases, what: str, witness: bool = False,
                   readings: list | None = None) -> float:
    """The SSD backward kernel against autograd through the plain version
    on each ``(x, B, C, dt, A, gy, ghc, gdec)``: every gradient within
    SSD_BWD_TOL of its largest magnitude, or, with ``witness`` (the path's
    recorded operands, as the forward's are held), held to float64 at
    SSD_BWD_WITNESS instead, the difference from the plain version
    printed.  On the path's operands the float32 plain version is the less
    exact of the two in places (ddt and dA sum many terms that cancel), so
    it cannot be the yardstick there."""
    return _bwd_check(f"ssd_bwd {what} (float32)", SSD_GRADS,
                      _ssd_bwd_run(ssd), [(c, {}) for c in cases],
                      SSD_BWD_TOL, SSD_BWD_WITNESS if witness else 0.0,
                      FP32_EPS, readings, witness_only=True)


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
    _bwd_rejects("ssd_bwd", SSD_GRADS, _ssd_bwd_wrong_outputs(ssd, args),
                 _ssd_bwd_run(ssd), (args, {}), SSD_BWD_TOL,
                 SSD_BWD_WITNESS, FP32_EPS)


def _gmm_forward_with_z(gmm, x, w, activation):
    """``(y, z)`` of the expert matmul's forward as ``_ExpertMatmul`` runs
    it under grad: on the card one launch of the kernel's KEEP_Z variant (z
    None without an activation), on the CPU the plain version."""
    if x.is_cuda:
        return gmm._launch_forward(x, w, activation, keep_z=True)
    y, z = gmm.reference_expert_matmul(x, w, activation=activation,
                                       keep_z=True)
    return y, (z if activation != "none" else None)


def _gmm_bwd_operands(gen, shape, device):
    """((x, w, dy), kw) of an expert-matmul backward at ``(E, C, D, F,
    activation)``: the forward's operands, a random bf16 cotangent and, in
    kw beside the activation, the forward's pre-activation z as the forward
    kernel writes it under grad (None without an activation, as
    ``_ExpertMatmul`` hands it on)."""
    from repro_torch.kernels import moe_gmm

    (x, w), kw = _gmm_operands(gen, shape, device)
    dy = torch.randn((*x.shape[:2], w.shape[2]), generator=gen).to(
        device, torch.bfloat16)
    z = _gmm_forward_with_z(moe_gmm, x, w, kw["activation"])[1]
    return (x, w, dy), {**kw, "z": z}


def _gmm_keep_z_check(gmm, cases) -> float:
    """The forward's launch that keeps Z, on each activated ``((x, w, dy),
    kw)``: its output has the bits of the launch without Z, its Z those of
    the launch without the activation and of kw's z (the Z that the path's
    or the case's forward wrote), and Z lies within GMM_TOL of the plain
    version's pre-activation, which must reject the output Y written as Z.
    Raises on a failure, else returns Z's max_abs_err."""
    failures, max_err, n = 0, 0.0, 0
    for (x, w, _), kw in cases:
        act = kw.get("activation", "none")
        if act == "none":
            continue
        n += 1
        y, z = _gmm_forward_with_z(gmm, x, w, act)
        want = gmm.reference_expert_matmul(x, w, activation=act,
                                           keep_z=True)[1]
        if _gmm_within(y, want):
            raise AssertionError(f"GMM_TOL passes Y as Z at "
                                 f"{tuple(x.shape)}, {act}")
        failures += not (torch.equal(y, gmm.expert_matmul(x, w, act))
                         and torch.equal(z, gmm.expert_matmul(x, w))
                         and torch.equal(z, kw["z"])
                         and _gmm_within(z, want))
        max_err = max(max_err, float((z.float() - want.float()).abs().max()))
    line = (f"moe_gmm keeping Z: {n} activated cases, the output == the "
            f"launch without Z, Z == the launch without the activation == "
            f"the case's Z, Z against the plain version max_abs_err "
            f"{max_err!r} (elementwise limit {GMM_TOL} of |want| + {GMM_TOL} "
            f"of the largest; Y as Z rejected)")
    if failures or not n:
        raise AssertionError(f"{line}: {failures} cases failed")
    print(line)
    return max_err


GMM_GRADS = ("dX", "dW")


def _grad_witness(names, got, want, exact, floor: float) -> list:
    """For each gradient: (name, the largest error of ``got`` against the
    float64 values ``exact``, its limit: the witness multiple times the
    plain version ``want``'s own largest error, or ``floor`` of the largest
    value where that is larger, and the plain version's error); the
    multiple is the caller's, applied to the limit it is given back."""
    rows = []
    for name, g, w, e in zip(names, got, want, exact):
        err_k = float((g.double() - e).abs().max())
        err_p = float((w.double() - e).abs().max())
        rows.append((name, err_k, max(err_p, floor * float(e.abs().max())),
                     err_p))
    return rows


def _rel_or_abs(out, ref) -> float:
    """``_rel``, or max |out - ref| where ref is all 0 (da of a one-step
    RG-LRU scan: h_0 = 0)."""
    if not ref.numel() or float(ref.abs().max()) > 0.0:
        return _rel(out, ref)
    return float((out - ref).abs().max())


def _bwd_check(what: str, names, run, cases, tol: float, witness: float,
               floor: float, readings: list | None = None,
               witness_only: bool = False) -> float:
    """A backward kernel against its plain version on each case, a second
    launch the same bits: ``run(case, dtype)`` gives the kernel's gradients
    (dtype None) or the plain version's in that dtype.  Every gradient
    within ``tol`` of its largest magnitude; where ``witness`` is given
    (the path's recorded operands), each also held to its float64 value,
    the kernel's largest error at most ``witness`` times the plain
    version's own (or ``floor`` of the largest value where that is
    larger), each reading (name, error, limit, the plain version's error)
    appended to ``readings`` where a list is given; with
    ``witness_only``, the witness replaces ``tol`` where it is given.
    Raises on a failure, else returns the max_abs_err."""
    failures, worst, max_err = 0, [0.0] * len(names), 0.0
    for n, case in enumerate(cases):
        got, again = run(case, None), run(case, None)
        want = run(case, torch.float32)
        for i, (g, a, w) in enumerate(zip(got, again, want)):
            rel = _rel_or_abs(g.float(), w.float())
            failures += not ((rel <= tol or (witness and witness_only))
                             and torch.equal(g, a)
                             and bool(torch.isfinite(g).all()))
            worst[i] = max(worst[i], rel)
            max_err = max(max_err, float((g.float() - w.float()).abs().max()))
        if witness:
            rows = _grad_witness(names, got, want, run(case, torch.float64),
                                 floor)
            failures += sum(not err <= witness * limit
                            for _, err, limit, _ in rows)
            if readings is not None:
                readings += [(name, err, witness * limit, err_p)
                             for name, err, limit, err_p in rows]
            print(f"{what}, case {n} ({tuple(case[0][0].shape)}), against "
                  f"float64: " + "; ".join(
                      f"{name} kernel {err!r} (limit {witness * limit!r}), "
                      f"plain {err_p!r}" for name, err, limit, err_p in rows))
    limit = ("held to float64 instead" if witness and witness_only else
             f"limit {tol}")
    line = (f"{what}: {len(cases)} cases, max error of {', '.join(names)} "
            f"against the plain version {worst!r} of their largest magnitude "
            f"({limit}), two launches the same bits, max_abs_err "
            f"{max_err!r}")
    if failures:
        raise AssertionError(f"{line}: {failures} gradients past a limit or "
                             f"not repeated")
    print(line)
    return max_err


def _gmm_plain_z(x, w, activation, dtype):
    """The pre-activation formed from x and w in ``dtype`` (None without an
    activation): the Z of the plain version's backward."""
    if activation == "none":
        return None
    return torch.einsum("ecd,edf->ecf", x.to(dtype), w.to(dtype))


def _gmm_bwd_run(gmm):
    """The kernel (dtype None) takes the case's z, the Z that the forward
    kernel wrote; the plain version in float32 and the float64 witness form
    Z from x and w in their own type, so that a wrong Z from the forward
    kernel, and Z's bf16 rounding, count in the kernel's distance from
    both."""
    def run(case, dtype):
        (x, w, dy), kw = case
        if dtype is None:
            return gmm.expert_matmul_bwd(x, w, dy, **kw)
        act = kw.get("activation", "none")
        return gmm.reference_expert_matmul_bwd(
            x, w, dy, act, z=_gmm_plain_z(x, w, act, dtype), dtype=dtype)
    return run


def _gmm_bwd_check(gmm, cases, what: str, witness: bool = False,
                   readings: list | None = None) -> float:
    """The expert matmul's backward kernel against the plain version on
    each ``((x, w, dy), kw)`` (the kernel given kw's z, the plain version
    its own): dX and dW within
    GMM_BWD_TOL, and with ``witness`` held to float64 at GMM_BWD_WITNESS."""
    return _bwd_check(f"moe_gmm_bwd {what} (bf16)", GMM_GRADS,
                      _gmm_bwd_run(gmm), cases, GMM_BWD_TOL,
                      GMM_BWD_WITNESS if witness else 0.0, BF16_EPS,
                      readings)


def _gmm_dz(x, w, dy, activation):
    """dZ = dY act'(Z) of the plain version, float32 (E, C, F)."""
    with torch.enable_grad():
        z = torch.einsum("ecd,edf->ecf", x.float(), w.float())
        z.requires_grad_()
        out = {"none": lambda t: t, "silu": F.silu,
               "gelu": lambda t: F.gelu(t, approximate="tanh")}[
            activation](z)
        (dz,) = torch.autograd.grad(out, z, dy.float())
    return dz


def _gmm_bwd_wrong_outputs(gmm, args, kw) -> dict:
    """Three deliberately wrong gradients, from the plain version: dW
    without act' (X^T dY, the activation's backward left out), dX through W
    un-transposed (dZ times w's memory read as (E, F, D), a layout fault),
    and both with act' applied to the forward's output Y instead of its
    pre-activation Z (the wrong one of the forward's two outputs kept).
    Needs an activation."""
    x, w, dy = args
    act = kw.get("activation", "none")
    if act == "none":
        raise ValueError("operands of an activated product expected")
    want = _gmm_bwd_run(gmm)((args, kw), torch.float32)
    E, D, F_ = w.shape
    no_act = gmm.reference_expert_matmul_bwd(x, w, dy, "none")[1]
    flat = torch.einsum("ecf,efd->ecd", _gmm_dz(x, w, dy, act),
                        w.float().reshape(E, F_, D)).to(x.dtype)
    y = gmm.reference_expert_matmul(x, w, activation=act)
    return {"dW without act'": (want[0], no_act),
            "dX through W un-transposed": (flat, want[1]),
            "act' of Y instead of Z": gmm.reference_expert_matmul_bwd(
                x, w, dy, act, z=y)}


def _gmm_bwd_wrong_z(gmm, args, kw) -> dict:
    """The backward kernel's own gradients from two wrong Zs, as a faulty
    forward would hand them on: the forward's output Y written as Z, and Z
    of the next expert (a tile stored at the wrong expert).  Needs an
    activation and E > 1."""
    x, w, dy = args
    act = kw.get("activation", "none")
    if act == "none" or x.shape[0] < 2:
        raise ValueError("operands of an activated product over two "
                         "experts at least expected")
    y = gmm.expert_matmul(x, w, act)
    return {"the kernel given Y as Z": gmm.expert_matmul_bwd(
                x, w, dy, act, z=y),
            "the kernel given the next expert's Z": gmm.expert_matmul_bwd(
                x, w, dy, act, z=torch.roll(kw["z"], 1, dims=0))}


def _bwd_rejects(kernel: str, names, wrong: dict, run, case, tol: float,
                 witness: float, floor: float) -> None:
    """Both gates of ``_bwd_check`` must reject each wrong gradient of
    ``wrong`` (what it is -> the gradients) on the case: ``tol`` against
    the plain version ``run(case, float32)``, and the float64 witness at
    ``witness`` times the plain version's own error."""
    want, exact = run(case, torch.float32), run(case, torch.float64)
    for what, grads in wrong.items():
        errors = [_rel_or_abs(g.float(), w.float())
                  for g, w in zip(grads, want)]
        rows = _grad_witness(names, grads, want, exact, floor)
        if all(e <= tol for e in errors) or all(
                err <= witness * limit for _, err, limit, _ in rows):
            raise AssertionError(f"a {kernel} gate passes a wrong gradient "
                                 f"({what}): {errors}, {rows}")
        options = {k: v for k, v in case[1].items() if not torch.is_tensor(v)}
        print(f"{kernel} check rejects a wrong output ({what}; "
              f"{tuple(case[0][0].shape)}, {options}): errors of "
              f"{', '.join(names)} {errors!r} of their largest magnitude "
              f"(limit {tol}); against float64 " + ", ".join(
                  f"{name} {err!r} (limit {witness * limit!r})"
                  for name, err, limit, _ in rows))


def _gmm_bwd_rejects_wrong_outputs(gmm, args, kw) -> None:
    """Both gates must reject the three wrong gradients of
    ``_gmm_bwd_wrong_outputs`` and the kernel's two of ``_gmm_bwd_wrong_z``
    on these operands: GMM_BWD_TOL against the plain version, and the
    float64 witness at GMM_BWD_WITNESS."""
    _bwd_rejects("moe_gmm_bwd", GMM_GRADS,
                 {**_gmm_bwd_wrong_outputs(gmm, args, kw),
                  **_gmm_bwd_wrong_z(gmm, args, kw)}, _gmm_bwd_run(gmm),
                 (args, kw), GMM_BWD_TOL, GMM_BWD_WITNESS, BF16_EPS)


def _rglru_bwd_operands(gen, shape, device):
    """(a, h, g) of an RG-LRU backward at ``(B, S, W)``: the forward's
    operands, h from its plain version, and a random cotangent."""
    from repro_torch.kernels.rglru import reference_rglru_scan

    a, b = _rglru_operands(gen, shape, device)
    return (a, reference_rglru_scan(a, b),
            torch.randn(a.shape, generator=gen).to(device))


RGLRU_GRADS = ("da", "db")


def _rglru_bwd_run(rglru):
    def run(case, dtype):
        args, _ = case
        if dtype is None:
            return rglru.rglru_scan_bwd(*args)
        return rglru.reference_rglru_scan_bwd(*args, dtype=dtype)
    return run


def _rglru_bwd_check(rglru, cases, what: str, witness: bool = False,
                     readings: list | None = None) -> float:
    """The RG-LRU backward kernel against its plain version on each
    ``(a, h, g)``: da and db within RGLRU_BWD_TOL, and with ``witness``
    held to float64 at RGLRU_BWD_WITNESS."""
    return _bwd_check(f"rglru_bwd {what} (float32)", RGLRU_GRADS,
                      _rglru_bwd_run(rglru), [(c, {}) for c in cases],
                      RGLRU_BWD_TOL, RGLRU_BWD_WITNESS if witness else 0.0,
                      FP32_EPS, readings)


def _witness_summary(readings) -> dict:
    """The float64 witness of a backward kernel's recorded cases, by
    gradient: the reading nearest its limit (the kernel's error, the plain
    version's, the limit)."""
    out: dict = {}
    for name, err, limit, err_p in readings:
        if name not in out or err / limit > out[name]["kernel"] / out[
                name]["limit"]:
            out[name] = {"kernel": err, "plain": err_p, "limit": limit}
    return out


def _rglru_bwd_wrong_outputs(rglru, args) -> dict:
    """Two deliberately wrong gradients, from the plain version: da_t =
    lambda_t h_t (the shift of h dropped), and lambda without a's shift
    (``lambda_t = g_t + a_t lambda_{t+1}``), with its da."""
    a, h, g = args
    da, lam = rglru.reference_rglru_scan_bwd(*args)
    # lambda_t = g_t + a_t lambda_{t+1}: the forward's plain version run
    # from the end with a unshifted
    unshifted = rglru.reference_rglru_scan(a.flip(1), g.flip(1)).flip(1)
    return {"da_t = lambda_t h_t (the shift dropped)": (lam * h, lam),
            "lambda without a's shift": (
                unshifted * torch.cat([torch.zeros_like(h[:, :1]),
                                       h[:, :-1]], dim=1), unshifted)}


def _rglru_bwd_rejects_wrong_outputs(rglru, args) -> None:
    """Both gates must reject both wrong gradients of
    ``_rglru_bwd_wrong_outputs`` on these operands: RGLRU_BWD_TOL against
    the plain version, and the float64 witness at RGLRU_BWD_WITNESS."""
    _bwd_rejects("rglru_bwd", RGLRU_GRADS,
                 _rglru_bwd_wrong_outputs(rglru, args), _rglru_bwd_run(rglru),
                 (args, {}), RGLRU_BWD_TOL, RGLRU_BWD_WITNESS, FP32_EPS)


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
            "generic"),
        "moe_gmm_bwd": _gmm_bwd_check(mods["moe_gmm"], [
            _gmm_bwd_operands(gen, s, device) for s in GMM_GENERIC],
            "generic"),
        "rglru_bwd": _rglru_bwd_check(mods["rglru"], [
            _rglru_bwd_operands(gen, s, device) for s in RGLRU_GENERIC],
            "generic")}


@contextlib.contextmanager
def record_calls(module, name: str, key_fn, device=None,
                 keep: int = RECORDED_OPERANDS):
    """Record every call of ``module.<name>`` inside the block: a count per
    ``key_fn(*args, **kw)`` and up to ``keep`` clones of its operands per
    key (tensors among its keyword arguments too), detached from any
    autograd graph (copied to ``device`` where it is given).  The recorder
    calls the function it replaced, so the wrappers' launch counts are
    untouched."""
    shapes: collections.Counter = collections.Counter()
    operands: dict = collections.defaultdict(list)
    wrapped = getattr(module, name)

    def recorder(*args, **kw):
        key = key_fn(*args, **kw)
        shapes[key] += 1
        if len(operands[key]) < keep:
            def clone(a):
                return (a.detach().to(device or a.device, copy=True)
                        if torch.is_tensor(a) else a)
            operands[key].append((tuple(map(clone, args)),
                                  {k: clone(v) for k, v in kw.items()}))
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


def _gmm_bwd_key(x, w, dy, activation="none", z=None):
    return _gmm_key(x, w, activation)


def _rglru_bwd_key(a, h, g):
    return _rglru_key(a, h)


@contextlib.contextmanager
def record_routes(replay=None, own=None, slim: bool = False):
    """Record every MoE layer's routing inside the block: yields a list of
    ``layers.Routing``, one per layer call in order.  With ``replay``
    (another run's routings of the same layer calls) each call sends its
    tokens to that run's experts instead, through
    ``layers.routing_of_picks``, whose buffer places and capacity drops
    must then be ``==`` that run's; the router's own routing is appended to
    ``own`` where a list is given.  ``slim`` keeps of each routing only its
    picks, places, drops and capacity, all that a replay reads (a prefill
    of path 3's MoE model routes 30,720 tokens at each of 48 layers, whose
    float32 logits and probabilities would take 1.5 GB)."""
    from repro_torch.models import layers as ML

    routes: list = []
    route = ML.moe_route

    def recorder(router, cfg, toks):
        r = route(router, cfg, toks)
        if own is not None:
            own.append(r)
        if replay is not None:
            want = replay[len(routes)]
            r = ML.routing_of_picks(r.logits, r.probs,
                                    want.idx.to(r.idx.device), r.capacity)
            if not (torch.equal(r.pos, want.pos.to(r.pos.device))
                    and torch.equal(r.keep, want.keep.to(r.keep.device))):
                raise AssertionError(f"MoE layer {len(routes)}: the replayed "
                                     f"picks give other buffer places or "
                                     f"drops")
        routes.append(r._replace(logits=None, probs=None, gates=None)
                      if slim else r)
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


def _moe_gate(got, own, replayed, card_routes, cpu_routes, rows: int,
              names: tuple[str, str] = ("card", "CPU"), at=None) -> str:
    """The card-vs-CPU gate of a model with MoE layers, on the tokens
    (rows of ``rows`` sequences, each a row of ``got``; with ``at``, the
    outputs at those positions of each sequence only, sequence by
    sequence, where the routings cover every position): ``own`` is the
    CPU's output with its own routing, ``replayed`` with the card's expert
    picks.  Every pick of the card that the CPU's router would not make
    must be a near tie there (within CHECK_TOL of the largest |logit|),
    half the tokens at least must route alike at every layer, the tokens of
    each sequence before its first token that routes otherwise must be
    within CHECK_TOL of ``own`` (attention carries a differing pick to
    every later token of its sequence), and every token within CHECK_TOL
    of ``replayed``.  ``names`` names the two runs in the readings.
    Raises on a failure, else returns the readings."""
    from repro_torch.models import layers as ML

    card, cpu = names

    ra = ML.routing_agreement([(r.logits, r.idx, r.keep) for r in card_routes],
                              [(r.logits, r.idx, r.keep) for r in cpu_routes])
    first = (~ra.agree).reshape(rows, -1).cumsum(1) == 0
    if at is not None:
        first = first[:, at]
    first = first.flatten()
    err_first = _rel(got[first], own[first])
    err_all = _rel(got, replayed)
    n_tok = ra.agree.numel()
    line = (f"routing: {ra.flips} of {ra.picks} expert picks differ by slot, "
            f"{ra.diverged} of {n_tok} tokens keep other experts at some "
            f"layer, each first at a near tie (the largest distance of a "
            f"differing expert from the {cpu}'s top-k cut {ra.worst_gap!r} "
            f"of the largest |logit|, limit {CHECK_TOL}), "
            f"{int(ra.agree.sum())} keep the same experts at every layer; "
            f"the {int(first.sum())} {'outputs' if at is not None else 'tokens'}"
            f" before their sequence's first token that routes otherwise "
            f"{err_first!r}, every one with the {card}'s picks replayed on "
            f"the {cpu} {err_all!r} of the largest magnitude (limit "
            f"{CHECK_TOL})")
    if not ra.flips_are_near_ties(CHECK_TOL) \
            or 2 * int(ra.agree.sum()) < n_tok:
        raise AssertionError(f"the {card}'s routing is not the {cpu}'s up "
                             f"to near ties; {line}")
    if not (err_first < CHECK_TOL and err_all < CHECK_TOL):
        raise AssertionError(f"{card} and {cpu} differ past the limit; "
                             f"{line}")
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
    pipeline = run_pipeline_path(name, cfg, params, PIPELINE[name], mods,
                                 device)
    serve = train = pipeline_train = cut = None
    fresh = name in TRAIN and TRAIN[name].layers is not None
    for run in ({"recorded": recorded}, pipeline):
        park(run)  # the recorded operands wait on the host from here on
    if name in SERVE:
        serve = run_serve_path(name, cfg, params, SERVE[name], spec.kernels,
                               mods, device)
        if cfg.n_experts:
            cut = serve_cut(cfg, params)
    if name in TRAIN and not fresh:
        train = run_train_path(name, cfg, params, TRAIN[name], mods, device)
    del params  # path 7's steps draw the seeded weights again
    torch.cuda.empty_cache()
    if cut is not None:
        serve.update(run_moe_serve_cut(name, *cut, SERVE[name], device))
        del cut
        torch.cuda.empty_cache()
    if fresh:
        park(serve)
        train = run_fresh_train_path(name, mods, device)
    elif name in TRAIN:
        pipeline_train = run_pipeline_train_path(name, cfg, TRAIN[name],
                                                 mods, device, train)
    return {"launches": launches, "recorded": recorded, "serve": serve,
            "train": train, "pipeline": pipeline,
            "pipeline train": pipeline_train}


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


def _logits_at(params, cfg, tokens, first: int, n: int, memory=None):
    """The cache-free forward's logits at positions first .. first+n-1,
    (B, n, V) float32, as ``logits_last`` takes them at the last one; a
    cross-attention model's over ``memory``."""
    from repro_torch.models import layers as ML
    from repro_torch.models import transformer as MT

    B, S = tokens.shape
    pos = torch.arange(S, device=tokens.device).expand(B, S)
    with torch.inference_mode():
        hidden, _, _ = MT.forward(params, cfg, tokens,
                                  ML.Ctx(mode="prefill", positions=pos),
                                  memory=memory)
        W = MT.head_matrix(params, cfg).to(ML.cdt(cfg))
        logits = (hidden[:, first:first + n] @ W).float()
        if cfg.final_softcap:
            logits = ML.softcap(logits, cfg.final_softcap)
    return logits


@contextlib.contextmanager
def plain_kernels(rows: int | None = None):
    """Inside the block the model calls each kernel's plain version at the
    site path 2 records (flash attention with fp32 p, SSD and RG-LRU in
    their plain summation orders).  With ``rows``, flash attention's plain
    version takes at most that many batch rows at a time (each row
    attends on its own): its float32 scores are Hq x Sq x Skv x 4 bytes a
    row, 3.8 GB a copy for path 3's 32 MoE prompts of 960 tokens."""
    saved = []
    for name, spec in KERNELS.items():
        if spec.plain:
            site = importlib.import_module(spec.site[0])
            kernel = importlib.import_module(
                f"repro_torch.kernels.{_module(name)}")
            plain = getattr(kernel, spec.plain)
            if rows is not None and name == "flash_attention":
                plain = _by_rows(plain, rows)
            saved.append((site, spec.site[1], getattr(site, spec.site[1])))
            setattr(site, spec.site[1], plain)
    try:
        yield
    finally:
        for site, name, fn in saved:
            setattr(site, name, fn)


def _by_rows(fn, rows: int):
    """``fn`` over its operands' first ``rows`` batch rows at a time, the
    results concatenated."""
    def by_rows(*args, **kw):
        return torch.cat([fn(*(a[i:i + rows] for a in args), **kw)
                          for i in range(0, args[0].shape[0], rows)])

    return by_rows


def serve_loop(params, cfg, toks, traffic: ServeTraffic, device,
               memory=None, feed=None, counts=None) -> dict:
    """``prefill`` of the padded prompts (and of ``memory``, for a
    cross-attention model), then ``max_new - 1`` greedy ``decode_step``s:
    the served logits (B, max_new, V), the generated tokens (B, max_new),
    the last cache and the host times (the host reads each step's tokens
    once).  With ``feed`` (B, max_new) step t is fed its column t - 1
    instead of the greedy token (another run's tokens).  With ``counts``
    (the kernels' launch counts, read on the host) the launches of each
    call, the prefill's first, are ``launches_by_call``."""
    from repro_torch import serving as SV

    B, S = toks.shape
    snaps = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = SV.prefill(params, cfg, toks, traffic.cache_len,
                               memory=memory)
    cur = torch.argmax(logits[:, -1], dim=-1)
    tokens = [cur.tolist()]
    prefill_ms = (time.perf_counter() - t0) * 1e3
    if counts is not None:
        snaps.append(counts())
    served, steps_ms = [logits[:, -1]], []
    for t in range(1, traffic.max_new):
        t1 = time.perf_counter()
        pos = torch.full((B, 1), S + t - 1, device=device)
        fed = cur[:, None] if feed is None else feed[:, t - 1:t].to(device)
        logits, cache = SV.decode_step(params, cfg, cache, fed, pos)
        cur = torch.argmax(logits[:, -1], dim=-1)
        tokens.append(cur.tolist())
        steps_ms.append((time.perf_counter() - t1) * 1e3)
        if counts is not None:
            snaps.append(counts())
        served.append(logits[:, -1])
    by_call = snaps[:1] + [{k: b[k] - a[k] for k in b}
                           for a, b in zip(snaps, snaps[1:])]
    return {"served": torch.stack(served, dim=1),
            "generated": torch.tensor(tokens, device=device).T,
            "cache": cache, "prefill_ms": prefill_ms, "steps_ms": steps_ms,
            "launches_by_call": by_call,
            "step_inputs": (fed, pos) if traffic.max_new > 1 else ()}


def teacher_forced(params, cfg, toks, run: dict, memory=None) -> dict:
    """One cache-free forward over prompt + generated tokens (and
    ``memory``): the served logits' row errors against its logits at
    positions S-1 .. S+n-2 (``err``, (B, n)), and the largest gap, over the
    greedy tokens that are not its argmax, between its top logit and its
    logit of the token, over the row's largest |logit| (``worst_gap``, 0
    where there is none)."""
    served, generated = run["served"], run["generated"]
    S, n = toks.shape[1], generated.shape[1]
    want = _logits_at(params, cfg, torch.cat([toks, generated], dim=1),
                      S - 1, n, memory)
    if not torch.isfinite(want).all():
        raise AssertionError("the teacher-forced forward's logits are not "
                             "finite")
    off, worst_gap = _greedy_gap(want, generated)
    return {"want": want, "err": _row_err(served, want), "off": off,
            "worst_gap": worst_gap}


def _moe_layers(cfg) -> int:
    """The MoE layers of the model (each routes once a call)."""
    from repro_torch.models import transformer as MT

    return sum(kind in KERNEL_KINDS["moe_gmm"]
               for kind in MT.layer_kinds(cfg.n_layers, cfg.pattern))


def _serve_launches(name, cfg, by_call) -> str:
    """An MoE model's launches in path 3, call by call: the prefill
    launches flash attention once a layer of the attention kinds and the
    expert matmul KERNEL_CALLS times an MoE layer; every decode step the
    expert matmul as often and flash attention never (decode attention is
    the plain ``_decode_attention``); no other kernel launches."""
    from repro_torch.models import transformer as MT

    kinds = MT.layer_kinds(cfg.n_layers, cfg.pattern)
    attn = sum(kind in KERNEL_KINDS["flash_attention"] for kind in kinds)
    gmm = KERNEL_CALLS["moe_gmm"] * _moe_layers(cfg)
    for i, got in enumerate(by_call):
        want = {k: 0 for k in got}
        want.update(flash_attention=0 if i else attn, moe_gmm=gmm)
        if got != want:
            raise AssertionError(f"{name}: path 3's "
                                 f"{'decode step ' + str(i) if i else 'prefill'}"
                                 f" launched {got}, not {want}")
    return (f"the prefill launched flash {attn} and moe_gmm {gmm} times, "
            f"each of the {len(by_call) - 1} decode steps moe_gmm {gmm} and "
            f"flash 0 times")


def _first_picks(idx, n_experts: int, capacity: int):
    """The reference's drops, counted from the picks alone: in each group
    (idx (G, g, k)) an expert keeps its first ``capacity`` picks in (slot,
    token) order (``layers.py:404-412`` of the JAX package)."""
    G, g, k = idx.shape
    order = idx.transpose(1, 2).reshape(G, k * g)
    seen = F.one_hot(order, n_experts)
    before = (seen.cumsum(1) - seen).gather(2, order[..., None])[..., 0]
    return (before < capacity).reshape(G, k, g).transpose(1, 2)


def _capacity_gate(name, cfg, routes, tokens) -> str:
    """Every MoE layer call of a serving run takes its capacity over the
    call's own tokens, as the reference does: ``tokens[i]`` is call i's
    token count (B * S for the prefill, B for a decode step), routed in
    groups of g = min(MOE_GROUP, tokens) at C = max(1, int(g k / E
    capacity_factor)), and its kept picks are each expert's first C
    (``_first_picks``)."""
    from repro_torch.models import layers as ML

    E, k = cfg.n_experts, cfg.moe_top_k
    n = _moe_layers(cfg)
    if len(routes) != n * len(tokens):
        raise AssertionError(f"{name}: {len(routes)} MoE layer calls, "
                             f"{n} a call over {len(tokens)} calls")
    dropped = 0
    for i, r in enumerate(routes):
        T_ = tokens[i // n]
        g = min(ML.MOE_GROUP, T_)
        C = max(1, int(g * k / E * cfg.capacity_factor))
        if r.capacity != C or tuple(r.idx.shape) != (T_ // g, g, k) \
                or not torch.equal(r.keep, _first_picks(r.idx, E, C)):
            raise AssertionError(f"{name}: MoE layer call {i} routes "
                                 f"{tuple(r.idx.shape)} picks at capacity "
                                 f"{r.capacity}, not the reference's "
                                 f"groups of {g} at C {C} with its drops")
        if i >= n:
            dropped += int((~r.keep).sum())
    g_step = min(ML.MOE_GROUP, tokens[-1])
    return (f"every one of the {len(routes)} MoE layer calls routes its own "
            f"tokens (the prefill's {tokens[0]} in groups of "
            f"{min(ML.MOE_GROUP, tokens[0])}, a decode step's {tokens[-1]} "
            f"at C {max(1, int(g_step * k / E * cfg.capacity_factor))}) and "
            f"keeps each expert's first C picks; the decode steps dropped "
            f"{dropped} of {(len(routes) - n) * tokens[-1] * k} picks")


def _routes_by_token(routes, cfg, rows: int) -> list:
    """A serving run's routings (a prefill's, then its decode steps', each
    call every MoE layer in order) per layer, each covering every position
    of each of the ``rows`` sequences in order: (logits, idx, keep) of
    (rows x positions, .), as ``_moe_gate`` reads them."""
    import types

    n = _moe_layers(cfg)
    out = []
    for layer in range(n):
        calls = routes[layer::n]
        out.append(types.SimpleNamespace(**{
            f: torch.cat([getattr(r, f).reshape(rows, -1, getattr(
                r, f).shape[-1]) for r in calls], dim=1).flatten(0, 1)
            for f in ("logits", "idx", "keep")}))
    return out


def _decode_bytes(params, cfg, cache) -> int:
    """The bytes a decode step must read at least: every layer's weights
    (the reference's expert products read every expert's), the head, and
    the whole cache (its KV rings and states); the embedding's B rows are
    left out."""
    from repro_torch.models import transformer as MT

    def size(tree):
        return sum(t.numel() * t.element_size() for t in MT.tree_leaves(tree))

    return (size(params["stack"]) + size(MT.head_matrix(params, cfg))
            + size(cache["stack"]))


def _row_blocks(B: int, L: int) -> int:
    """Rows of L tokens that a forward of path 3's MoE checks takes at
    once, at most SERVE_PLAIN_ROWS: each block whole MoE groups, so that
    it routes its tokens in the groups the whole batch's forward would
    (the whole batch where it is one group)."""
    from repro_torch.models import layers as ML

    if B * L <= ML.MOE_GROUP:
        return B
    for r in range(min(B, SERVE_PLAIN_ROWS), 0, -1):
        if B % r == 0 and r * L % ML.MOE_GROUP == 0:
            return r
    return B


def _moe_full_depth(name, cfg, params, toks, traffic, run, routes,
                    device) -> None:
    """Path 3's full-depth gate of an MoE model, whose cached decode and
    cache-free forward rightly drop other slots (each call takes its
    capacity over its own tokens): the served logits against the same
    cached decode (prefill, then steps fed the served tokens) through the
    plain versions on the card with the served run's picks replayed,
    within FLOOR_FACTOR of the floor (the teacher-forced forward through
    the kernels against through the plain versions, the kernels'
    forward's picks replayed), never tighter than CHECK_TOL.  The served
    logits against that forward are printed, not gated.  The forwards run
    ``_row_blocks`` rows at a time and the plain attention SERVE_PLAIN_ROWS
    rows at a time, the logits compared on the host: the 61.1 GB of
    weights leave the card too little room for the plain versions' float32
    operands at once."""
    B, S = toks.shape
    n_new = traffic.max_new
    seq = torch.cat([toks, run["generated"]], dim=1)
    r = _row_blocks(B, seq.shape[1])
    with record_routes(slim=True) as fw_routes:
        want = torch.cat([_logits_at(params, cfg, seq[i:i + r], S - 1,
                                     n_new).cpu() for i in range(0, B, r)])
    with plain_kernels(SERVE_PLAIN_ROWS), \
            record_routes(replay=fw_routes, slim=True):
        plain = torch.cat([_logits_at(params, cfg, seq[i:i + r], S - 1,
                                      n_new).cpu() for i in range(0, B, r)])
    floor = float(_row_err(want, plain).max())
    del plain, fw_routes
    served = run["served"].cpu()
    off, gap = _greedy_gap(want, run["generated"].cpu())
    err_fw = float(_row_err(served, want).max())
    del want
    with plain_kernels(SERVE_PLAIN_ROWS), \
            record_routes(replay=routes, slim=True):
        replay = serve_loop(params, cfg, toks, traffic, device,
                            feed=run["generated"])
    del replay["cache"]
    plain_served = replay.pop("served").cpu()
    err = float(_row_err(served, plain_served).max())
    limit = max(CHECK_TOL, FLOOR_FACTOR * floor)
    print(f"{name}: path 3 at full depth: served logits vs the same cached "
          f"decode through the plain versions on the card, the served picks "
          f"replayed, {err!r} of each row's largest (prefill "
          f"{float(_row_err(served[:, 0], plain_served[:, 0]).max())!r}); "
          f"the floor, the teacher-forced forward through the kernels vs "
          f"the plain versions with its picks replayed ({r} rows a forward), "
          f"{floor!r} (limit {FLOOR_FACTOR} x floor, at least {CHECK_TOL}: "
          f"{limit!r}); not gated, as the two drop other slots: served vs "
          f"that forward {err_fw!r}, {off} of {B * n_new} greedy tokens off "
          f"its argmax (largest gap {gap!r})")
    if not err <= limit:
        raise AssertionError(f"{name}: path 3's cached decode differs from "
                             f"its replay through the plain versions past "
                             f"{limit!r}")


def _moe_peak_bytes(cfg, tokens: int) -> int:
    """An MoE layer's largest live buffers at capacity C = g (no drops)
    over ``tokens`` tokens, in the compute type: the dispatch buffer
    (E + 1 experts), the hidden products, the expert outputs, and the
    picked rows with their float32 combine."""
    E, D, F_, k = (cfg.n_experts, cfg.d_model, cfg.moe_d_ff, cfg.moe_top_k)
    return tokens * (2 * ((2 * E + 1) * D + E * F_) + 10 * k * D)


def _no_drop_rows(cfg, B: int, S: int, n_new: int, device) -> tuple:
    """The most rows, at most B, for the no-drop check: every call of
    theirs (the prefill's r x S tokens, the forward's r x (S + n_new)) a
    single MoE group or whole groups of it, and the forward's
    ``_moe_peak_bytes`` within 0.8 of the card's free memory (every row
    on the CPU).  Returns (rows, those bytes, the free bytes or None)."""
    from repro_torch.models import layers as ML

    free = (torch.cuda.mem_get_info()[0]
            if torch.device(device).type == "cuda" else None)
    for r in range(B, 0, -1):
        need = _moe_peak_bytes(cfg, r * (S + n_new))
        whole = all(t <= ML.MOE_GROUP or t % ML.MOE_GROUP == 0
                    for t in (r * S, r * (S + n_new)))
        if whole and (free is None or need <= 0.8 * free):
            return r, need, free
    raise AssertionError(f"no batch of rows of {S} + {n_new} tokens is "
                         f"whole MoE groups within the card's {free} B free")


def run_serve_path(name: str, cfg, params, traffic: ServeTraffic,
                   kernels: tuple, mods: dict, device, memory=None) -> dict:
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
    4. ``ServingEngine.generate`` returns the loop's tokens; for a
       cross-attention model, which serves its ``memory`` through
       ``prefill`` and ``decode_step`` (every step above, and the
       forwards, over it), ``generate`` raises naming the memory, as the
       JAX package's cannot serve one either;
    5. every logit is finite.

    An MoE layer takes its capacity over a call's own tokens, so a cached
    decode and a cache-free forward rightly drop other slots; for an MoE
    model the gates are instead:

    1. the launches call by call (``_serve_launches``: the prefill flash
       once and the expert matmul three times an MoE layer, every decode
       step the expert matmul three times a layer and flash never), and
       every layer call's capacity and drops the reference's over the
       call's own tokens (``_capacity_gate``);
    2. as above (both route the same tokens in the same groups);
    3. at full depth, ``_moe_full_depth``: the served logits against the
       same cached decode through the plain versions with the served picks
       replayed, within FLOOR_FACTOR of the floor (the forward through the
       kernels against through the plain versions, picks replayed), never
       tighter than CHECK_TOL; the teacher-forced forward at
       SERVE_CHECK_DEPTH repetitions, with no slot dropped, and card
       against CPU at the config's capacity are ``run_moe_serve_cut``'s,
       which the caller runs once the other layers' weights are freed;
    4. and 5. as above.

    Prints the prefill ms, the decode step's p50 and p90 beside its byte
    bound (``_decode_bytes`` at HBM_BYTES_PER_S), tokens/s, the cache's
    bytes, the peak memory and the launches.  The kernel calls are
    recorded on the card (one operand set a shape for an MoE model: the
    expert weights are 403 MB a call) and parked on the host right after
    the run.  Returns the counts, the recorded kernel calls and the
    numbers."""
    from repro_torch import serving as SV
    from repro_torch.models import transformer as MT

    t_path = time.perf_counter()
    B, n_new = traffic.batch, traffic.max_new
    moe = bool(cfg.n_experts)
    prompts = serve_prompts(traffic, cfg.vocab_size)
    toks = torch.from_numpy(SV.left_pad(prompts, B)).to(device)
    S = toks.shape[1]
    torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as stack:
        recorded = {k: stack.enter_context(record_calls(
            importlib.import_module(ks.site[0]), ks.site[1], ks.key,
            keep=1 if moe else RECORDED_OPERANDS))
            for k, ks in KERNELS.items()}
        routes = stack.enter_context(record_routes(slim=True))
        _zero_counts(mods)
        run = serve_loop(params, cfg, toks, traffic, device, memory,
                         counts=lambda: _counts(mods))
        launches = _counts(mods)
    park({"recorded": recorded})
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
    if moe:
        print(f"{name}: path 3's launches: "
              f"{_serve_launches(name, cfg, run['launches_by_call'])}; "
              f"capacity: {_capacity_gate(name, cfg, routes, [B * S] + [B] * (n_new - 1))}")
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in MT.tree_leaves(run["cache"]))
    # a decode step's arguments as the card holds them (path 9's gate)
    arg_bytes = storage_bytes((params, run["cache"], run.pop("step_inputs")))
    step_bytes = _decode_bytes(params, cfg, run.pop("cache"))
    peak = torch.cuda.max_memory_allocated()

    t2 = time.perf_counter()
    fresh = _logits_at(params, cfg, toks, S - 1, 1, memory)[:, 0]
    err_prefill = float(_row_err(run["served"][:, 0], fresh).max())
    if not err_prefill < CHECK_TOL:
        raise AssertionError(f"{name}: the prefill's logits differ from the "
                             f"cache-free forward's by {err_prefill!r} of "
                             f"the largest (limit {CHECK_TOL})")
    print(f"{name}: path 3's prefill vs a forward over the prompts alone "
          f"{err_prefill!r} of each row's largest (limit {CHECK_TOL})")
    if moe:
        _moe_full_depth(name, cfg, params, toks, traffic, run, routes,
                        device)
    else:
        _serve_depth_checks(name, cfg, params, toks, traffic, run, device,
                            memory)
    del routes
    print(f"{name}: path 3's checks in {time.perf_counter() - t2!r} s")

    engine = SV.ServingEngine(cfg, params, B, traffic.cache_len, eos_id=-1,
                              device=device)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    if memory is None:
        outs = engine.generate(prompts, n_new)
        if outs != run["generated"].tolist():
            raise AssertionError(f"{name}: ServingEngine.generate's tokens "
                                 f"differ from the prefill / decode_step "
                                 f"loop's")
        how, same = "ServingEngine.generate", ", the same tokens as the loop"
    else:
        try:
            engine.generate(prompts, n_new)
        except ValueError as e:
            if "memory" not in str(e):
                raise
        else:
            raise AssertionError(f"{name}: ServingEngine.generate served a "
                                 f"cross-attention model without its memory")
        outs = run["generated"].tolist()
        how, same = ("the prefill / decode_step loop (generate takes no "
                     "memory)", "")
    torch.cuda.synchronize()
    gen_s = (time.perf_counter() - t3 if memory is None else
             (run["prefill_ms"] + sum(run["steps_ms"])) * 1e-3)
    n_tok = sum(len(row) for row in outs)
    deciles = statistics.quantiles(run["steps_ms"], n=10, method="inclusive")
    p50, p90 = deciles[4], deciles[8]
    bound_ms = step_bytes / HBM_BYTES_PER_S * 1e3
    print(f"{name}: path 3 on {_card_line()}: B {B}, prompts "
          f"{[len(p) for p in prompts]} padded to {S}, {n_new} new tokens, "
          f"cache_len {traffic.cache_len}; prefill {run['prefill_ms']!r} ms; "
          f"decode step (one token for each of the {B} rows) p50 {p50!r} "
          f"ms, p90 {p90!r} ms over {len(run['steps_ms'])} steps, beside "
          f"its byte bound {bound_ms!r} ms ({step_bytes} B: the weights, "
          f"the head and the cache, at {HBM_BYTES_PER_S} B/s; "
          f"{B / bound_ms * 1e3!r} tokens/s at most); "
          f"{how} {n_tok} tokens in {gen_s!r} s = "
          f"{n_tok / gen_s!r} tokens/s{same}; cache "
          f"{cache_bytes} B; peak device memory {peak} B; launches "
          f"{launches} (a decode step's: {run['launches_by_call'][-1]}); "
          f"path 3 in {time.perf_counter() - t_path!r} s")
    return {"launches": launches, "recorded": recorded,
            "prefill_ms": run["prefill_ms"], "decode_ms_p50": p50,
            "decode_ms_p90": p90, "decode_bound_ms": bound_ms,
            "decode_bytes": step_bytes, "decode_arg_bytes": arg_bytes,
            "tokens_per_s": n_tok / gen_s, "cache_bytes": cache_bytes,
            "peak_bytes": peak}


def _serve_depth_checks(name, cfg, params, toks, traffic, run, device,
                        memory) -> None:
    """Gate 3 of ``run_serve_path`` for a model without MoE layers: the
    teacher-forced forward at full depth within FLOOR_FACTOR of the floor,
    then at SERVE_CHECK_DEPTH repetitions within CHECK_TOL."""
    B, n_new = traffic.batch, traffic.max_new
    S = toks.shape[1]
    full = teacher_forced(params, cfg, toks, run, memory)
    seq = torch.cat([toks, run["generated"]], dim=1)
    with plain_kernels():
        plain = _logits_at(params, cfg, seq, S - 1, n_new, memory)
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
          f"{full['worst_gap']!r})")
    if not err_full <= limit:
        raise AssertionError(f"{name}: path 3's cached decode differs from "
                             f"the teacher-forced forward past {limit!r}")
    del full, plain

    cut_cfg, cut_params = serve_cut(cfg, params)
    n_cut = cut_cfg.n_layers
    cut = teacher_forced(cut_params, cut_cfg, toks, serve_loop(
        cut_params, cut_cfg, toks, traffic, device, memory), memory)
    err_cut = float(cut["err"].max())
    print(f"{name}: path 3 at {n_cut} layers, teacher-forced: served logits "
          f"vs the cache-free forward {err_cut!r} of each row's largest "
          f"(limit {CHECK_TOL}); {cut['off']} of {B * n_new} greedy tokens "
          f"off the forward's argmax, each a near tie (largest gap "
          f"{cut['worst_gap']!r}, limit {CHECK_TOL})")
    if not (err_cut < CHECK_TOL and cut["worst_gap"] <= CHECK_TOL):
        raise AssertionError(f"{name}: path 3's cached decode at {n_cut} "
                             f"layers differs from the teacher-forced "
                             f"forward past {CHECK_TOL}")


def serve_cut(cfg, params) -> tuple:
    """The first SERVE_CHECK_DEPTH pattern repetitions of a model, with its
    embedding, final norm and head: (config, parameters) sharing the
    tensors of ``params``."""
    n_cut = min(cfg.n_layers, SERVE_CHECK_DEPTH * len(cfg.pattern))
    return (dataclasses.replace(cfg, n_layers=n_cut),
            dict(params, stack={"layers": params["stack"]["layers"][:n_cut]}))


def _greedy_gap(want, generated) -> tuple:
    """The greedy tokens off ``want``'s argmax (B, n, V): how many, and
    the largest gap between its top logit and its logit of the token,
    over the row's largest |logit| (0 where there is none)."""
    gap = (want.amax(-1) - torch.gather(want, -1, generated[..., None])[
        ..., 0]) / want.abs().amax(-1)
    other = generated != want.argmax(-1)
    return int(other.sum()), float(gap[other].max()) if other.any() else 0.0


def run_moe_serve_cut(name: str, cfg, params, traffic: ServeTraffic,
                      device) -> dict:
    """Path 3's gates at SERVE_CHECK_DEPTH pattern repetitions for an MoE
    model, on ``serve_cut`` of the weights path 2 ran (the caller has freed
    the other layers, so that the no-drop check has the card's memory):

    1. no drops: ``capacity_factor`` set to E / k, so that C >= g in every
       call and no slot can drop, on the most rows of path 3's prompts that
       fit (``_no_drop_rows``, printed): the served logits against the
       teacher-forced cache-free forward over prompt + generated, route
       aware (``_moe_gate`` over every position: each pick of the cached
       decode that the forward's router would not make a near tie there,
       the outputs before their sequence's first token that routes
       otherwise within CHECK_TOL of the forward, every output within
       CHECK_TOL of the forward with the decode's picks replayed), and each
       greedy token that replay's argmax or within CHECK_TOL of it;
    2. card against CPU at the config's own capacity, every row, on the
       last SERVE_CPU_TOKENS tokens of each padded prompt (whole MoE
       groups): the card serves their prefill and SERVE_CPU_STEPS greedy
       decode steps; the CPU runs its plain cached prefill and decode
       steps fed the card's tokens, once with its own routing and once
       with the card's picks replayed call by call, decode steps included
       (the places and drops ``==`` the card's); ``_moe_gate`` over the
       prefill's and the steps' logits.

    Returns the readings."""
    from repro_torch import serving as SV
    from repro_torch.models import layers as ML
    from repro_torch.models import transformer as MT

    t0 = time.perf_counter()
    prompts = serve_prompts(traffic, cfg.vocab_size)
    toks = torch.from_numpy(SV.left_pad(prompts, traffic.batch)).to(device)
    B, S = toks.shape
    n_new, V = traffic.max_new, cfg.vocab_size
    E, k = cfg.n_experts, cfg.moe_top_k

    nd_cfg = dataclasses.replace(cfg, capacity_factor=E / k)
    rows, need, free = _no_drop_rows(nd_cfg, B, S, n_new, device)
    print(f"{name}: path 3's no-drop check takes {rows} of {B} rows")
    sub = toks[:rows]
    with record_routes() as served_routes:
        nd = serve_loop(params, nd_cfg, sub, traffic._replace(batch=rows),
                        device)
    with record_routes() as fw_routes:
        tf = teacher_forced(params, nd_cfg, sub, nd)
    served_tok = _routes_by_token(served_routes, nd_cfg, rows)
    fw_tok = _routes_by_token(fw_routes, nd_cfg, rows)
    P = S + n_new - 1  # the positions the served run routed
    replay = []
    for fw, sv, ft in zip(fw_routes, served_tok, fw_tok):
        idx = torch.cat([sv.idx.reshape(rows, P, k),
                         ft.idx.reshape(rows, P + 1, k)[:, P:]], dim=1)
        replay.append(ML.routing_of_picks(fw.logits, fw.probs, idx.reshape(
            fw.idx.shape), fw.capacity))
    for ft in fw_tok:
        for f in ("logits", "idx", "keep"):
            t = getattr(ft, f)
            setattr(ft, f, t.reshape(rows, P + 1, -1)[:, :P].flatten(0, 1))
    seq = torch.cat([sub, nd["generated"]], dim=1)
    with record_routes(replay=replay):
        replayed = _logits_at(params, nd_cfg, seq, S - 1, n_new)
    off, gap = _greedy_gap(replayed, nd["generated"])
    at = list(range(S - 1, S - 1 + n_new))
    try:
        line = _moe_gate(nd["served"].reshape(-1, V), tf["want"].reshape(
            -1, V), replayed.reshape(-1, V), served_tok, fw_tok, rows,
            ("cached decode", "cache-free forward"), at)
    except AssertionError as e:
        raise AssertionError(f"{name}: path 3's no-drop teacher-forced check "
                             f"at {cfg.n_layers} layers: {e}") from None
    print(f"{name}: path 3 at {cfg.n_layers} layers with capacity_factor "
          f"{E / k} (no slot drops), {rows} of {B} rows ({need} B planned "
          f"for an MoE layer of the forward, {free} B free), cached decode "
          f"vs the teacher-forced forward over {S} + {n_new} tokens: {line}; "
          f"{off} of {rows * n_new} greedy tokens off the argmax of the "
          f"forward with the decode's picks, each a near tie (largest gap "
          f"{gap!r}, limit {CHECK_TOL})")
    if not gap <= CHECK_TOL:
        raise AssertionError(f"{name}: path 3's no-drop check: a greedy "
                             f"token {gap!r} of the largest |logit| off the "
                             f"forward's argmax")
    del nd, tf, replayed, served_routes, fw_routes, replay
    torch.cuda.empty_cache()

    t1 = time.perf_counter()
    n_cpu = min(SERVE_CPU_STEPS, n_new - 1)
    short = traffic._replace(max_new=n_cpu + 1)
    toks = toks[:, -min(S, SERVE_CPU_TOKENS):]
    S = toks.shape[1]
    with record_routes() as card_routes:
        card = serve_loop(params, cfg, toks, short, device)
    cpu_params = MT.tree_map(lambda t: t.cpu(), params)
    fed = card["generated"].cpu()
    runs = {}
    for how, replay_of in (("own", None), ("replayed", card_routes)):
        t2 = time.perf_counter()
        with record_routes(replay=replay_of) as cpu_routes:
            runs[how] = serve_loop(cpu_params, cfg, toks.cpu(), short, "cpu",
                                   feed=fed)
        runs[how]["routes"], runs[how]["s"] = (cpu_routes,
                                              time.perf_counter() - t2)
    at = list(range(S - 1, S + n_cpu))
    try:
        line = _moe_gate(
            card["served"].float().cpu().reshape(-1, V),
            runs["own"]["served"].reshape(-1, V),
            runs["replayed"]["served"].reshape(-1, V),
            _routes_by_token(card_routes, cfg, B),
            _routes_by_token(runs["own"]["routes"], cfg, B), B, at=at)
    except AssertionError as e:
        raise AssertionError(f"{name}: path 3 card vs CPU at "
                             f"{cfg.n_layers} layers: {e}") from None
    print(f"{name}: path 3 at {cfg.n_layers} layers, capacity_factor "
          f"{cfg.capacity_factor}, all {B} rows of their last {S} prompt "
          f"tokens: the card's prefill and first {n_cpu} decode steps (N) "
          f"vs the CPU's plain ones fed the card's tokens: {line}; the "
          f"CPU's runs {runs['own']['s']!r} and "
          f"{runs['replayed']['s']!r} s, the checks in "
          f"{time.perf_counter() - t0!r} s ({time.perf_counter() - t1!r} s "
          f"of them card vs CPU)")
    return {"no_drop_rows": rows, "cpu_steps": n_cpu}



# ------------------------------------------------------------------ path 4 --
# the block kinds that run each forward kernel of path 4's models, and the
# calls of it a layer of those kinds makes where that is not one (an MoE
# FFN's gate, up and down products)
KERNEL_KINDS = {"flash_attention": ("attn", "local_attn", "moe", "moe_dense"),
                "ssd": ("ssd",), "moe_gmm": ("moe", "moe_dense"),
                "rglru": ("rglru",)}
KERNEL_CALLS = {"moe_gmm": 3}


def _train_launches(cfg, kernel: str) -> tuple[int, int]:
    """A train step's (forward, backward) launches of the forward kernel
    ``kernel`` and of its backward: every layer of its kinds KERNEL_CALLS
    times each way (each forward call under autograd is one autograd
    Function, whose backward is one backward launch), and the forward once
    more in every full pattern repetition that ``cfg.remat`` recomputes."""
    from repro_torch.models import transformer as MT

    full = cfg.n_layers // len(cfg.pattern) * len(cfg.pattern)
    calls = KERNEL_CALLS.get(kernel, 1)
    layers = [i for i, kind in enumerate(MT.layer_kinds(cfg.n_layers,
                                                        cfg.pattern))
              if kind in KERNEL_KINDS[kernel]]
    return (calls * sum(2 if cfg.remat and i < full else 1 for i in layers),
            calls * len(layers))


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


def _rel2(out, ref, scale=None) -> float:
    """||out - ref|| / ||scale|| (``ref`` unless given), in float64."""
    d = (out.double() - ref.double()).norm()
    scale = ref if scale is None else scale
    return float(d / scale.double().norm().clamp_min(1e-300))


def _grad_limit(floor: float) -> float:
    """Path 4's limit for a gradient whose plain versions on the card lie
    ``floor`` from the CPU: CHECK_TOL, or GRAD_FLOOR_FACTOR times the floor
    where the floor itself passes CHECK_TOL."""
    return CHECK_TOL if floor < CHECK_TOL else GRAD_FLOOR_FACTOR * floor


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
    error is printed beside.  Beside each gradient, the same through the
    plain versions on the card against the CPU (the floor of two bf16
    evaluations) is printed, leaf by leaf; where that floor passes
    CHECK_TOL itself, the gradient's limit is GRAD_FLOOR_FACTOR times its
    floor (``_grad_limit``), and the count of such limits and the largest
    are printed.  With MoE layers the gate is aware of routing: the CPU's
    forwards and backwards (and the floor's) replay the card's expert
    picks, call for call (``record_routes(replay=...)``), where the CPU's
    own router must pick as the card does up to near ties (within
    CHECK_TOL of the largest |logit|, half the tokens at least alike at
    every layer).  Raises on a failure, else returns the readings."""
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
    moe = any(kind in KERNEL_KINDS["moe_gmm"]
              for kind in MT.layer_kinds(n, cfg.pattern))

    def routed(replay=None, own=None):
        return (record_routes(replay, own) if moe else
                contextlib.nullcontext([]))

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

    with routed() as card_in_routes:
        card_in = grad_in(sub, x).float().cpu()
    with routed() as card_p_routes:
        card_p = [g.float().cpu() for g in param_grads(sub, x)]
    own: list = []
    with routed(card_in_routes, own):
        cpu_in = grad_in(cpu_sub, x.cpu()).float()
    with routed(card_p_routes):
        cpu_p = [g.float() for g in param_grads(cpu_sub, x.cpu())]
    err_in = _rel(card_in, cpu_in)
    errs = [_rel2(a, b) for a, b in zip(card_p, cpu_p)]
    tops = [_rel(a, b) for a, b in zip(card_p, cpu_p)]
    del card_p  # the host holds one set of gradients beside the CPU's
    with plain_kernels():
        with routed(card_in_routes):
            floor_in = _rel(grad_in(sub, x).float().cpu(), cpu_in)
        with routed(card_p_routes):
            floors = [_rel2(g.float().cpu(), c) for g, c in zip(
                param_grads(sub, x), cpu_p)]
    names = [".".join(map(str, path)) for path, _ in MT.tree_paths(sub)]
    limit_in = _grad_limit(floor_in)
    limits = [_grad_limit(f) for f in floors]
    by_floor = [lim for lim in [limit_in, *limits] if lim != CHECK_TOL]
    worst = max(range(len(errs)), key=lambda i: errs[i] / limits[i])
    top = max(range(len(tops)), key=tops.__getitem__)
    routing = near_ties = ""
    if moe:
        ra = ML.routing_agreement(
            [(r.logits.cpu(), r.idx.cpu(), r.keep.cpu())
             for r in card_in_routes],
            [(r.logits, r.idx, r.keep) for r in own])
        near_ties = ra.flips_are_near_ties(CHECK_TOL) and \
            2 * int(ra.agree.sum()) >= B * S
        routing = (f"; routing of the grad_in forward: {ra.flips} of "
                   f"{ra.picks} expert picks differ by slot, {ra.diverged} "
                   f"of {B * S} tokens keep other experts at some layer, the "
                   f"largest distance of a differing expert from the CPU's "
                   f"top-k cut {ra.worst_gap!r} of the largest |logit| "
                   f"(limit {CHECK_TOL}); the CPU replayed the card's "
                   f"picks in {len(card_in_routes)} + {len(card_p_routes)} "
                   f"router calls")
    line = (f"first {n} blocks at S {CHECK_SEQ}, card (kernels) vs CPU "
            f"(plain versions) in {cfg.compute_dtype}: grad_in {err_in!r} "
            f"of its largest magnitude (the plain versions on the card "
            f"{floor_in!r}; limit {limit_in!r}); the {len(errs)} parameter "
            f"gradients in 2-norm, nearest their limit {errs[worst]!r} "
            f"({names[worst]}; the floor {floors[worst]!r}, limit "
            f"{limits[worst]!r}), up to {max(errs)!r} (the plain versions "
            f"on the card up to {max(floors)!r}); {len(by_floor)} of "
            f"{len(limits) + 1} limits set by a floor past CHECK_TOL "
            f"{CHECK_TOL} (GRAD_FLOOR_FACTOR {GRAD_FLOOR_FACTOR} x the "
            f"floor), the largest {max(by_floor, default=None)!r}; their "
            f"largest element up to {tops[top]!r} ({names[top]}) of each "
            f"one's largest magnitude{routing}; every leaf (card vs CPU, the "
            f"plain versions' floor): " + ", ".join(
                f"{nm} {e!r} ({f!r})" for nm, e, f in zip(names, errs, floors))
            + f"; in {time.perf_counter() - t0!r} s")
    if moe and not near_ties:
        raise AssertionError(f"{name}: the card's routing is not the CPU's "
                             f"up to near ties; {line}")
    if not (err_in < limit_in and errs[worst] < limits[worst]):
        raise AssertionError(f"{name}: path 4's gradients on the card differ "
                             f"from the CPU's past the limit; {line}; every "
                             f"leaf (error, limit): "
                             f"{dict(zip(names, zip(errs, limits)))}")
    return line


def _recorded_run(mods, fn, device=None,
                  keep: int = RECORDED_OPERANDS) -> tuple:
    """``fn()`` with every kernel's calls recorded (up to ``keep`` operand
    sets a shape, copied to ``device`` where it is given) and the counts
    set to 0 just before it and read just after: (its result, launches,
    recorded), each kernel's recorded calls checked against its
    launches."""
    with contextlib.ExitStack() as stack:
        recorded = {k: stack.enter_context(record_calls(
            importlib.import_module(ks.site[0]), ks.site[1], ks.key, device,
            keep)) for k, ks in KERNELS.items()}
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
       the model's depth, the counts set to 0 just before and read just
       after (one forward and one backward launch a layer of each kernel's
       kinds, three for the expert matmul); its charges and event replay
       gated (``_round_trip_gates``); ``grad_in`` finite;
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

    The kernel calls of parts 1 and 3 are recorded on the host, one
    operand set a shape (the MoE path's three a shape took 22 GB: the
    expert weights are 403 MB a call).
    Returns each part's counts and recorded kernel calls, and the
    numbers."""
    from repro_torch.data import BatchSpec, SyntheticLM, shard_batch
    from repro_torch.msl import ChainSimulator, plan_pipeline
    from repro_torch.optim import make_optimizer
    from repro_torch.train import make_train_step

    t_path = time.perf_counter()
    B, S = traffic.batch, traffic.seq
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(4)).to(
        device)
    pp = plan_pipeline(cfg, seq_len=S, microbatch=B, mode="TR", device=device)
    sim = ChainSimulator(cfg, params, pp.problem.net, pp.problem.profile,
                         pp.problem.request)
    torch.cuda.reset_peak_memory_stats()
    rt, rt_launches, rt_recorded = _recorded_run(
        mods, lambda: sim.round_trip(pp.plan, tokens), "cpu", 1)
    rt_peak = torch.cuda.max_memory_allocated()
    for fwd, bwd in traffic.pairs():
        per_layer = _train_launches(dataclasses.replace(cfg, remat=False),
                                    fwd)
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
    # a step's arguments as the card holds them (path 9's gate)
    arg_bytes = storage_bytes((params, state, batches[0]))
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

    (losses, norms, step_ms), launches, recorded = _recorded_run(
        mods, steps, "cpu", 1)
    peak = torch.cuda.max_memory_allocated()
    per_step = {}
    for fwd, bwd in traffic.pairs():
        per_step[fwd] = _train_launches(cfg, fwd)
        want = tuple(traffic.steps * n for n in per_step[fwd])
        if (launches[fwd], launches[bwd]) != want:
            raise AssertionError(f"{name}: {traffic.steps} train steps "
                                 f"launched {launches[fwd]} {fwd} and "
                                 f"{launches[bwd]} {bwd} kernels, not "
                                 f"{want}")
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
            "peak_bytes": peak, "arg_bytes": arg_bytes}


def run_fresh_train_path(name: str, mods: dict, device) -> dict:
    """Path 4 for a model of TRAIN with a ``layers`` depth, after path 2's
    weights are freed and its recorded calls parked on the host: the
    training state counted before it is allocated (``_planned_bytes`` of
    the config at that depth, four times: float32 weights, gradients and
    AdamW's two moments) and held to the card's free memory, then fresh
    weights at full width from seed 0 in the config's own float32, and
    ``run_train_path`` on them."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import transformer as MT

    traffic = TRAIN[name]
    cfg = dataclasses.replace(ARCHS[name], n_layers=traffic.layers)
    weights = _planned_bytes(cfg, device)
    free, total = torch.cuda.mem_get_info()
    print(f"{name}: path 4 at {cfg.n_layers} of {ARCHS[name].n_layers} "
          f"layers, full width, {cfg.param_dtype} weights: {weights} B of "
          f"weights, {4 * weights} B with their gradients and AdamW's "
          f"moments, against {free} B free of the card's {total} B")
    if 4 * weights > free:
        raise AssertionError(f"{name}: path 4's training state, "
                             f"{4 * weights} B, does not fit the card's "
                             f"{free} B free")
    params = MT.init_params(torch.Generator(device=device).manual_seed(0),
                            cfg, device=device)
    n_bytes = sum(t.numel() * t.element_size()
                  for t in MT.tree_leaves(params))
    if n_bytes != weights:
        raise AssertionError(f"{name}: {n_bytes} B of weights allocated, "
                             f"{weights} B planned")
    return run_train_path(name, cfg, params, traffic, mods, device)


# ------------------------------------------------------------------ path 7 --
class PipeTraffic(NamedTuple):
    """Path 7's forward for one model: ``batch`` x ``seq`` tokens in
    PIPE_MICRO microbatches."""
    batch: int
    seq: int


# path 7, in each model's turn: the forward right after path 2, and for the
# models of TRAIN, PIPE_STEPS pipelined train steps on path 4's traffic
# right after path 4; recurrentgemma at S 4096, so that its window masks
# keys, and at full depth its 13th group is the two remainder layers
PIPE_MICRO = 2
PIPE_STEPS = 4
PIPELINE = {
    "qwen2-1.5b": PipeTraffic(2, 2048),
    "mamba2-370m": PipeTraffic(2, 2048),
    "qwen3-moe-30b-a3b": PipeTraffic(2, 2048),
    "recurrentgemma-9b": PipeTraffic(2, 4096),
}
LAUNCH_ARCH = "qwen2-1.5b"  # the launchers' model, at --reduced


def _cat_routes(per_micro: list) -> list:
    """Each MoE layer's routings of the microbatches, one per layer, as
    one routing of the whole batch (the groups of 1,024 tokens of the
    microbatches, in order, are the whole batch's)."""
    from repro_torch.models import layers as ML

    return [ML.Routing(*(torch.cat(parts) for parts in zip(
        *(r[:-1] for r in layer))), layer[0].capacity)
        for layer in zip(*per_micro)]


def _pipe_whole_batch(name, cfg, params, tokens, hidden) -> str:
    """The pipelined hidden state against ``T.forward`` of the whole batch
    on the card, within CHECK_TOL of the largest magnitude: the same
    blocks on other shapes.  With MoE layers the whole batch's router
    products round otherwise (fp32 GEMMs of other shapes), so near ties
    pick other experts and bf16 carries each difference through the depth
    (call 3, PR 25: 4,089 of 4,096 tokens of qwen3-moe-30b-a3b kept other
    experts at some layer of 48, every one first at a near tie, and with
    the microbatches' picks replayed the whole batch still lay 0.025 of
    the largest magnitude away).  So there the full depth is printed and
    the gate is path 2's: the first TRAIN_CHECK_DEPTH repetitions through
    the pipeline (one stage, the microbatches in order) against the whole
    batch's forward of them, route-aware (``_moe_gate``), with its own
    routing and with the microbatches' expert picks replayed."""
    from repro_torch.models import layers as ML
    from repro_torch.models import transformer as MT
    from repro_torch.msl import PipelinePlan, make_pipeline_mesh
    from repro_torch.msl import pipeline as MP

    B, S = tokens.shape
    M = PIPE_MICRO
    ctx = ML.Ctx(mode="train", positions=torch.arange(
        S, device=tokens.device).expand(B, S))
    with torch.no_grad():
        whole, _, _ = MT.forward(params, cfg, tokens, ctx)
    err = _rel(hidden.float(), whole.float())
    if not cfg.n_experts:
        if not err < CHECK_TOL:
            raise AssertionError(f"{name}: the pipelined hidden state lies "
                                 f"{err!r} of the largest magnitude from the "
                                 f"whole batch's forward (limit {CHECK_TOL})")
        return f"{err!r} of the largest magnitude (limit {CHECK_TOL})"
    if (B // M * S) % ML.MOE_GROUP:
        raise ValueError(f"{name}: a microbatch of {B // M * S} tokens is "
                         f"not whole MoE groups of {ML.MOE_GROUP}, so its "
                         f"routing is not the whole batch's")
    n = min(cfg.n_layers, TRAIN_CHECK_DEPTH * len(cfg.pattern))
    R = -(-n // len(cfg.pattern))
    sub_cfg = dataclasses.replace(cfg, n_layers=n)
    sub = dict(params, stack={"layers": params["stack"]["layers"][:n]})
    plan = PipelinePlan(K=1, segments=[(1, R)], placement=["s0"],
                        n_groups=R, predicted_latency_s=0.0, breakdown={})
    with torch.no_grad(), record_routes() as routes:
        got, _ = MP.pipeline_forward(sub, {"tokens": tokens}, sub_cfg,
                                     make_pipeline_mesh(1,
                                                        device=tokens.device),
                                     plan, M)
    per = len(routes) // M  # one stage: microbatch by microbatch
    picks = _cat_routes([routes[m * per:(m + 1) * per] for m in range(M)])
    with torch.no_grad(), record_routes() as own:
        want, _, _ = MT.forward(sub, sub_cfg, tokens, ctx)
    with torch.no_grad(), record_routes(replay=picks):
        replayed, _, _ = MT.forward(sub, sub_cfg, tokens, ctx)
    try:
        line = _moe_gate(*(t.float().reshape(-1, cfg.d_model)
                           for t in (got, want, replayed)), picks, own, B,
                         ("microbatches", "whole batch"))
    except AssertionError as e:
        raise AssertionError(f"{name}: pipelined vs whole batch: {e}") \
            from None
    return (f"at full depth {err!r} of the largest magnitude (not gated: "
            f"near-tie routing carried through {cfg.n_layers} layers); the "
            f"first {n} blocks, route-aware: {line}")


def run_pipeline_path(name: str, cfg, params, traffic: PipeTraffic,
                      mods: dict, device) -> dict:
    """Path 7's forward for one model, on path 2's weights:
    ``plan_pipeline(mode="TR")`` for a microbatch of B / PIPE_MICRO rows
    and ``msl.pipeline_forward`` through its K stages, the counts set to 0
    just before the plan and read just after the forward.  Gates: every
    microbatch's hidden state ``==`` ``T.forward`` of its rows (the same
    blocks on the same shapes, through the same kernels), the aux ``==``
    those forwards' aux summed over M + K - 1, each kernel launched as often
    as in those forwards, the scan launched, and the whole batch's forward
    within CHECK_TOL (``_pipe_whole_batch``)."""
    from repro_torch.models import layers as ML
    from repro_torch.models import transformer as MT
    from repro_torch.msl import make_pipeline_mesh, plan_pipeline
    from repro_torch.msl import pipeline as MP

    t_path = time.perf_counter()
    B, S, M = traffic.batch, traffic.seq, PIPE_MICRO
    mb = B // M
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(6)).to(
        device)
    torch.cuda.reset_peak_memory_stats()

    def run():
        t0 = time.perf_counter()
        pp = plan_pipeline(cfg, seq_len=S, microbatch=mb, mode="TR",
                           device=device)
        t1 = time.perf_counter()
        mesh = make_pipeline_mesh(pp.K, device=device)
        with torch.no_grad():
            hidden, aux = MP.pipeline_forward(params, {"tokens": tokens},
                                              cfg, mesh, pp, M)
        torch.cuda.synchronize()
        return pp, hidden, aux, t1 - t0, time.perf_counter() - t1

    (pp, hidden, aux, plan_s, pipe_s), launches, recorded = _recorded_run(
        mods, run)
    peak = torch.cuda.max_memory_allocated()
    K = pp.K
    print(f"{name}: path 7 plan_pipeline(mode=TR, microbatch {mb}) on the "
          f"card: K {K}, groups {pp.segments} on {pp.placement} in "
          f"{plan_s!r} s; pipelined forward of B {B} x S {S} in {M} "
          f"microbatches over {M + K - 1} ticks in {pipe_s!r} s; launches "
          f"{launches}; peak device memory {peak} B")
    if hidden.shape != (B, S, cfg.d_model) or not bool(
            torch.isfinite(hidden).all()):
        raise AssertionError(f"{name}: the pipelined hidden state "
                             f"{tuple(hidden.shape)} is not finite of shape "
                             f"{(B, S, cfg.d_model)}")

    _zero_counts(mods)
    total = torch.zeros((), dtype=torch.float32, device=device)
    t0 = time.perf_counter()
    for m in range(M):
        rows = slice(m * mb, (m + 1) * mb)
        ctx = ML.Ctx(mode="train", positions=torch.arange(
            S, device=device).expand(mb, S))
        with torch.no_grad():
            h, _, a = MT.forward(params, cfg, tokens[rows], ctx)
        if not torch.equal(hidden[rows], h):
            raise AssertionError(
                f"{name}: microbatch {m}'s pipelined hidden state differs "
                f"from T.forward of its rows by up to "
                f"{float((hidden[rows].float() - h.float()).abs().max())}")
        total = total + a
        del h
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    alone = _counts(mods)
    want_aux = total / (M + K - 1)
    if not torch.equal(aux, want_aux):
        raise AssertionError(f"{name}: the pipelined aux {float(aux)!r} is "
                             f"not the microbatches' {float(total)!r} over "
                             f"{M + K - 1} ticks, {float(want_aux)!r}")
    for k in ("minplus_scan",) + MODELS[name].kernels:
        if launches[k] == 0:
            raise AssertionError(f"{name}: path 7 launched no {k} kernel")
    for k in MODELS[name].kernels:
        if launches[k] != alone[k]:
            raise AssertionError(f"{name}: the pipelined forward launched "
                                 f"{launches[k]} {k} kernels, the "
                                 f"microbatches' forwards {alone[k]}")
    whole = _pipe_whole_batch(name, cfg, params, tokens, hidden)
    print(f"{name}: path 7 pipelined forward == T.forward of each "
          f"microbatch's rows on the card (max |h| "
          f"{float(hidden.float().abs().max())!r}; the {M} forwards in "
          f"{seq_s!r} s), aux {float(aux)!r} == their aux over {M + K - 1} "
          f"ticks; against the whole batch's forward: {whole}")
    del hidden
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_path
    print(f"{name}: path 7 forward in {seconds!r} s")
    return {"launches": launches, "recorded": recorded, "K": K,
            "seconds": seconds,
            "segments": pp.segments, "pipelined_s": pipe_s,
            "sequential_s": seq_s, "peak_bytes": peak}


def _pipe_train_launches(cfg, kernel: str, n_micro: int) -> tuple[int, int]:
    """A pipelined train step's (forward, backward) launches of ``kernel``:
    each layer of its kinds once each way per microbatch, and the forward
    once more under ``cfg.remat``, which recomputes every group slot."""
    from repro_torch.models import transformer as MT

    n = KERNEL_CALLS.get(kernel, 1) * sum(
        kind in KERNEL_KINDS[kernel]
        for kind in MT.layer_kinds(cfg.n_layers, cfg.pattern))
    return n_micro * n * (2 if cfg.remat else 1), n_micro * n


def _pipe_check_gradients(name, cfg, params, batch, device) -> str:
    """The first TRAIN_CHECK_DEPTH repetitions (with the embedding, final
    norm and head) over K 2 stages of a group each, on the card: the
    pipelined loss (``msl.pipeline_loss``, M PIPE_MICRO) and every
    parameter's gradient against ``train.steps.loss_fn``'s on the same
    weights and batch, neither clipped: the loss within CHECK_TOL
    relative, each leaf within CHECK_TOL in 2-norm.  Raises on a failure,
    else returns the readings."""
    from repro_torch.models import transformer as MT
    from repro_torch.msl import PipelinePlan, make_pipeline_mesh
    from repro_torch.msl import pipeline as MP
    from repro_torch.train import loss_fn

    n = min(cfg.n_layers, TRAIN_CHECK_DEPTH * len(cfg.pattern))
    sub_cfg = dataclasses.replace(cfg, n_layers=n)
    R = -(-n // len(cfg.pattern))
    plan = PipelinePlan(K=2, segments=[(1, R // 2), (R // 2 + 1, R)],
                        placement=["s0", "s1"], n_groups=R,
                        predicted_latency_s=0.0, breakdown={})
    sub = dict(params, stack={"layers": params["stack"]["layers"][:n]})
    names = [".".join(map(str, path)) for path, _ in MT.tree_paths(sub)]

    def grads(loss_of):
        leaves = [t.detach().requires_grad_() for t in MT.tree_leaves(sub)]
        it = iter(leaves)
        tree = MT.tree_map(lambda _: next(it), sub)
        with torch.enable_grad():
            loss = loss_of(tree)
            return loss.detach(), torch.autograd.grad(loss, leaves)

    pipe_loss, pipe = grads(lambda tree: MP.pipeline_loss(
        tree, batch, sub_cfg, make_pipeline_mesh(2, device=device), plan,
        PIPE_MICRO)[0])
    seq_loss, seq = grads(lambda tree: loss_fn(tree, sub_cfg, batch)[0])
    err_loss = abs(float(pipe_loss) - float(seq_loss)) / abs(float(seq_loss))
    errs = [_rel2(a.float(), b.float()) for a, b in zip(pipe, seq)]
    finite = all(bool(torch.isfinite(g).all()) for g in pipe)
    worst = max(range(len(errs)), key=errs.__getitem__)
    line = (f"first {n} blocks over K 2 stages, pipelined vs sequential "
            f"loss_fn on the card: loss {float(pipe_loss)!r} vs "
            f"{float(seq_loss)!r} ({err_loss!r} relative), the {len(errs)} "
            f"parameter gradients up to {errs[worst]!r} ({names[worst]}) "
            f"in 2-norm (limit {CHECK_TOL}), all finite {finite}")
    if not (finite and err_loss < CHECK_TOL and errs[worst] < CHECK_TOL):
        raise AssertionError(f"{name}: path 7's pipelined gradients differ "
                             f"from the sequential loss's; {line}; every "
                             f"leaf: {dict(zip(names, errs))}")
    return line


def run_pipeline_train_path(name: str, cfg, traffic: TrainTraffic,
                            mods: dict, device, sequential: dict) -> dict:
    """Path 7's training for one model, right after path 4, from the
    seeded weights path 4's steps started from (drawn again: path 4 left
    its own trained in place, and a fresh AdamW's first step on them moved
    the loss on batch 0 up, 10.39 to 10.52 at qwen2-1.5b, call 1 of PR
    25): path 4's TR
    plan, ``_pipe_check_gradients`` on batch 0, then PIPE_STEPS steps of
    ``msl.make_pipeline_train_step`` (AdamW at TRAIN_LR, remat on) on
    ``SyntheticLM`` batches ``batch_at(i % 2)``, path 4's steps but for
    the microbatches and the clipping, the counts set to 0 just before the
    steps and read just after (``_pipe_train_launches`` a step): every
    loss and parameter finite, the loss on ``batch_at(0)`` lower at step 3
    than at step 1; the losses, the step's p50 ms over steps 2-4, tokens/s
    and peak memory printed beside path 4's sequential step
    (``sequential``, run_train_path's numbers)."""
    from repro_torch.data import BatchSpec, SyntheticLM, shard_batch
    from repro_torch.models import transformer as MT
    from repro_torch.msl import (
        make_pipeline_mesh,
        make_pipeline_train_step,
        plan_pipeline,
    )
    from repro_torch.optim import make_optimizer

    t_path = time.perf_counter()
    B, S, M = traffic.batch, traffic.seq, PIPE_MICRO
    fwd, bwd = traffic.kernels
    params = MT.init_params(torch.Generator(device=device).manual_seed(0),
                            cfg, device=device)
    pp = plan_pipeline(cfg, seq_len=S, microbatch=B, mode="TR", device=device)
    stream = SyntheticLM(BatchSpec(B, S, cfg.vocab_size), seed=0)
    batches = [shard_batch(stream.batch_at(i), device) for i in range(2)]
    check = _pipe_check_gradients(name, cfg, params, batches[0], device)
    print(f"{name}: path 7 {check}")

    opt = make_optimizer(cfg.optimizer, lr=TRAIN_LR, warmup=1, total=50)
    state = opt.init(params, cfg)
    step = make_pipeline_train_step(cfg, make_pipeline_mesh(pp.K,
                                                            device=device),
                                    pp, M, opt)
    torch.cuda.reset_peak_memory_stats()

    def steps():
        nonlocal state
        losses, ms = [], []
        for i in range(PIPE_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, state, m = step(params, state, batches[i % 2])
            losses.append(float(m["loss"]))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return losses, ms

    (losses, step_ms), launches, recorded = _recorded_run(mods, steps)
    peak = torch.cuda.max_memory_allocated()
    per_step = _pipe_train_launches(cfg, fwd, M)
    want = tuple(PIPE_STEPS * n for n in per_step)
    if (launches[fwd], launches[bwd]) != want:
        raise AssertionError(f"{name}: {PIPE_STEPS} pipelined train steps "
                             f"launched {launches[fwd]} {fwd} and "
                             f"{launches[bwd]} {bwd} kernels, not {want}")
    finite = all(bool(torch.isfinite(p).all())
                 for p in MT.tree_leaves(params))
    if not (all(map(math.isfinite, losses)) and finite):
        raise AssertionError(f"{name}: pipelined losses {losses}, every "
                             f"parameter finite: {finite}")
    if not losses[2] < losses[0]:
        raise AssertionError(f"{name}: the pipelined loss on batch_at(0) "
                             f"did not fall from step 1 to step 3: {losses}")
    p50 = statistics.median(step_ms[1:])
    print(f"{name}: path 7 on {_card_line()}: {PIPE_STEPS} pipelined train "
          f"steps (K {pp.K}, groups {pp.segments}, M {M}, {cfg.optimizer}, "
          f"lr {TRAIN_LR}, remat {cfg.remat}, no clipping) at B {B} x S {S}: "
          f"losses {losses}; step ms {step_ms}, p50 over steps 2-"
          f"{PIPE_STEPS} {p50!r} ms = {B * S / (p50 * 1e-3)!r} tokens/s; "
          f"peak device memory {peak} B; launches {launches} ({per_step} a "
          f"step); path 4's sequential step on the same weights and tokens: "
          f"losses {sequential['losses']}, p50 "
          f"{sequential['step_ms_p50']!r} ms = "
          f"{sequential['tokens_per_s']!r} tokens/s, peak "
          f"{sequential['peak_bytes']} B")
    seconds = time.perf_counter() - t_path
    print(f"{name}: path 7 training in {seconds!r} s")
    del state, opt, step, batches, params
    torch.cuda.empty_cache()
    return {"launches": launches, "recorded": recorded, "losses": losses,
            "seconds": seconds,
            "step_ms": step_ms, "step_ms_p50": p50,
            "tokens_per_s": B * S / (p50 * 1e-3), "peak_bytes": peak,
            "K": pp.K, "segments": pp.segments}


def run_launch_path(mods: dict, device) -> dict:
    """Path 7's launchers at ``--reduced`` on ``device``, through their
    ``main``: ``launch.train --mode msl-pp --steps 6 --ckpt-every 3`` once
    straight and once as 4 steps followed by ``--resume``, the final
    checkpoints' every leaf ``==``; then ``launch.serve``, exit 0.  The
    counts are set to 0 just before and read just after: the pipelined
    steps must launch the flash forward and backward kernels."""
    import tempfile

    from repro_torch.ckpt import CheckpointManager, flatten_with_path
    from repro_torch.launch import serve, train

    t0 = time.perf_counter()
    dev = torch.device(device).type
    common = ["--arch", LAUNCH_ARCH, "--mode", "msl-pp", "--ckpt-every", "3",
              "--device", dev]
    with tempfile.TemporaryDirectory() as tmp:
        def run():
            rcs = [train.main(common + ["--steps", "6", "--ckpt-dir",
                                        f"{tmp}/straight"]),
                   train.main(common + ["--steps", "4", "--ckpt-dir",
                                        f"{tmp}/resumed"]),
                   train.main(common + ["--steps", "6", "--resume",
                                        "--ckpt-dir", f"{tmp}/resumed"]),
                   serve.main(["--arch", LAUNCH_ARCH, "--device", dev])]
            return rcs

        rcs, launches, recorded = _recorded_run(mods, run)
        if rcs != [0, 0, 0, 0]:
            raise AssertionError(f"the launchers exited {rcs}")
        trees = [CheckpointManager(f"{tmp}/{d}").restore()
                 for d in ("straight", "resumed")]
    (s1, a), (s2, b) = trees
    a, b = flatten_with_path(a), flatten_with_path(b)
    same = s1 == s2 == 5 and [p for p, _ in a] == [p for p, _ in b] and all(
        x.dtype == y.dtype and torch.equal(x, y)
        for (_, x), (_, y) in zip(a, b))
    if not same:
        raise AssertionError(f"the resumed run's step-{s2} checkpoint is not "
                             f"the straight run's step-{s1} one")
    for k in ("flash_attention", "flash_attention_bwd"):
        if launches[k] == 0:
            raise AssertionError(f"the launchers launched no {k} kernel")
    print(f"launchers (path 7, {LAUNCH_ARCH} --reduced on {dev}): "
          f"train --mode msl-pp 6 steps straight == 4 steps + --resume, "
          f"every one of the {len(a)} leaves of the step-5 checkpoint; serve "
          f"exit 0; launches {launches}; in {time.perf_counter() - t0!r} s")
    return {"launches": launches, "recorded": recorded}


# ------------------------------------------------------------------ path 8 --
class CrossModel(NamedTuple):
    """Path 8's work for one cross-attention model: the forward of
    ``batch`` x ``seq`` tokens over a memory of ``cfg.memory_len`` frames or
    patches, its serving, and its training where ``train`` is given; its
    changes from the published config in ``overrides``."""
    batch: int
    seq: int
    serve: ServeTraffic
    train: TrainTraffic | None = None
    overrides: dict = {}
    check_seq: int = CHECK_SEQ  # tokens of the card-vs-CPU checks


# path 8, after path 7's launchers: whisper-small at its published size
# (memory_len 1500 frames, Whisper's max_target_positions 448 tokens) and
# llama-3.2-vision-90b at full width, 30 of its 100 layers (6 repetitions
# of attn x 4, xattn) in bf16: 0.856 B parameters a layer, 55.5 GB with its
# embedding and head; Adafactor's bf16 gradients of 30 layers would not fit
# beside them, so it does not train.  Its card-vs-CPU check runs at 32
# tokens: 10 layers of d 8192 on the host (23 s at 64 tokens on an H100's
# host).
CROSS = {
    "whisper-small": CrossModel(
        8, 448, ServeTraffic(8, 4, 64, 128, 192),
        TrainTraffic(8, 448, 4, ("flash_attention", "flash_attention_bwd"))),
    "llama-3.2-vision-90b": CrossModel(
        1, 2048, ServeTraffic(1, 4, 64, 64, 128), None,
        {"n_layers": 30, "param_dtype": "bfloat16"}, 32),
}
CROSS_XGATE = 0.5  # every xgate opened to this: it is 0 at init
CROSS_CHECK_ROWS = 2  # batch rows of the card-vs-CPU checks


def _cross_attention_calls(cfg) -> int:
    """Flash launches of one cache-free forward: each encoder layer, and
    each self- and cross-attention of the decoder."""
    from repro_torch.models import transformer as MT

    per = {"attn": 1, "local_attn": 1, "xattn": 1, "dec_block": 2}
    return cfg.enc_layers + sum(per.get(k, 0) for k in MT.layer_kinds(
        cfg.n_layers, cfg.pattern))


def _cross_layers(cfg) -> int:
    from repro_torch.models import transformer as MT

    return sum(k in MT.CROSS_KINDS
               for k in MT.layer_kinds(cfg.n_layers, cfg.pattern))


def _planned_bytes(cfg, device) -> int:
    """The parameters' bytes, counted before they are allocated: one block
    of each kind built at full width on ``device`` and freed, times its
    layers, with the embedding, the head and the norms."""
    from repro_torch.models import layers as ML
    from repro_torch.models import transformer as MT

    gen = torch.Generator(device=device).manual_seed(0)

    def nbytes(tree):
        return sum(t.numel() * t.element_size() for t in MT.tree_leaves(tree))

    kinds = collections.Counter(MT.layer_kinds(cfg.n_layers, cfg.pattern))
    if cfg.enc_layers:
        kinds.update({"attn": cfg.enc_layers})
    total = 0
    for kind, n in kinds.items():
        total += n * nbytes(MT.init_block(gen, cfg, kind))
    V, D = cfg.vocab_size, cfg.d_model
    size = torch.tensor([], dtype=ML.pdt(cfg)).element_size()
    total += size * (V * D * (1 if cfg.tie_embeddings else 2)
                     + D * (2 if cfg.enc_layers else 1))
    torch.cuda.empty_cache()
    return total


def open_gates(params, value: float = CROSS_XGATE):
    """Every ``xgate`` set to ``value``, in place: at init each is 0, and
    tanh(0) takes out every cross-attention output, so the seeded weights
    could not show a broken cross path."""
    from repro_torch.models import transformer as MT

    gates = [t for path, t in MT.tree_paths(params) if path[-1] == "xgate"]
    with torch.no_grad():
        for t in gates:
            t.fill_(value)
    return len(gates)


def _cross_sub(params, cfg, reps: int):
    """The first ``reps`` pattern repetitions of the decoder (and as many
    encoder layers), with the embedding, the norms and the head: a model of
    its own, and its config."""
    n = min(cfg.n_layers, reps * len(cfg.pattern))
    n_enc = min(cfg.enc_layers, reps)
    sub = dict(params, stack={"layers": params["stack"]["layers"][:n]})
    if cfg.enc_layers:
        sub["encoder"] = {"layers": params["encoder"]["layers"][:n_enc]}
    return sub, dataclasses.replace(cfg, n_layers=n, enc_layers=n_enc)


def _cross_check_on_cpu(name, cfg, params, tokens, memory) -> str:
    """``forward(memory=...)`` of the first SERVE_CHECK_DEPTH repetitions on
    the card (kernels) against the same on the CPU (plain versions), on
    CROSS_CHECK_ROWS rows of the batch: within CHECK_TOL of the largest
    magnitude, or within FLOOR_FACTOR of the floor where that is larger:
    the same forward through the plain versions on the card against the
    CPU, two bf16 evaluations apart (llama-vision's 10 layers of d 8192
    with bf16 weights read 0.0197 of the limit's 0.02 on an H100, PR 26's
    call 3).  Raises on a failure, else returns the reading."""
    from repro_torch.models import layers as ML
    from repro_torch.models import transformer as MT

    t0 = time.perf_counter()
    sub, sub_cfg = _cross_sub(params, cfg, SERVE_CHECK_DEPTH)
    cpu_sub = MT.tree_map(lambda t: t.cpu(), sub)
    toks, mem = tokens[:CROSS_CHECK_ROWS], memory[:CROSS_CHECK_ROWS]
    B, S = toks.shape
    pos = torch.arange(S).expand(B, S)
    ctx = ML.Ctx(mode="prefill", positions=pos.to(toks.device))
    with torch.no_grad():
        card = MT.forward(sub, sub_cfg, toks, ctx, memory=mem)[0]
        with plain_kernels():
            plain = MT.forward(sub, sub_cfg, toks, ctx, memory=mem)[0]
        cpu = MT.forward(cpu_sub, sub_cfg, toks.cpu(), ML.Ctx(
            mode="prefill", positions=pos), memory=mem.cpu())[0]
    err = _rel(card.float().cpu(), cpu.float())
    floor = _rel(plain.float().cpu(), cpu.float())
    limit = max(CHECK_TOL, FLOOR_FACTOR * floor)
    line = (f"{sub_cfg.n_layers} decoder and {sub_cfg.enc_layers} encoder "
            f"layers at B {B} x S {S} over {mem.shape[1]} memory positions, "
            f"card (kernels) vs CPU (plain versions) in {cfg.compute_dtype}: "
            f"{err!r} of the largest magnitude (the floor, the plain versions "
            f"on the card, {floor!r}; limit {FLOOR_FACTOR} x floor, at least "
            f"{CHECK_TOL}: {limit!r}), in {time.perf_counter() - t0!r} s")
    if not err < limit:
        raise AssertionError(f"{name}: path 8's forward on the card differs "
                             f"from the CPU's; {line}")
    return line


def _gates_check(name, cfg, params, tokens, memory) -> str:
    """The gates work: on the first SERVE_CHECK_DEPTH repetitions on the
    card, with every gate closed (0, as at init) the hidden state of two
    different memories (the memory and its negation: a vision memory has
    no positions, so a permutation of it is the same memory) is ``==``,
    and with the gates open at CROSS_XGATE it is not.  A cross block that
    ignored its gate, or one that ignored the memory, fails this.  Raises
    on a failure, else returns the reading."""
    from repro_torch.models import layers as ML
    from repro_torch.models import transformer as MT

    sub, sub_cfg = _cross_sub(params, cfg, SERVE_CHECK_DEPTH)
    B, S = tokens.shape
    ctx = ML.Ctx(mode="prefill", positions=torch.arange(
        S, device=tokens.device).expand(B, S))

    def two():
        with torch.no_grad():
            return [MT.forward(sub, sub_cfg, tokens, ctx, memory=m)[0]
                    for m in (memory, -memory)]

    open_gates(sub, 0.0)
    try:
        closed = two()
    finally:
        open_gates(sub)
    opened = two()
    moved = float((opened[0].float() - opened[1].float()).abs().max())
    line = (f"gates closed: the hidden states of two memories == "
            f"{torch.equal(*closed)}; open ({CROSS_XGATE}): they differ by "
            f"up to {moved!r}")
    if not torch.equal(*closed) or moved == 0.0:
        raise AssertionError(f"{name}: the cross blocks' gates do not gate "
                             f"the memory; {line}")
    return line


def _cross_grads(sub, sub_cfg, toks, mem, cot):
    """The gradient of every leaf of ``sub`` (decoder, encoder, the gates)
    for the cotangent ``cot`` of ``forward(memory=...)``'s hidden state, in
    train mode (rematerialised)."""
    from repro_torch.models import layers as ML
    from repro_torch.models import transformer as MT

    leaves = [t.detach().requires_grad_() for t in MT.tree_leaves(sub)]
    it = iter(leaves)
    tree = MT.tree_map(lambda _: next(it), sub)
    B, S = toks.shape
    pos = torch.arange(S, device=toks.device).expand(B, S)
    with torch.enable_grad():
        out, _, _ = MT.forward(tree, sub_cfg, toks, ML.Ctx(
            mode="train", positions=pos), memory=mem)
        loss = (out.float() * cot.to(out.device)).sum()
    return torch.autograd.grad(loss, leaves)


def _cross_train_check_on_cpu(name, cfg, params, tokens, memory) -> str:
    """Path 4's gradient gate for a cross-attention model: every leaf's
    gradient of the first TRAIN_CHECK_DEPTH repetitions (and as many
    encoder layers, ``enc_norm`` and the gates among them), for a fixed
    random cotangent of the hidden state, card (kernels) against CPU (plain
    versions), each within CHECK_TOL in 2-norm (a cross block's key bias,
    whose gradient is 0 but for rounding, over its value bias's norm); the
    same through the plain versions on the card printed beside (the
    floor).  Raises on a failure,
    else returns the readings."""
    from repro_torch.models import transformer as MT

    t0 = time.perf_counter()
    sub, sub_cfg = _cross_sub(params, cfg, TRAIN_CHECK_DEPTH)
    sub = {k: v for k, v in sub.items() if k != "head"}
    cpu_sub = MT.tree_map(lambda t: t.detach().cpu(), sub)
    toks, mem = tokens[:CROSS_CHECK_ROWS], memory[:CROSS_CHECK_ROWS]
    B, S = toks.shape
    cot = torch.randn((B, S, cfg.d_model),
                      generator=torch.Generator().manual_seed(5))
    cpu = [g.float() for g in _cross_grads(cpu_sub, sub_cfg, toks.cpu(),
                                           mem.cpu(), cot)]
    card = [g.float().cpu() for g in _cross_grads(sub, sub_cfg, toks, mem,
                                                  cot)]
    with plain_kernels():
        floor = [g.float().cpu() for g in _cross_grads(sub, sub_cfg, toks,
                                                       mem, cot)]
    paths = [path for path, _ in MT.tree_paths(sub)]
    names = [".".join(map(str, path)) for path in paths]
    # a cross block's key bias shifts every score of a query alike, which
    # the softmax ignores: its gradient is 0 but for rounding, so its error
    # is taken over the norm of its block's value-bias gradient
    scale = [cpu[paths.index(p[:-1] + ("bv",))] if p[-1] == "bk" and
             p[:-1] + ("xgate",) in paths else c for p, c in zip(paths, cpu)]
    errs = [_rel2(a, b, w) for a, b, w in zip(card, cpu, scale)]
    floors = [_rel2(a, b, w) for a, b, w in zip(floor, cpu, scale)]
    worst = max(range(len(errs)), key=errs.__getitem__)
    gates = [n for n in names if n.endswith("xgate")]
    enc = [e for n, e in zip(names, errs) if n.startswith("encoder")]
    line = (f"{sub_cfg.n_layers} decoder and {sub_cfg.enc_layers} encoder "
            f"layers at B {B} x S {S}, card (kernels) vs CPU (plain "
            f"versions): the {len(errs)} parameter gradients up to "
            f"{errs[worst]!r} ({names[worst]}) in 2-norm (limit {CHECK_TOL}; "
            f"the plain versions on the card up to {max(floors)!r}); the "
            f"encoder's up to {max(enc, default=0.0)!r}, the gates' "
            f"({len(gates)}) up to "
            f"{max(e for n, e in zip(names, errs) if n in gates)!r}; in "
            f"{time.perf_counter() - t0!r} s")
    if not errs[worst] < CHECK_TOL:
        raise AssertionError(f"{name}: path 8's gradients on the card differ "
                             f"from the CPU's past the limit; {line}; every "
                             f"leaf: {dict(zip(names, errs))}")
    if not all(float(g.abs().max()) > 0 for n, g in zip(names, card)
               if n.startswith("encoder") or n in gates):
        raise AssertionError(f"{name}: an encoder or gate gradient is 0 with "
                             f"the gates open")
    return line


def _cross_cache_check(name, cfg, params, memory) -> str:
    """A decode step reuses the cross K/V its prefill projected: after a
    prefill of 4 tokens, the same decode step with the cache's
    ``enc_memory`` as it is and with it zeroed gives ``==`` logits (the
    step writes the same self-attention slots both times).  A decode that
    projected the memory again at every step fails this.  Raises on a
    failure, else returns the reading."""
    from repro_torch import serving as SV

    B = memory.shape[0]
    toks = torch.randint(1, cfg.vocab_size, (B, 4),
                         generator=torch.Generator().manual_seed(7)).to(
        memory.device)
    _, cache = SV.prefill(params, cfg, toks, 8, memory=memory)
    pos = torch.full((B, 1), 4, device=memory.device)
    first, _ = SV.decode_step(params, cfg, dict(cache), toks[:, :1], pos)
    blank = dict(cache, enc_memory=torch.zeros_like(cache["enc_memory"]))
    second, _ = SV.decode_step(params, cfg, blank, toks[:, :1], pos)
    if not torch.equal(first, second):
        raise AssertionError(f"{name}: a decode step read the memory instead "
                             f"of the cross K/V its prefill projected")
    return ("a decode step with the cache's enc_memory zeroed == with it: "
            "the cross K/V come from the prefill")


def run_cross_train(name, cfg, params, traffic: TrainTraffic, mods: dict,
                    device, memory_len: int) -> dict:
    """Path 8's training: the gradient gate (``_cross_train_check_on_cpu``)
    on the seeded weights, then ``traffic.steps`` AdamW steps of
    ``make_train_step`` at TRAIN_LR on ``SyntheticLM`` batches with memory,
    ``batch_at(i % 2)``, counted (two forward launches an attention under
    remat, the encoder's too, and one backward): every loss and grad norm
    finite, the loss on ``batch_at(0)`` lower at step 3 than at step 1, the
    step's p50, tokens/s and peak memory printed."""
    from repro_torch.data import BatchSpec, SyntheticLM, shard_batch
    from repro_torch.optim import make_optimizer
    from repro_torch.train import make_train_step

    B, S = traffic.batch, traffic.seq
    fwd, bwd = traffic.kernels
    stream = SyntheticLM(BatchSpec(B, S, cfg.vocab_size, memory_len,
                                   cfg.d_model), seed=0)
    batches = [shard_batch(stream.batch_at(i), device) for i in range(2)]
    print(f"{name}: path 8 "
          f"{_cross_train_check_on_cpu(name, cfg, params, batches[0]['tokens'], batches[0]['memory'])}")
    opt = make_optimizer(cfg.optimizer, lr=TRAIN_LR, warmup=1, total=50)
    state = opt.init(params, cfg)
    step = make_train_step(cfg, opt)
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
    calls = _cross_attention_calls(cfg)
    want = (traffic.steps * 2 * calls if cfg.remat else
            traffic.steps * calls, traffic.steps * calls)
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
    print(f"{name}: path 8 training on {_card_line()}: {traffic.steps} "
          f"steps ({cfg.optimizer}, lr {TRAIN_LR}, remat {cfg.remat}) at B "
          f"{B} x S {S} over {memory_len} memory positions: losses {losses}, "
          f"grad norms {norms}; step ms {step_ms}, p50 over steps "
          f"2-{traffic.steps} {p50!r} ms = {B * S / (p50 * 1e-3)!r} "
          f"tokens/s; peak device memory {peak} B; launches {launches}")
    del state, opt, step, batches
    torch.cuda.empty_cache()
    return {"launches": launches, "recorded": recorded, "losses": losses,
            "step_ms_p50": p50, "tokens_per_s": B * S / (p50 * 1e-3),
            "peak_bytes": peak}


def run_cross_path(name: str, mods: dict, device) -> dict:
    """Path 8 for one cross-attention model (CROSS), after path 7:

    1. its parameters counted before they are allocated (they must fit the
       card's free memory), then drawn from seed 0, every gate opened to
       CROSS_XGATE;
    2. ``forward(memory=...)`` of the batch, the counts set to 0 just before
       and read just after: one flash launch an encoder layer and a self-
       and cross-attention (``_cross_attention_calls``); the hidden state
       finite; the first SERVE_CHECK_DEPTH repetitions within CHECK_TOL of
       the CPU (``_cross_check_on_cpu``); one more forward under the
       profiler (busy time and the top kernels);
    3. serving (``run_serve_path`` with the memory): ``prefill(memory=...)``
       and greedy ``decode_step``s over the cross K/V the prefill
       projected, teacher-forced against the cache-free forward over the
       memory, at full depth within FLOOR_FACTOR of the floor; each decode
       step one flash launch a cross block (the cached K/V);
    4. training where the model has it (``run_cross_train``).

    Returns each part's counts and recorded kernel calls, and the
    numbers."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import layers as ML
    from repro_torch.models import transformer as MT

    spec = CROSS[name]
    cfg = dataclasses.replace(ARCHS[name], **spec.overrides)
    B, S = spec.batch, spec.seq
    t_path = time.perf_counter()
    planned = _planned_bytes(cfg, device)
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"{name}: {cfg.n_layers} decoder and {cfg.enc_layers} encoder "
          f"layers, d_model {cfg.d_model}, {planned} B of parameters "
          f"({cfg.param_dtype}; changed from the published config: "
          f"{spec.overrides or 'nothing'}) planned against {free} B free of "
          f"{total} B ({torch.cuda.memory_allocated()} B allocated)")
    if planned > 0.9 * free:
        raise AssertionError(f"{name}: {planned} B of parameters would not "
                             f"fit beside the work in {free} B free")
    torch.cuda.reset_peak_memory_stats()
    params = MT.init_params(torch.Generator(device=device).manual_seed(0),
                            cfg, device=device)
    n_bytes = sum(t.numel() * t.element_size()
                  for t in MT.tree_leaves(params))
    if n_bytes != planned:
        raise AssertionError(f"{name}: {n_bytes} B allocated, {planned} B "
                             f"planned")
    n_gates = open_gates(params)
    tokens = torch.randint(0, cfg.vocab_size, (B, S),
                           generator=torch.Generator().manual_seed(1)
                           ).to(device)
    memory = torch.randn((B, cfg.memory_len, cfg.d_model),
                         generator=torch.Generator().manual_seed(6)
                         ).to(device)
    pos = torch.arange(S, device=device).expand(B, S)
    ctx = ML.Ctx(mode="prefill", positions=pos)
    torch.cuda.synchronize()
    print(f"{name}: {sum(t.numel() for t in MT.tree_leaves(params))} "
          f"parameters on the card in {time.perf_counter() - t_path!r} s, "
          f"{n_gates} gates opened to {CROSS_XGATE}; tokens B {B} x S {S}, "
          f"memory B {B} x {cfg.memory_len} x {cfg.d_model}")

    def forward():
        with torch.no_grad():
            return MT.forward(params, cfg, tokens, ctx, memory=memory)[0]

    t1 = time.perf_counter()
    hidden, launches, recorded = _recorded_run(mods, forward)
    t_fwd = time.perf_counter() - t1
    calls = _cross_attention_calls(cfg)
    if launches["flash_attention"] != calls:
        raise AssertionError(f"{name}: the forward launched "
                             f"{launches['flash_attention']} flash kernels, "
                             f"not {calls}")
    if hidden.shape != (B, S, cfg.d_model) or not torch.isfinite(
            hidden).all():
        raise AssertionError(f"{name}: hidden state {tuple(hidden.shape)} "
                             f"is not finite of shape {(B, S, cfg.d_model)}")
    del hidden
    wall, busy, by_name = _device_us(forward)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    print(f"{name}: path 8 forward in {t_fwd!r} s (the first), launches "
          f"{launches}; warm under the profiler: wall {wall!r} us, device "
          f"busy {busy!r} us (share {busy / wall!r}); top device time: {top}; "
          f"peak device memory {torch.cuda.max_memory_allocated()} B")
    check = tokens[:CROSS_CHECK_ROWS, :spec.check_seq]
    print(f"{name}: path 8 "
          f"{_cross_check_on_cpu(name, cfg, params, check, memory)}; "
          f"{_gates_check(name, cfg, params, check, memory[:len(check)])}")
    serve = run_serve_path(name, cfg, params, spec.serve, ("flash_attention",),
                           mods, device, memory[:spec.serve.batch])
    steps = spec.serve.max_new - 1
    want = calls + steps * _cross_layers(cfg)
    if serve["launches"]["flash_attention"] != want:
        raise AssertionError(f"{name}: path 8's serving launched "
                             f"{serve['launches']['flash_attention']} flash "
                             f"kernels, not {want} (the prefill {calls}, "
                             f"then one a cross block and step)")
    print(f"{name}: path 8 {_cross_cache_check(name, cfg, params, memory)}")
    train = None
    if spec.train is not None:
        train = run_cross_train(name, cfg, params, spec.train, mods, device,
                                cfg.memory_len)
    del params, memory, tokens
    torch.cuda.empty_cache()
    print(f"{name}: path 8 in {time.perf_counter() - t_path!r} s")
    return {"forward": {"launches": launches, "recorded": recorded,
                        "busy_us": busy, "wall_us": wall},
            "serve": serve, "train": train}


def _work_bound(work, ops_per_s, passes: int = 1
                ) -> tuple[float, str, int, int]:
    n_ops, n_bytes = work
    op_ms = passes * n_ops / ops_per_s * 1e3
    byte_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    return (max(op_ms, byte_ms), "operations" if op_ms >= byte_ms else
            "bytes", n_ops, n_bytes)


def _flash_bound(key) -> tuple[float, str, int, int]:
    """``kernel_work.flash_work``: q.k and p.v over the visible pairs."""
    return _work_bound(_kernel_work().flash_work(key), BF16_OPS_PER_S)


def _ssd_work(key) -> tuple[int, int]:
    """The least work, (operations, bytes), ``kernel_work.ssd_work``."""
    return _kernel_work().ssd_work(key)


def _ssd_bound(key) -> tuple[float, str, int, int]:
    """The least work done as the kernel computes it: SSD_TF32_PASSES TF32
    products on the tensor cores for each fp32 product."""
    return _work_bound(_ssd_work(key), TF32_OPS_PER_S, SSD_TF32_PASSES)


def _ssd_fp32_bound(key) -> tuple[float, str]:
    """The same work at the fp32 rate outside the tensor cores: not a bound
    of this kernel (it can beat it), the yardstick of a kernel on fp32
    FMAs, printed beside the bound."""
    return _work_bound(_ssd_work(key), FP32_OPS_PER_S)[:2]


def _gmm_bound(key) -> tuple[float, str, int, int]:
    """Every row of the buffers, filled or not, as the function computes
    them (``kernel_work.gmm_work``)."""
    return _work_bound(_kernel_work().gmm_work(key), BF16_OPS_PER_S)


def _rglru_bound(key) -> tuple[float, str, int, int]:
    """a and b read and h written once; a multiply-add per element."""
    return _work_bound(_kernel_work().rglru_work(key), FP32_OPS_PER_S)


def _gmm_bwd_bound(key) -> tuple[float, str, int, int]:
    """The backward's least work from its inputs
    (``kernel_work.gmm_bwd_work``)."""
    return _work_bound(_kernel_work().gmm_bwd_work(key), BF16_OPS_PER_S)


def _rglru_bwd_bound(key) -> tuple[float, str, int, int]:
    """a, h and g read and da and db written once."""
    return _work_bound(_kernel_work().rglru_bwd_work(key), FP32_OPS_PER_S)


def _flash_bwd_bound(key) -> tuple[float, str, int, int]:
    """Five products over the visible pairs (``kernel_work.flash_bwd_work``)."""
    return _work_bound(_kernel_work().flash_bwd_work(key), BF16_OPS_PER_S)


def _ssd_bwd_work(key) -> tuple[int, int]:
    """The least work of the backward, ``kernel_work.ssd_bwd_work``."""
    return _kernel_work().ssd_bwd_work(key)


def _ssd_bwd_bound(key) -> tuple[float, str, int, int]:
    """The least work at the forward's rate: SSD_TF32_PASSES TF32 products
    on the tensor cores for each fp32 product (fp32 accuracy)."""
    return _work_bound(_ssd_bwd_work(key), TF32_OPS_PER_S, SSD_TF32_PASSES)


def _ssd_bwd_fp32_bound(key) -> tuple[float, str]:
    """The same work at the fp32 rate outside the tensor cores, the rate
    the first, plain SIMT version computed at: printed beside the bound."""
    return _work_bound(_ssd_bwd_work(key), FP32_OPS_PER_S)[:2]


def _flash_path_check(fa, recorded, random) -> tuple[float, None]:
    err = _flash_check(fa, recorded + random, "at path 2's shapes (recorded "
                       "operands and random)")
    _flash_rejects_wrong_outputs(fa, *next(
        case for case in recorded if case[1].get("causal", True)
        and not case[1].get("window") and not case[1].get("softcap")))
    return err, None


def _gmm_path_check(gmm, recorded, random) -> tuple[float, None]:
    err = _gmm_check(gmm, recorded + random, "at path 2's shapes (recorded "
                     "operands and random)")
    _gmm_rejects_wrong_outputs(gmm, *recorded[0])
    return err, None


def _rglru_path_check(rglru, recorded, random) -> tuple[float, None]:
    err = _rglru_check_witness(rglru, [args for args, _ in recorded],
                               "recorded at path 2's shapes")
    _rglru_rejects_wrong_outputs(rglru, recorded[0][0])
    return max(err, _rglru_check(rglru, [args for args, _ in random],
                                 "random at path 2's shapes")), None


def _ssd_path_check(ssd, recorded, random) -> tuple[float, None]:
    err = _ssd_check_witness(ssd, [args for args, _ in recorded],
                             "recorded at path 2's shapes")
    _ssd_rejects_wrong_outputs(ssd, recorded[0][0])
    return max(err, _ssd_check(ssd, [args for args, _ in random],
                               "random at path 2's shapes")), None


def _flash_bwd_path_check(fa, recorded, random) -> tuple[float, None]:
    err = max(_flash_bwd_check(fa, recorded, "recorded at path 4's shapes",
                               witness=True),
              _flash_bwd_check(fa, random, "random at path 4's shapes"))
    _flash_bwd_rejects_wrong_outputs(fa, *next(
        case for case in recorded if case[1].get("causal", True)
        and case[0][0].shape[2] > case[0][1].shape[2]))
    return err, None


def _ssd_bwd_path_check(ssd, recorded, random) -> tuple[float, dict]:
    readings: list = []
    err = max(_ssd_bwd_check(ssd, [args for args, _ in recorded],
                             "recorded at path 4's shapes", witness=True,
                             readings=readings),
              _ssd_bwd_check(ssd, [args for args, _ in random],
                             "random at path 4's shapes"))
    _ssd_bwd_rejects_wrong_outputs(ssd, recorded[0][0])
    return err, _witness_summary(readings)


def _gmm_bwd_path_check(gmm, recorded, random) -> tuple[float, dict]:
    _gmm_keep_z_check(gmm, recorded + random)
    readings: list = []
    err = max(_gmm_bwd_check(gmm, recorded, "recorded at path 4's shapes",
                             witness=True, readings=readings),
              _gmm_bwd_check(gmm, random, "random at path 4's shapes"))
    _gmm_bwd_rejects_wrong_outputs(gmm, *next(
        case for case in recorded
        if case[1].get("activation", "none") != "none"))
    return err, _witness_summary(readings)


def _rglru_bwd_path_check(rglru, recorded, random) -> tuple[float, dict]:
    readings: list = []
    err = max(_rglru_bwd_check(rglru, [args for args, _ in recorded],
                               "recorded at path 4's shapes", witness=True,
                               readings=readings),
              _rglru_bwd_check(rglru, [args for args, _ in random],
                               "random at path 4's shapes"))
    _rglru_bwd_rejects_wrong_outputs(rglru, recorded[0][0])
    return err, _witness_summary(readings)


def _rglru_same_bytes(args, kw):
    """``torch.add(a, b, out=h)``: a and b read and h written once, the
    RG-LRU scan's 12 bytes an element without its recurrence."""
    a, b = args
    h = torch.empty_like(a)
    return lambda: torch.add(a, b, out=h)


def _flash_library(args, kw):
    """One ``scaled_dot_product_attention`` call on the same operands, the
    library yardstick (never called by the port): causal or not (the
    cross-attention's), or with the causal window as a boolean mask; None
    where the options have no such call (a softcap, or a window without the
    causal mask)."""
    causal, window = kw.get("causal", True), kw.get("window")
    if kw.get("softcap") or (window is not None and not causal):
        return None
    qt, kt, vt = (t.transpose(1, 2) for t in args)
    if window is None:
        return lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, is_causal=causal, enable_gqa=True).transpose(1, 2)
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


def _gmm_bwd_library(args, kw):
    """Two ``torch.bmm`` calls, dZ W^T and X^T dZ, on the plain version's
    dZ (computed once beforehand, in bf16), the library yardstick of the
    backward (never called by the port)."""
    x, w, dy = args
    dz = _gmm_dz(x, w, dy, kw.get("activation", "none")).to(x.dtype)
    wt, xt = w.transpose(1, 2), x.transpose(1, 2)
    return lambda: (torch.bmm(dz, wt), torch.bmm(xt, dz))  # noqa: E731


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
    # (module, recorded, random) -> (max err, the float64 witness by
    # gradient of a backward kernel held to it, else None)
    check: Callable | None = None
    bound: Callable | None = None  # key -> (ms, by, operations, bytes)
    library: Callable = lambda args, kw: None  # noqa: E731
    # (args, kw) -> a call that moves the kernel's bytes without its work,
    # timed beside it (``same_bytes_ms``): what the card reaches on them
    same_bytes: Callable = lambda args, kw: None  # noqa: E731
    # key -> (ms, by) of the same work at the fp32 rate, or None
    fp32_bound: Callable = lambda key: None  # noqa: E731
    module: str = ""  # module of repro_torch.kernels, if not the kernel's name
    counter: str = "launch_count"  # the module's count of this kernel
    # whether the wrapper is also timed with its first operand requiring
    # grad, as the forward under grad launches the kernel (``grad_ms``)
    grad_timed: bool = False


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
        _gmm_path_check, _gmm_bound, _gmm_library, grad_timed=True),
    "rglru": Kernel(
        "src/repro_torch/kernels/csrc/rglru.cu",
        "src/repro/kernels/rglru.py:23",
        ("repro_torch.models.layers", "rglru_scan"), _rglru_key,
        "rglru_scan_kernel", "rglru_scan", "reference_rglru_scan",
        lambda gen, s, kw, device: (_rglru_operands(gen, s, device), kw),
        _rglru_path_check, _rglru_bound, same_bytes=_rglru_same_bytes),
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
    "moe_gmm_bwd": Kernel(
        "src/repro_torch/kernels/csrc/moe_gmm_bwd.cu",
        "src/repro/kernels/moe_gmm.py:22",
        ("repro_torch.kernels.moe_gmm", "expert_matmul_bwd"), _gmm_bwd_key,
        "gmm_bwd_", "expert_matmul_bwd", "reference_expert_matmul_bwd",
        lambda gen, s, kw, device: _gmm_bwd_operands(gen, s, device),
        _gmm_bwd_path_check, _gmm_bwd_bound, _gmm_bwd_library,
        module="moe_gmm", counter="bwd_launch_count"),
    "rglru_bwd": Kernel(
        "src/repro_torch/kernels/csrc/rglru_bwd.cu",
        "src/repro/kernels/rglru.py:23",
        ("repro_torch.kernels.rglru", "rglru_scan_bwd"), _rglru_bwd_key,
        "rglru_bwd_", "rglru_scan_bwd", "reference_rglru_scan_bwd",
        lambda gen, s, kw, device: (_rglru_bwd_operands(gen, s, device), kw),
        _rglru_bwd_path_check, _rglru_bwd_bound,
        module="rglru", counter="bwd_launch_count"),
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
    err, witness = spec.check(
        mod, [case for s in order for case in operands[s]],
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
        grad_ms = None
        if spec.grad_timed:
            leaf = args[0].detach().requires_grad_()

            def under_grad():
                with torch.enable_grad():
                    return wrapper(leaf, *args[1:], **kw)

            grad_ms = _kernel_device_ms(under_grad, 20, spec.profiled)
            print(f"{name} {s}: device time per launch as the forward under "
                  f"grad launches it (the first operand requiring grad) "
                  f"{grad_ms!r} ms")
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
        same_bytes = spec.same_bytes(args, kw)
        same_ms = None
        if same_bytes is not None:
            same_ms = _kernel_device_ms(same_bytes, 20, None)
            print(f"{name} {s}: the same bytes without the work "
                  f"{same_ms!r} ms: {bound / same_ms!r} of the bound")
        rate, share = n_ops / (ms * 1e-3), bound / ms
        byte_rate = n_bytes / (ms * 1e-3)
        rows[s] = {"shape": list(s), "launches": shapes[s], "ms": ms,
                   "plain_ms": plain_ms, "held_ms": held_ms,
                   "bound_ms": bound, "bound_by": by,
                   "library_ms": library_ms, "ops_per_s": rate,
                   "bytes_per_s": byte_rate, "bound_share": share,
                   **({"grad_ms": grad_ms} if grad_ms is not None else {}),
                   **({"same_bytes_ms": same_ms} if same_ms is not None
                      else {})}
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
            **({"witness_float64": witness} if witness else {}),
            "shapes": [rows[s] for s in order]}


def _merge(recorded: list) -> tuple:
    """One kernel's recorded calls of several models, as one record."""
    shapes: collections.Counter = collections.Counter()
    operands: dict = {}
    for s, ops in recorded:
        shapes.update(s)
        operands.update(ops)
    return shapes, operands


def _operands_to(recorded, device) -> tuple:
    """One kernel's recorded calls (``(shapes, operands)``, as
    ``record_calls`` yields them) with their operands moved to ``device``,
    in place; returns the record."""
    _, operands = recorded

    def to(a):
        return a.to(device) if torch.is_tensor(a) else a

    for key, calls in operands.items():
        operands[key] = [(tuple(map(to, args)),
                          {k: to(v) for k, v in kw.items()})
                         for args, kw in calls]
    return recorded


def park(run, device="cpu") -> None:
    """Every recorded kernel call in a path's result (nested dicts) with its
    operands moved to ``device``, in place: between the paths the host
    keeps them, so that the card holds none (the recorded expert-matmul
    operands alone take about 10 GB, and path 8's llama-vision needs 55.5
    GB of the card's 80)."""
    if not isinstance(run, dict):
        return
    for key, value in run.items():
        if key != "recorded":
            park(value, device)
        elif isinstance(value, dict):
            for rec in value.values():
                _operands_to(rec, device)
        else:
            _operands_to(value, device)


def storage_bytes(tree) -> int:
    """The bytes of the storages of every tensor in ``tree`` (dicts, lists
    and tuples of them), each storage once: what the arguments of a step
    hold on their device."""
    seen = {}

    def walk(x):
        if isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
        elif isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            seen[(x.device, st.data_ptr())] = st.nbytes()

    walk(tree)
    return sum(seen.values())


# Path 9: the dry run of the production H100 meshes (launch/dryrun.py), two
# full-width cells of the single mesh (32 x 8 cards), each run in a
# subprocess of its own as the CLI runs it
DRYRUN_CELLS = (("qwen2-1.5b", "train_4k", "single"),
                ("qwen3-moe-30b-a3b", "decode_32k", "single"))
# the per-device FLOPs of a cell against its share of the model's, model
# FLOPs / cards (the reference's useful_flops_ratio), within these bounds:
# a train step recomputes its forward (remat, about 0.7); a decode step's
# attention over the cache is no model FLOP (0.16 at decode_32k); a count
# of the whole mesh's FLOPs as one card's reads 1/256 of either, one that
# misses work over 1
DRYRUN_BAND = {"train": (0.5, 1.0), "decode": (0.05, 1.0)}
# path 9's one-card cells: the dry run of paths 4's and 3's steps on a
# one-rank mesh, held to the card's arguments and p50
ONE_CARD = {"qwen2-1.5b": "train", "qwen3-moe-30b-a3b": "decode"}
# a one-card cell counts at least 1 / ONE_CARD_SLACK of its model FLOPs (a
# decode step's embedding lookup is model FLOPs that no product computes)
ONE_CARD_SLACK = 2.0
SHAPES_KIND = {"train_4k": "train", "prefill_32k": "prefill",
               "decode_32k": "decode", "long_500k": "decode"}
DRYRUN_TIMEOUT_S = 600

DRYRUN_SNIPPET = r"""
import dataclasses, json, math, sys
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import make_mesh, start_fake_group
spec = json.loads(sys.argv[1])
if isinstance(spec["mesh"], str):
    out = run_cell(spec["arch"], spec["shape"], spec["mesh"])
else:
    dims = tuple(spec["mesh"])
    start_fake_group(math.prod(dims))
    mesh = make_mesh(dims, ("data", "model")[-len(dims):] if len(dims) < 3
                     else ("pod", "data", "model"))
    cfg = get_config(spec["arch"])
    if spec.get("reduced") is not None:
        cfg = cfg.reduced(**spec["reduced"])
    cfg = dataclasses.replace(cfg, **spec.get("overrides", {}))
    out = run_cell(cfg, ShapeConfig(*spec["shape"]), mesh)
print(json.dumps(out))
"""


class DryRuns(NamedTuple):
    """Dry runs started in subprocesses of their own (``start_dryruns``)."""
    specs: list
    procs: list
    t0: float

    def stop(self) -> None:
        """Kills those still running (a failure elsewhere ends them)."""
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def start_dryruns(specs: list) -> DryRuns:
    """Each of ``specs`` started in a subprocess of its own, all together
    (the fake process group is process-global; none touches the card):
    {"arch", "shape", "mesh"} names a production cell, as ``python -m
    repro_torch.launch.dryrun --cell`` runs it; a mesh of dims, a
    ``shape`` (name, seq_len, global_batch, kind) and ``overrides`` (and
    ``reduced``, ``ModelConfig.reduced``'s arguments) run the config so
    changed."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    t0 = time.perf_counter()
    return DryRuns(specs, [subprocess.Popen(
        [sys.executable, "-c", DRYRUN_SNIPPET, json.dumps(spec)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=str(ROOT)) for spec in specs], t0)


def dryrun_cells(runs: DryRuns) -> list:
    """Each started dry run's artifact; one that fails, or outlasts
    DRYRUN_TIMEOUT_S, raises (and ends the others)."""
    out = []
    try:
        for spec, proc in zip(runs.specs, runs.procs):
            try:
                stdout, stderr = proc.communicate(timeout=DRYRUN_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                raise AssertionError(f"path 9: the dry run of {spec} took "
                                     f"more than {DRYRUN_TIMEOUT_S} s")
            if proc.returncode != 0:
                raise AssertionError(f"path 9: the dry run of {spec} failed:"
                                     f" {stderr[-3000:]}")
            out.append(json.loads(stdout.strip().splitlines()[-1]))
    finally:
        runs.stop()
    return out


def _flops_ratio(art) -> float:
    """The cell's model FLOPs over the FLOPs its cards run, from its
    counts (the reference's useful_flops_ratio)."""
    total = art["cost"]["flops_per_device"] * art["devices"]
    return art["roofline"]["model_flops_global"] / total if total else 0.0


def _dryrun_gate(art, kind: str) -> str:
    """A production cell: ``ok``, FLOPs, bytes and collective bytes above
    0, and its useful_flops_ratio within DRYRUN_BAND[kind]."""
    name = f"{art['arch']} {art['shape']} {art['mesh']}"
    if art.get("status") != "ok":
        raise AssertionError(f"path 9: {name}: status {art.get('status')}: "
                             f"{art.get('stderr', art.get('reason'))}")
    cost, coll = art["cost"], art["collectives"]
    if not (cost["flops_per_device"] > 0 and cost["hbm_bytes_per_device"] > 0
            and coll["total_bytes_per_device"] > 0):
        raise AssertionError(f"path 9: {name}: FLOPs, bytes and collective "
                             f"bytes must be above 0: {cost}, {coll}")
    lo, hi = DRYRUN_BAND[kind]
    ratio = _flops_ratio(art)
    if not lo <= ratio <= hi:
        raise AssertionError(f"path 9: {name}: the per-device FLOPs are "
                             f"{ratio!r} of the model's share (band "
                             f"{DRYRUN_BAND[kind]})")
    rf = art["roofline"]
    return (f"{name}: ok on {art['devices']} cards ({art['strategy']}); "
            f"per device {cost['flops_per_device']!r} FLOP, "
            f"{cost['hbm_bytes_per_device']!r} B of HBM, "
            f"{coll['total_bytes_per_device']!r} B of collectives "
            f"({coll['net_bytes_per_device']!r} across nodes); t_compute "
            f"{rf['t_compute']!r} s, t_memory {rf['t_memory']!r} s, "
            f"t_collective {rf['t_collective']!r} s, bottleneck "
            f"{rf['bottleneck']}; useful FLOPs {ratio!r} (band {lo}-{hi}); "
            f"peak {art['memory']['per_device_bytes']} B a card, fits "
            f"{art['memory']['fits_80gb']}")


def _one_card_gate(name: str, art, arg_bytes: int, p50_ms: float) -> dict:
    """A one-card cell against the card: its argument bytes ``==`` the
    storages of the card's arguments, its compute term at least the
    model's FLOPs at the card's peak over ONE_CARD_SLACK (BF16_OPS_PER_S:
    a count at a peak 10 times too high fails), and the card's p50 at least its bound, the larger of its
    compute and memory terms (a count the card beats is a wrong count)."""
    rf, mem = art["roofline"], art["memory"]
    if art.get("status") != "ok":
        raise AssertionError(f"path 9: {name}: status {art.get('status')}")
    if mem["argument_bytes"] != arg_bytes:
        raise AssertionError(f"path 9: {name}: the dry run's arguments hold "
                             f"{mem['argument_bytes']} B, the card's "
                             f"{arg_bytes} B")
    t_compute = art["cost"]["flops_per_device"] / rf["peak_flops"]
    t_memory = art["cost"]["hbm_bytes_per_device"] / rf["hbm_bw"]
    least = rf["model_flops_global"] / (rf["chips"] * BF16_OPS_PER_S)
    if t_compute < least / ONE_CARD_SLACK:
        raise AssertionError(f"path 9: {name}: the compute term {t_compute!r}"
                             f" s is below 1/{ONE_CARD_SLACK} of the model's "
                             f"FLOPs at the card's peak, {least!r} s")
    bound_ms = max(t_compute, t_memory) * 1e3
    if not p50_ms >= bound_ms:
        raise AssertionError(f"path 9: {name}: the card's p50 {p50_ms!r} ms "
                             f"beats the dry run's bound {bound_ms!r} ms")
    return {"bound_ms": bound_ms, "t_compute": t_compute,
            "t_memory": t_memory}


def dryrun_specs() -> tuple[list, dict, dict]:
    """Path 9's cells: DRYRUN_CELLS, and the one-card cells of ONE_CARD,
    path 4's train step of qwen2-1.5b and path 3's decode step of
    qwen3-moe-30b-a3b, each on a one-rank mesh with its path's config
    changes."""
    moe, qwen2 = SERVE["qwen3-moe-30b-a3b"], TRAIN["qwen2-1.5b"]
    train = {"arch": "qwen2-1.5b", "mesh": [1, 1],
             "shape": ["path4_train", qwen2.seq, qwen2.batch, "train"],
             "overrides": MODELS["qwen2-1.5b"].overrides}
    decode = {"arch": "qwen3-moe-30b-a3b", "mesh": [1, 1],
              "shape": ["path3_decode", moe.cache_len, moe.batch, "decode"],
              "overrides": MODELS["qwen3-moe-30b-a3b"].overrides}
    return ([{"arch": a, "shape": s, "mesh": m} for a, s, m in DRYRUN_CELLS],
            train, decode)


def start_dryrun_path() -> DryRuns:
    """Path 9's dry runs started: ``dryrun_specs``' cells in order."""
    cells, train_spec, decode_spec = dryrun_specs()
    return start_dryruns(cells + [train_spec, decode_spec])


def run_dryrun_path(by_model: dict, card: str,
                    runs: DryRuns | None = None) -> dict:
    """Path 9: ``dryrun_specs``' production cells (gated by
    ``_dryrun_gate``), and its one-card cells beside what paths 4 and 3
    measured on the card (gated by ``_one_card_gate``), all the dry runs in
    subprocesses started together: ``runs`` (``start_dryrun_path``'s,
    started while the card runs path 8), or started here."""
    t0 = time.perf_counter()
    train = by_model["qwen2-1.5b"]["train"]
    serve = by_model["qwen3-moe-30b-a3b"]["serve"]
    cells, train_spec, decode_spec = dryrun_specs()
    runs = runs or start_dryrun_path()
    arts = dryrun_cells(runs)
    dry_s = time.perf_counter() - runs.t0
    for art, spec in zip(arts, cells):
        kind = (SHAPES_KIND[spec["shape"]] if isinstance(spec["shape"], str)
                else spec["shape"][3])
        print(f"path 9: {_dryrun_gate(art, kind)}")
    tr, de = arts[len(cells):]
    g_tr = _one_card_gate("qwen2-1.5b train step", tr, train["arg_bytes"],
                          train["step_ms_p50"])
    g_de = _one_card_gate("qwen3-moe-30b-a3b decode step", de,
                          serve["decode_arg_bytes"], serve["decode_ms_p50"])
    share = tr["roofline"]["model_flops_global"] / (
        train["step_ms_p50"] * 1e-3 * BF16_OPS_PER_S)
    print(f"path 9 on {card}: qwen2-1.5b's path 4 step (B x S "
          f"{train_spec['shape'][2]} x {train_spec['shape'][1]}, AdamW) "
          f"dry-run on one rank: arguments {tr['memory']['argument_bytes']} B == the card's;"
          f" bound {g_tr['bound_ms']!r} ms (t_compute {g_tr['t_compute']!r}"
          f" s, t_memory {g_tr['t_memory']!r} s) <= p50 "
          f"{train['step_ms_p50']!r} ms; the step's share of the peak, model "
          f"FLOPs / (p50 x peak), {share!r}; dry-run peak "
          f"{tr['memory']['per_device_bytes']} B beside "
          f"max_memory_allocated {train['peak_bytes']} B")
    hbm_share = de["cost"]["hbm_bytes_per_device"] / (
        serve["decode_ms_p50"] * 1e-3 * HBM_BYTES_PER_S)
    print(f"path 9 on {card}: qwen3-moe-30b-a3b's path 3 decode step (B "
          f"{decode_spec['shape'][2]}, cache {decode_spec['shape'][1]}) "
          f"dry-run on one rank: arguments {de['memory']['argument_bytes']} B == the "
          f"card's; bound {g_de['bound_ms']!r} ms (t_compute "
          f"{g_de['t_compute']!r} s, t_memory {g_de['t_memory']!r} s) <= "
          f"p50 {serve['decode_ms_p50']!r} ms; counted bytes "
          f"{de['cost']['hbm_bytes_per_device']!r} / (p50 x HBM) = "
          f"{hbm_share!r}, beside the hand count of the weights, head and "
          f"cache, {serve['decode_bytes']} B; dry-run peak "
          f"{de['memory']['per_device_bytes']} B beside "
          f"max_memory_allocated {serve['peak_bytes']} B")
    seconds = time.perf_counter() - t0
    print(f"path 9 in {seconds!r} s after path 8; its dry runs took "
          f"{dry_s!r} s from their start")
    return {"cells": arts[:len(cells)], "train": tr, "decode": de,
            "seconds": seconds}


# The lint phase: the port's repro-lint over its own tree, in a subprocess
# started with the smoke (on the host, beside the card paths)
LINT_ARGS = ("-m", "repro_torch.analysis", "--strict", "src/repro_torch")
LINT_TIMEOUT_S = 300
LINT_SUMMARY = re.compile(r"repro-lint: (\d+) finding\(s\) in "
                          r"(\d+) file\(s\)(?:, (\d+) baseline-suppressed)?")


class Lint(NamedTuple):
    """The lint started by ``start_lint``: its process, and what a thread
    waiting on it keeps (its output, and the clock when it ended)."""
    proc: subprocess.Popen
    t0: float
    done: dict
    waiter: threading.Thread

    def stop(self) -> None:
        """Kills it if it still runs (a failure elsewhere ends it)."""
        if self.proc.poll() is None:
            self.proc.kill()
        self.waiter.join()


def start_lint(root: Path = ROOT) -> Lint:
    """``python -m repro_torch.analysis --strict src/repro_torch`` started
    in a subprocess from ``root`` (``PYTHONPATH`` its ``src``)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(root / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, *LINT_ARGS],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=str(root))
    done = {}

    def wait():
        done["stdout"], done["stderr"] = proc.communicate()
        done["t1"] = time.perf_counter()

    waiter = threading.Thread(target=wait, daemon=True)
    waiter.start()
    return Lint(proc, t0, done, waiter)


def run_lint_phase(lint: Lint) -> dict:
    """The lint phase's gate: the lint must exit 0 within LINT_TIMEOUT_S
    of its start; prints its findings, files and wall."""
    lint.waiter.join(max(0.0, LINT_TIMEOUT_S - (time.perf_counter()
                                                 - lint.t0)))
    if lint.waiter.is_alive():
        lint.stop()
        raise AssertionError(f"lint: took more than {LINT_TIMEOUT_S} s")
    out = lint.done["stdout"] + lint.done["stderr"]
    if lint.proc.returncode != 0:
        raise AssertionError(f"lint: python {' '.join(LINT_ARGS)} exited "
                             f"{lint.proc.returncode}:\n{out[-3000:]}")
    m = LINT_SUMMARY.search(out)
    if m is None:
        raise AssertionError(f"lint: no summary line in its output:\n"
                             f"{out[-3000:]}")
    res = {"findings": int(m[1]), "files": int(m[2]),
           "suppressed": int(m[3] or 0),
           "seconds": lint.done["t1"] - lint.t0}
    print(f"lint: python {' '.join(LINT_ARGS)} exit 0: {res['findings']} "
          f"finding(s) in {res['files']} file(s), {res['suppressed']} "
          f"baseline-suppressed; {res['seconds']!r} s of wall in its "
          f"subprocess, beside the card paths")
    return res


KERNEL_KEYS = ["name", "route", "source", "replaces", "launches",
               "mismatches", "max_abs_err", "ms", "plain_ms", "bound_ms",
               "bound_by", "library_ms", "same_bytes_ms", "grad_ms",
               "ops_per_s", "bytes_per_s", "bound_share", "fp32_bound_ms",
               "fp32_bound_by", "fp32_bound_share", "shape",
               "launches_by_path", "call_ms", "plain_call_ms", "held_ms",
               "note", "witness_float64", "shapes"]


def report(lint: Lint, walls: dict, kernels: list, card: str,
           t_start: float, kind: str, count: int) -> int:
    """The lint phase's gate, then the summary: each phase's wall, the
    kernels line, the card line and, last, the result line (a failing gate
    raises before any of them)."""
    t0 = time.perf_counter()
    run_lint_phase(lint)
    walls["lint"] = time.perf_counter() - t0
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start!r} s; wall by phase (s): {walls}")
    print(json.dumps({"kernels": [{k: kern[k] for k in KERNEL_KEYS
                                   if k in kern} for kern in kernels]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs only on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch.core as C
    import repro_torch.core.torch_solvers as TS

    t_start = time.perf_counter()
    # the lint phase on the host, beside the card paths; gated in report
    lint = start_lint()
    try:
        return run_phases(C, TS, lint, t_start)
    finally:
        lint.stop()


def run_phases(C, TS, lint: Lint, t_start: float) -> int:
    """Every phase after the lint's start, then ``report``."""
    device = torch.device("cuda")
    card = _card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card}; torch {torch.__version__}, cuda "
          f"{torch.version.cuda}; TF32 off for float32 products")

    mods = {m: importlib.import_module(f"repro_torch.kernels.{m}")
            for m in dict.fromkeys(map(_module, KERNELS))}
    mp = mods["minplus"]
    walls = {}

    def phase(label, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        walls[label] = time.perf_counter() - t0
        return out

    phase("build", build_kernels, mods)
    matmul = phase("generic", check_minplus_matmul, mp, device)
    generic_new = phase("generic +", check_generic, mods, device)

    path = phase("path 1", run_main_path, C, TS, mp)
    stack = phase("path 5", run_serve_stack_path, C, TS, mp)
    sweep = phase("path 6", run_sweep_path, C, TS, mp, card=card)
    by_model = {}
    t_pipe = 0.0
    for run in (path, stack, sweep):
        park(run)
    for name in MODELS:
        by_model[name] = phase(name, run_model_path, name, mods, device)
        park(by_model[name])
        t_pipe += by_model[name]["pipeline"]["seconds"] + (
            by_model[name]["pipeline train"] or {}).get("seconds", 0.0)
    launchers = phase("launchers", run_launch_path, mods, device)
    park(launchers)
    t_pipe += walls["launchers"]
    print(f"path 7 (pipeline forward and training, launchers) took "
          f"{t_pipe!r} s of wall in all")
    cross = {}
    # path 9's dry runs on the host while path 8 runs on the card
    dry = start_dryrun_path()
    try:
        for name in CROSS:
            cross[name] = phase(name, run_cross_path, name, mods, device)
            park(cross[name])
        phase("path 9", run_dryrun_path, by_model, card, dry)
    finally:
        dry.stop()
    pipe_runs = {f"pipeline/{name}": by_model[name]["pipeline"]
                 for name in MODELS}
    matmul["launches_by_path"] = {
        "planner": path["matmul_launches"],
        "serve-stack": stack["matmul_launches"],
        "sweep": sweep["matmul_launches"], **{
            name: by_model[name]["launches"]["minplus"] for name in MODELS},
        **{p: run["launches"]["minplus"] for p, run in pipe_runs.items()}}
    matmul["launches"] = sum(matmul["launches_by_path"].values())
    print(f"clocks before the kernel timings (sm, max sm, temperature): "
          f"{_clocks_line()}")
    time_minplus_matmul(mp, device, matmul)
    kernels = [check_scan_path(
        mp, device, _operands_to(_merge([path["recorded"], stack["recorded"],
                            sweep["recorded"]] + [
            by_model[name]["recorded"]["minplus_scan"] for name in MODELS] + [
            run["recorded"]["minplus_scan"] for run in pipe_runs.values()]),
            device),
        {"planner": path["launches"], "serve-stack": stack["launches"],
         "sweep": sweep["launches"], **{
            name: by_model[name]["launches"]["minplus_scan"]
            for name in MODELS}, **{
            p: run["launches"]["minplus_scan"]
            for p, run in pipe_runs.items()}},
        _top_shape(path["recorded"][0])), matmul]
    print(f"clocks after the minplus_scan timings (sm, max sm, "
          f"temperature): {_clocks_line()}")
    for kernel in ("flash_attention", "ssd", "moe_gmm", "rglru",
                   "flash_attention_bwd", "ssd_bwd", "moe_gmm_bwd",
                   "rglru_bwd"):
        t_kernel = time.perf_counter()
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
            if kernel in spec.kernels:
                runs.append((f"pipeline/{m}", res["pipeline"]))
            if res["pipeline train"] is not None \
                    and kernel in TRAIN[m].kernels:
                runs.append((f"pipeline train/{m}", res["pipeline train"]))
        if kernel in ("flash_attention", "flash_attention_bwd"):
            runs.append(("launchers", launchers))
        for m, res in cross.items():
            if kernel == "flash_attention":
                runs += [(f"cross/{m}", res["forward"]),
                         (f"cross serve/{m}", res["serve"])]
            if res["train"] is not None and kernel in CROSS[m].train.kernels:
                runs.append((f"cross train/{m}", res["train"]))
        kernels.append(check_model_path(
            kernel, mods[_module(kernel)],
            _operands_to(_merge([run["recorded"][kernel] for _, run in runs]),
                         device),
            {path: run["launches"][kernel] for path, run in runs},
            generic_new[kernel], device))
        print(f"clocks after the {kernel} timings (sm, max sm, "
              f"temperature): {_clocks_line()}; its checks and timings in "
              f"{time.perf_counter() - t_kernel!r} s")

    walls["kernel checks and timings"] = time.perf_counter() - t_start - sum(
        walls.values())
    walls["generic"] += walls.pop("generic +")
    return report(lint, walls, kernels, card, t_start,
                  torch.cuda.get_device_name(0), torch.cuda.device_count())


if __name__ == "__main__":
    sys.exit(main())
