"""Deterministic synthetic data: host batches, a prefetch thread, and their
placement on a device, as the JAX package's ``src/repro/data/pipeline.py``.

Token streams are generated per (shard, step) from a counter-based NumPy
Philox generator, so any host can make exactly its slice and a restart needs
only the step; the streams are the JAX package's, number for number.  A
background thread prefetches.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..core.torch_solvers import resolve_device


def _philox_tokens(seed: int, step: int, shape: tuple[int, ...], vocab: int,
                   salt: int = 0) -> np.ndarray:
    rng = np.random.Generator(np.random.Philox(key=seed,
                                               counter=[0, 0, salt, step]))
    return rng.integers(0, vocab, size=shape, dtype=np.int32)


@dataclass
class BatchSpec:
    global_batch: int
    seq_len: int
    vocab: int
    memory_len: int = 0
    d_model: int = 0


class SyntheticLM:
    """Markov-ish synthetic LM stream: targets are a deterministic function
    of tokens, so a training loop can actually reduce the loss."""

    def __init__(self, spec: BatchSpec, seed: int = 0):
        self.spec, self.seed = spec, seed

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        s = self.spec
        toks = _philox_tokens(self.seed, step,
                              (s.global_batch, s.seq_len + 1), s.vocab)
        # learnable structure: every 4th token repeats the previous one
        toks[:, 1::4] = toks[:, 0:-1:4]
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        if s.memory_len:
            rng = np.random.Generator(
                np.random.Philox(key=self.seed, counter=[1, 0, 0, step]))
            batch["memory"] = rng.standard_normal(
                (s.global_batch, s.memory_len, s.d_model), dtype=np.float32)
        return batch


class Prefetcher:
    def __init__(self, stream: SyntheticLM, start_step: int = 0,
                 depth: int = 2):
        self.stream = stream
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self.t = threading.Thread(target=self._work, daemon=True)
        self.t.start()

    def _work(self):
        step = self.step
        while not self._stop.is_set():
            batch = self.stream.batch_at(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self):
        return self.q.get()

    def close(self):
        self._stop.set()


def shard_batch(batch: dict, device: str | torch.device = "cuda") -> dict:
    """The host numpy batch as tensors on ``device`` (``"cuda"`` unless the
    caller asks for the CPU; one card takes the whole batch, where the JAX
    package shards its batch axis over a mesh).  Tokens and targets become
    int64, PyTorch's index type."""
    device = resolve_device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = (t.long() if t.dtype == torch.int32 else t).to(device)
    return out
