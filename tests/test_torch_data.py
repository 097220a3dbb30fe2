"""The port's synthetic data on the CPU against the JAX package's: the
NumPy Philox streams are the same, so the batches are ``==``."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro import data as jdata
from repro_torch import data


@pytest.mark.parametrize("seed,memory_len", [(0, 0), (1, 0), (7, 4)])
def test_batches_equal_jax(seed, memory_len):
    jspec = jdata.BatchSpec(3, 17, 101, memory_len=memory_len, d_model=8)
    spec = data.BatchSpec(3, 17, 101, memory_len=memory_len, d_model=8)
    want, got = jdata.SyntheticLM(jspec, seed), data.SyntheticLM(spec, seed)
    for step in (0, 1, 5, 1000):
        w, g = want.batch_at(step), got.batch_at(step)
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    assert not np.array_equal(got.batch_at(0)["tokens"],
                              got.batch_at(1)["tokens"])


def test_prefetcher_and_placement():
    stream = data.SyntheticLM(data.BatchSpec(2, 9, 50), seed=3)
    pre = data.Prefetcher(stream, start_step=4)
    try:
        for step in (4, 5, 6):
            got_step, batch = pre.next()
            assert got_step == step
            np.testing.assert_array_equal(batch["tokens"],
                                          stream.batch_at(step)["tokens"])
    finally:
        pre.close()
    placed = data.shard_batch(stream.batch_at(0), "cpu")
    assert placed["tokens"].dtype == torch.int64
    assert torch.equal(placed["targets"][:, :-1], placed["tokens"][:, 1:])


def test_placement_without_a_card_raises(monkeypatch):
    """The batch goes to the card unless the caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    batch = data.SyntheticLM(data.BatchSpec(1, 4, 9)).batch_at(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        data.shard_batch(batch)
