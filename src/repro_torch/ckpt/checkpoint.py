"""Sharded numpy checkpointing: atomic, async, retention-managed, in the
JAX package's on-disk format (``src/repro/ckpt/checkpoint.py``), so that a
checkpoint written by either package restores in the other.

Each leaf is one ``leaf_%05d.npy`` under the step directory, in the leaf
order of ``jax.tree_util.tree_flatten_with_path`` (dict keys sorted, lists
and tuples in order, None an empty subtree); the manifest records each
leaf's key path, file, shape and dtype, and the training step.  Writes go
to a temp dir renamed into place (crash-atomic); a background thread makes
saves non-blocking; ``keep`` bounds disk use.  Restore rebuilds the nested
tree from the key paths alone (dicts + lists).

Leaves are tensors (any device), numpy arrays or numbers.  numpy has no
bfloat16 without ``ml_dtypes``: a bf16 leaf is written as the JAX package
writes an ``ml_dtypes`` one, its raw 16-bit words under the descriptor
``'<V2'``, with ``"dtype": "bfloat16"`` in the manifest, and restored by the
manifest's dtype into ``torch.bfloat16``.  Every leaf restores as a CPU
tensor.  Model parameters and optimizer state cross through
``models.convert`` (``params_to_jax_layout``, ``opt_state_to_jax_layout``
and their inverses).
"""
from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch
from numpy.lib import format as npy_format

BF16 = "bfloat16"


def flatten_with_path(tree, prefix: tuple = ()) -> list:
    """(key path, leaf) of every leaf, in the order of JAX's
    ``tree_flatten_with_path``: dict keys sorted, lists and tuples in
    order, None holding no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in flatten_with_path(tree[k], prefix + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in flatten_with_path(v, prefix + (i,))]
    return [(prefix, tree)]


def _host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a host array of its own (never a view of the leaf) and the
    manifest's dtype name; a bf16 tensor as its 16-bit words."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        t = t.clone() if t.device.type == "cpu" else t.cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), BF16
        return t.numpy(), str(t.numpy().dtype)
    arr = np.array(leaf)
    return arr, str(arr.dtype)


def _save_leaf(path: Path, arr: np.ndarray, dtype: str) -> None:
    if dtype != BF16:
        np.save(path, arr)
        return
    arr = np.require(arr, requirements="C")  # keeps a 0-d array 0-d
    header = npy_format.header_data_from_array_1_0(arr)
    header["descr"] = "<V2"  # what numpy records for ml_dtypes' bfloat16
    with open(path, "wb") as f:
        npy_format.write_array_header_1_0(f, header)
        f.write(arr.tobytes())


def _load_leaf(path: Path, dtype: str) -> torch.Tensor:
    arr = np.require(np.load(path), requirements="C")
    if dtype == BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _path_str(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _set_nested(root, parts: list[str], value):
    cur = root
    for i, p in enumerate(parts[:-1]):
        nxt_is_idx = parts[i + 1].isdigit()
        if p.isdigit():
            p = int(p)
            while len(cur) <= p:
                cur.append([] if nxt_is_idx else {})
            if cur[p] == [] and not nxt_is_idx:
                cur[p] = {}
            cur = cur[p]
        else:
            if p not in cur:
                cur[p] = [] if nxt_is_idx else {}
            cur = cur[p]
    last = parts[-1]
    if last.isdigit():
        last = int(last)
        while len(cur) <= last:
            cur.append(None)
        cur[last] = value
    else:
        cur[last] = value


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, blocking: bool = True) -> None:
        """Every leaf is copied to the host before this returns, so a
        non-blocking save writes the values of the call even where the
        caller then updates its tensors in place (the port's optimizers
        do).  A save waits for the one still writing."""
        leaves = [(path, *_host(leaf))
                  for path, leaf in flatten_with_path(tree)]
        self.wait()
        if blocking:
            self._write(step, leaves)
        else:
            self._thread = threading.Thread(target=self._write,
                                            args=(step, leaves), daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, leaves) -> None:
        tmp = self.dir / f".tmp_step_{step}_{time.time_ns()}"
        tmp.mkdir(parents=True)
        manifest = {"step": step, "leaves": []}
        for i, (path, arr, dtype) in enumerate(leaves):
            fname = f"leaf_{i:05d}.npy"
            _save_leaf(tmp / fname, arr, dtype)
            manifest["leaves"].append({
                "path": _path_str(path), "file": fname,
                "shape": list(arr.shape), "dtype": dtype,
            })
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        final = self.dir / f"step_{step:010d}"
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        self._gc()

    def _gc(self) -> None:
        ckpts = sorted(self.dir.glob("step_*"))
        for old in ckpts[: -self.keep]:
            shutil.rmtree(old, ignore_errors=True)

    # --------------------------------------------------------------- restore
    def latest_step(self) -> int | None:
        ckpts = sorted(self.dir.glob("step_*"))
        if not ckpts:
            return None
        return int(ckpts[-1].name.split("_")[1])

    def restore(self, step: int | None = None):
        """Returns (step, tree) or (None, None) when no checkpoint exists;
        the leaves are CPU tensors of the manifest's dtypes."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        d = self.dir / f"step_{step:010d}"
        manifest = json.loads((d / "manifest.json").read_text())
        root: dict = {}
        for leaf in manifest["leaves"]:
            _set_nested(root, leaf["path"].split("/"),
                        _load_leaf(d / leaf["file"], leaf["dtype"]))
        return manifest["step"], root
