"""Fault-tolerant checkpointing of nested-dict trees of tensors.

Checkpoints are *logical* (unsharded) arrays: one ``.npy`` per leaf plus
a JSON manifest, committed by atomic directory rename — a half-written
checkpoint is never visible, so preemption mid-save is safe.  A
background thread keeps saves off the training path; ``keep`` bounds
disk usage.

The format is the JAX package's, key for key: leaves are numbered in
sorted-key order and each manifest entry names its leaf as
``jax.tree_util.keystr`` spells it (``['params']['layers']['wq']``), so
a checkpoint written by either package restores into the other.  numpy
has no bfloat16: such a leaf is stored as float32 (exactly), its
manifest entry says ``bfloat16``, and :func:`restore` casts it back.
:func:`restore` with ``shardings=`` places each leaf onto a sharded
layout, each rank keeping only its own shard (the reference's
elastic-rescale path).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.models import params as pm


def _keystr(path: tuple) -> str:
    return "".join(f"[{k!r}]" for k in path)


def _map_with_path(fn: Callable, tree, path: tuple = ()):
    """``fn(path, leaf)`` over every leaf of nested dicts."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


def _flatten_with_path(tree, path: tuple = ()) -> list:
    """``[(path, leaf)]`` in sorted-key order, as ``jax.tree_util``."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flatten_with_path(tree[k], path + (k,))]
    return [(path, tree)]


def _numpy(leaf) -> np.ndarray:
    """``leaf`` (a tensor on any device, an array or a scalar) as a host
    array."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    return np.asarray(leaf)


def _host_copy(_path, leaf):
    """A host copy of ``leaf`` that later in-place updates cannot reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf, copy=True)


def save(ckpt_dir: str, step: int, tree, keep: int = 3) -> str:
    """Synchronous atomic save. Returns the committed directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if os.path.exists(os.path.join(final, "manifest.json")):
        return final                 # idempotent: this step is committed
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    names = []
    for i, (path, leaf) in enumerate(_flatten_with_path(tree)):
        arr = _numpy(leaf)
        name = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, name), arr)
        bf16 = isinstance(leaf, torch.Tensor) and \
            leaf.dtype == torch.bfloat16
        names.append({"key": _keystr(path), "file": name,
                      "shape": list(arr.shape),
                      "dtype": "bfloat16" if bf16 else str(arr.dtype)})
    manifest = {"step": int(step), "leaves": names}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, final)          # atomic commit

    _prune(ckpt_dir, keep)
    return final


def _prune(ckpt_dir: str, keep: int) -> None:
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str) -> List[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(ckpt_dir, name, "manifest.json")):
                out.append(int(name[5:]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, target_tree, shardings=None,
            device=None):
    """Restore into the structure of ``target_tree``: each leaf becomes a
    tensor on ``device`` (default: the target leaf's device, the CPU for
    a leaf that is not a tensor).  A leaf the checkpoint lacks raises
    ``KeyError``.

    ``shardings`` (a matching tree of
    :class:`~repro_torch.models.sharding.Sharding`, e.g.
    :func:`repro_torch.models.params.shardings`) places each leaf as a
    DTensor laid out by its sharding: every rank cuts its own shard from
    the ``.npy`` and moves only that to ``device`` (default: the device
    type of the sharding's mesh), so nothing is communicated."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_key = {leaf["key"]: leaf for leaf in manifest["leaves"]}

    def load(path, leaf):
        if _keystr(path) not in by_key:
            raise KeyError(f"checkpoint missing leaf {_keystr(path)}")
        entry = by_key[_keystr(path)]
        t = torch.from_numpy(np.load(os.path.join(d, entry["file"])))
        if entry["dtype"] == "bfloat16":
            t = t.to(torch.bfloat16)
        if shardings is None:
            dev = device if device is not None else (
                leaf.device if isinstance(leaf, torch.Tensor) else "cpu")
            return t.to(dev)
        sh = _at(shardings, path)
        dev = device if device is not None else sh.mesh.device_type
        local = pm.local_shard(t, sh).to(dev).contiguous()
        return pm.place_local(local, sh, t.shape)
    return _map_with_path(load, target_tree)


def _at(tree, path: tuple):
    for k in path:
        tree = tree[k]
    return tree


class AsyncCheckpointer:
    """Overlaps checkpoint writes with training; at most one in flight.
    :meth:`save` copies every leaf to host memory before it returns, so
    the caller may go on updating its tensors in place."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save(self, step: int, tree) -> None:
        self.wait()
        host_tree = _map_with_path(_host_copy, tree)

        def work():
            try:
                save(self.ckpt_dir, step, host_tree, self.keep)
            except BaseException as e:   # surfaced on next wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
