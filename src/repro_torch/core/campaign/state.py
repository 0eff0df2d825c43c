"""Campaign checkpoint format and deterministic resume.

One campaign checkpoint is a single ``.npz`` file holding

* ``manifest`` — a JSON document: spec, task list, per-task status,
  per-step simulated-row counts, accumulated timings, and the exact
  numpy ``Generator`` bit-state of every task's RNG;
* per-task history arrays — ``t{i}_configs/lat/bram/dead`` (the full
  evaluation history) and ``t{i}_steps`` (per-``observe`` batch lengths).

Resume does NOT pickle generator frames.  Optimizers are deterministic
functions of (seed, observed results), so :func:`replay` rebuilds every
task from its spec and *re-drives* the generator, feeding back the
recorded result batches step by step.  The recorded rows are inserted
into each design's shared cache first, so the post-replay cache equals
the uninterrupted run's cache at the same round — every later lookup,
budget counter, and RNG draw proceeds identically, which makes resumed
frontiers and hypervolumes byte-identical to an uninterrupted run.  Two
guards enforce this: each replayed proposal must match the recorded
configs exactly, and the replayed RNG bit-state must equal the
checkpointed one (:class:`CheckpointMismatch` otherwise).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict

import numpy as np

#: version 2 records the evaluation knobs as one ``eval`` EvalConfig
#: dict; version-1 checkpoints (flat backend/max_iters/shards keys) are
#: still loadable — ``Campaign.resume`` folds them into an EvalConfig
CHECKPOINT_VERSION = 2
_READABLE_VERSIONS = (1, 2)


class CheckpointMismatch(RuntimeError):
    """Replay diverged from the checkpoint (code or data drift)."""


def _rng_state_jsonable(state: Dict) -> Dict:
    # PCG64 state is plain ints/strs; round-trip through JSON is exact
    return json.loads(json.dumps(state))


def save_checkpoint(campaign, path: str) -> str:
    """Atomically write ``campaign``'s full deterministic state."""
    spec = campaign.spec
    manifest = {
        "version": CHECKPOINT_VERSION,
        "round": campaign.round,
        "spec": {
            "designs": list(spec.designs),
            "optimizers": list(spec.optimizers),
            "budget": spec.budget,
            "seed": spec.seed,
            "eval": spec.eval.to_dict(),
            "workers": spec.workers,
            "hetero": spec.hetero,
            "checkpoint_every": spec.checkpoint_every,
            "checkpoint_every_s": spec.checkpoint_every_s,
            "track_hypervolume": spec.track_hypervolume,
        },
        "tasks": [],
    }
    arrays = {}
    for i, task in enumerate(campaign.tasks):
        cfgs, lat, bram, dead, steps = task.ctx.history()
        arrays[f"t{i}_configs"] = cfgs
        arrays[f"t{i}_lat"] = lat
        arrays[f"t{i}_bram"] = bram
        arrays[f"t{i}_dead"] = dead
        arrays[f"t{i}_steps"] = steps
        manifest["tasks"].append({
            "design": task.spec.design,
            "optimizer": task.spec.optimizer,
            "seed": task.spec.seed,
            "budget": task.spec.budget,
            "kwargs": [list(kv) for kv in task.spec.kwargs],
            "done": task.done,
            "n_evals": task.ctx.n_evals,
            "step_miss": list(map(int, task.step_miss)),
            "eval_s": task.eval_s,
            "step_s": task.opt.step_s,
            "runtime_s": (task.result.runtime_s if task.done else None),
            "rng_state": _rng_state_jsonable(
                task.ctx.rng.bit_generator.state),
            "hv_trace": [[int(n), float(h)] for n, h in task.hv_trace],
        })
    directory = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, manifest=np.asarray(
                json.dumps(manifest)), **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def load_checkpoint(path: str) -> Dict:
    """Read a checkpoint into ``{spec, round, tasks, histories}``."""
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(str(z["manifest"]))
        if manifest["version"] not in _READABLE_VERSIONS:
            raise CheckpointMismatch(
                f"checkpoint version {manifest['version']} not in "
                f"readable versions {_READABLE_VERSIONS}")
        histories = []
        for i in range(len(manifest["tasks"])):
            histories.append((z[f"t{i}_configs"], z[f"t{i}_lat"],
                              z[f"t{i}_bram"], z[f"t{i}_dead"],
                              z[f"t{i}_steps"]))
    manifest["histories"] = histories
    return manifest


def replay(campaign, data: Dict) -> None:
    """Drive a freshly-built campaign to the checkpointed position."""
    campaign.round = int(data["round"])
    for task, tdata, hist in zip(campaign.tasks, data["tasks"],
                                 data["histories"]):
        cfgs, lat, bram, dead, steps = hist
        if cfgs.shape[0]:
            # seed the design cache with everything evaluated so far, so
            # post-resume lookups see the uninterrupted run's cache state
            task.dctx.cache.insert(cfgs, lat, bram, dead)
        pos = 0
        for si, n in enumerate(steps):
            n = int(n)
            req = task.opt.propose()
            sl = slice(pos, pos + n)
            pos += n
            if req is None or not np.array_equal(req.depths, cfgs[sl]):
                raise CheckpointMismatch(
                    f"task {task.key}: replayed proposal {si} does not "
                    f"match the checkpointed history")
            n_miss = tdata["step_miss"][si]
            task.ctx.record(cfgs[sl], lat[sl], bram[sl], dead[sl], n_miss)
            task.step_miss.append(int(n_miss))
            task.opt.observe(lat[sl], bram[sl], dead[sl])
            if campaign.spec.track_hypervolume:
                task.hv_trace.append(
                    (task.ctx.n_evals, task.running_hypervolume()))
        state = task.ctx.rng.bit_generator.state
        if _rng_state_jsonable(state) != tdata["rng_state"]:
            raise CheckpointMismatch(
                f"task {task.key}: RNG state after replay differs from "
                f"the checkpoint — optimizer code drifted?")
        task.eval_s = float(tdata["eval_s"])
        task.opt.step_s = float(tdata["step_s"])
        if tdata["done"]:
            if task.opt.propose() is not None:
                raise CheckpointMismatch(
                    f"task {task.key}: marked done but proposes more work")
            task.finalize()
            task.result.runtime_s = float(tdata["runtime_s"])
