"""Warm-restart snapshots: registry state -> versioned, checksummed files.

A service restart used to cost what cold start costs: re-trace every
design, rebuild every simgraph, re-run condensation, re-certify deadlock
floors, and re-simulate everything the evaluation caches had already
paid for.  This module serializes exactly those artifacts so a restarted
server answers its first request in milliseconds:

* the collected :class:`~repro_torch.core.tracer.Trace` (op streams per task),
* the packed :class:`~repro_torch.core.simgraph.SimGraph` arrays,
* every condensation rung (:class:`~repro_torch.core.condense.CondensedGraph`)
  with its index maps and certificate tables,
* the deadlock :class:`~repro_torch.core.deadlock.CertificationResult` and
  pruning bound caches, and
* the full :class:`~repro_torch.core.backends.ConfigCache` contents in
  insertion order.

Format: one ``<design>.<sha12>.snap.npz`` per design (named numpy arrays
plus an embedded JSON ``meta`` record) under a ``MANIFEST.json`` carrying
the snapshot version, the registry's
:class:`~repro_torch.core.config.EvalConfig`, and a SHA-256 per design file.

Crash consistency: every file is written to a temp name and published
with ``os.replace`` (file fsync'd before the rename, directory fsync'd
after it, so the renames themselves are durable in order), member files
are *content-addressed* (their name embeds their hash, so a re-save
never overwrites a file the previous manifest still references), and
the manifest is replaced last — a crash at ANY point mid-save leaves
the previous snapshot fully loadable.  Garbage collection runs only
after the new manifest is durably in place and spares the superseded
manifest's members too, so one concurrent reader that picked up the
previous manifest (a warm restart racing an auto-snapshot) can finish
its restore; older generations are reclaimed by the next save.
Concurrent *writers* are not coordinated — point each server at its
own snapshot directory.

Loads verify the manifest version and each member's checksum before
deserializing it.  A member that fails (missing file, checksum mismatch,
torn write) is *quarantined* by default: the healthy designs restore
warm and the quarantined ones simply re-trace on first use, with the
report attached as ``registry.restore_report``.  ``strict=True``
restores the old all-or-nothing behaviour (any mismatch raises
:class:`SnapshotError`); manifest-level problems (unreadable, wrong
version, config mismatch) always raise — a snapshot degrades to a cold
start, never to silently wrong state.

Restored advisors are *bit-identical* to freshly traced ones in every
observable (frontiers, histories, certificates); only wall-clock and
``n_evals`` differ, because cache hits are not re-simulated
(``tests/test_torch_snapshot.py`` asserts this).  They are built on the
registry's torch device.

The format, ``SNAPSHOT_VERSION`` and the member names are the reference
package's, so a snapshot written by either package loads in the other.
The config check maps the backend aliases (``"pallas"`` is ``"cuda"``,
``"jax"`` is ``"fixpoint"``) before it compares; the manifest records the
config as it was given.

Custom designs (registered with an explicit :class:`Design` object) are
skipped: a fresh process cannot rebuild the design callable by name, and
an advisor without its design cannot serve ``explain_deadlock`` or
re-trace.  The manifest records them under ``"skipped"`` so operators
see the gap.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import tempfile
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.advisor import Baseline, FifoAdvisor
from repro_torch.core.condense import CondensedGraph
from repro_torch.core.config import EvalConfig, same_config
from repro_torch.core.deadlock.certify import CertificationResult
from repro_torch.core.faults import FaultPlan, InjectedFault, resolve_plan
from repro_torch.core.service.registry import DesignRegistry
from repro_torch.core.simgraph import SimGraph
from repro_torch.core.tracer import TaskTrace, Trace

__all__ = ["SNAPSHOT_VERSION", "SnapshotError", "save_snapshot",
           "load_snapshot"]

#: bump on any incompatible change to the array layout or meta schema;
#: loaders reject other versions outright (cold start beats guessing)
SNAPSHOT_VERSION = 1

MANIFEST = "MANIFEST.json"


class SnapshotError(RuntimeError):
    """The snapshot directory is unreadable, tampered, or incompatible."""


class _BlobReader:
    """Named-array access over one contiguous buffer.

    Restores read ~50 arrays per design; going through the npz zip
    member machinery per array costs more than the data itself, so the
    on-disk layout is a single ``blob`` plus a ``{name: dtype/shape/
    offset}`` index in the meta record.  Arrays are copied out (not
    viewed) so restored state is writable and owns its memory.
    """

    def __init__(self, blob: np.ndarray, index: Dict[str, dict]):
        self._buf = np.ascontiguousarray(blob)
        self._index = index

    def __contains__(self, name: str) -> bool:
        return name in self._index

    def __getitem__(self, name: str) -> np.ndarray:
        e = self._index[name]
        dtype = np.dtype(e["dtype"])
        count = int(np.prod(e["shape"], dtype=np.int64)) if e["shape"] \
            else 1
        a = np.frombuffer(self._buf, dtype=dtype, count=count,
                          offset=e["offset"])
        return a.reshape(e["shape"]).copy()


def _pack_blob(arrays: Dict[str, np.ndarray]) -> tuple:
    """Concatenate named arrays into (blob, index) for :class:`_BlobReader`."""
    parts: List[bytes] = []
    index: Dict[str, dict] = {}
    offset = 0
    for name, a in arrays.items():
        a = np.ascontiguousarray(a)
        raw = a.tobytes()
        index[name] = {"dtype": a.dtype.str, "shape": list(a.shape),
                       "offset": offset}
        parts.append(raw)
        offset += len(raw)
    return np.frombuffer(b"".join(parts), dtype=np.uint8), index


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _array_fields(cls) -> List[str]:
    """Dataclass fields that hold numpy arrays (everything except the
    design/raw back-references and scalar metadata)."""
    skip = {"design", "raw", "unbounded_latency", "_bound", "tag"}
    return [f.name for f in dataclasses.fields(cls) if f.name not in skip]


# ----------------------------------------------------------------- save
def _pack_advisor(adv: FifoAdvisor) -> tuple:
    """(arrays dict, meta dict) for one advisor."""
    arrays: Dict[str, np.ndarray] = {}
    meta: dict = {
        "version": SNAPSHOT_VERSION,
        "design": adv.design.name,
        "config": adv.evaluator.config.to_dict(),
        "graph": {"unbounded_latency": int(adv.graph.unbounded_latency)},
        "baseline_max": _pack_baseline(adv.baseline_max, "bmax", arrays),
        "baseline_min": _pack_baseline(adv.baseline_min, "bmin", arrays),
    }

    # trace: per-task op streams, concatenated with per-task counts
    tr = adv.trace
    arrays["tr_kinds"] = np.concatenate(
        [t.kinds for t in tr.tasks]) if tr.tasks else np.zeros(0, np.int8)
    arrays["tr_fifos"] = np.concatenate(
        [t.fifos for t in tr.tasks]) if tr.tasks else np.zeros(0, np.int32)
    arrays["tr_deltas"] = np.concatenate(
        [t.deltas for t in tr.tasks]) if tr.tasks else np.zeros(0, np.int64)
    arrays["tr_ops"] = np.asarray([t.n_ops for t in tr.tasks], np.int64)
    arrays["tr_task"] = np.asarray([t.task for t in tr.tasks], np.int64)
    arrays["tr_end"] = np.asarray([t.end_delay for t in tr.tasks], np.int64)
    arrays["tr_writes"] = tr.write_counts
    arrays["tr_reads"] = tr.read_counts

    for name in _array_fields(SimGraph):
        arrays[f"g_{name}"] = getattr(adv.graph, name)

    rungs = [cg for cg, _impl in adv.evaluator.condensation]
    meta["rungs"] = []
    for i, cg in enumerate(rungs):
        meta["rungs"].append({
            "tag": cg.tag, "bound": int(cg._bound),
            "unbounded_latency": int(cg.unbounded_latency)})
        for name in _array_fields(CondensedGraph):
            arrays[f"cg{i}_{name}"] = getattr(cg, name)

    cache = adv.cache
    n = len(cache)
    arrays["cache_rows"] = cache._rows[:n]
    arrays["cache_lat"] = cache._lat[:n]
    arrays["cache_bram"] = cache._bram[:n]
    arrays["cache_dead"] = cache._dead[:n]

    if adv._upper_bounds is not None:
        arrays["upper_bounds"] = np.asarray(adv._upper_bounds, np.int64)
    if adv._lb_cache is not None:
        arrays["lb_cache"] = adv._lb_cache
    cert = adv._certification
    if cert is not None:
        arrays["cert_depths"] = cert.depths
        arrays["cert_start"] = cert.start
        meta["certification"] = {
            "latency": int(cert.latency), "bram": int(cert.bram),
            "n_probes": int(cert.n_probes),
            "n_cache_hits": int(cert.n_cache_hits),
            "wall_s": float(cert.wall_s)}
    return arrays, meta


def _pack_baseline(b: Baseline, prefix: str, arrays: dict) -> dict:
    arrays[f"{prefix}_depths"] = np.asarray(b.depths, np.int64)
    return {"latency": int(b.latency), "bram": int(b.bram),
            "deadlocked": bool(b.deadlocked)}


def _atomic_write(directory: str, fname: str, data: bytes) -> str:
    """Publish ``data`` at ``directory/fname`` via tmp + fsync +
    ``os.replace`` (the checkpoint pattern from ``campaign/state.py``):
    readers only ever see the old file or the complete new one.

    The directory is fsync'd after the replace so the *rename itself*
    is durable before we return — member renames therefore hit disk
    before the manifest rename that references them, and a power loss
    cannot persist a manifest whose members evaporated."""
    path = os.path.join(directory, fname)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(directory)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def _fsync_dir(directory: str) -> None:
    """Make a completed rename in ``directory`` durable (no-op where
    directories cannot be opened for fsync, e.g. Windows)."""
    try:
        dfd = os.open(directory, os.O_RDONLY)
    except OSError:  # pragma: no cover - platform without dir-open
        return
    try:
        os.fsync(dfd)
    except OSError:  # pragma: no cover - fs without dir fsync
        pass
    finally:
        os.close(dfd)


def save_snapshot(registry: DesignRegistry, directory: str,
                  faults: Optional["FaultPlan"] = None) -> dict:
    """Write a warm-restart snapshot of every registered design.

    Returns the manifest dict that was written to ``MANIFEST.json``.
    Member files are content-addressed (``<name>.<sha12>.snap.npz``) and
    every write is atomic, with the manifest replaced last — so a crash
    anywhere mid-save leaves the previous snapshot fully loadable.
    Member files referenced by neither the new manifest nor the one it
    superseded are garbage-collected after the new manifest is in place
    (the superseded generation survives one save for concurrent
    readers).

    ``faults`` (chaos testing) may schedule ``crash_save`` — abort with
    :class:`~repro_torch.core.faults.InjectedFault` before writing member
    ``at`` (``at == n_designs`` aborts just before the manifest) — and
    ``corrupt_snapshot`` — flip byte ``value`` of member ``at`` *after*
    its checksum was recorded, i.e. a torn write the loader must catch.
    """
    if faults is None:
        faults = resolve_plan(registry.config)
    os.makedirs(directory, exist_ok=True)
    # remember what the manifest being superseded references: its
    # members survive this save's GC so a reader holding that manifest
    # (a warm restart racing an auto-snapshot) never has files
    # unlinked out from under it mid-load
    prior = None
    try:
        with open(os.path.join(directory, MANIFEST)) as f:
            prior = json.load(f)
    except (OSError, ValueError):
        pass
    manifest = {"version": SNAPSHOT_VERSION,
                "config": registry.config.to_dict(),
                "designs": {}, "skipped": sorted(registry.custom_names)}
    saved = [n for n in registry.names()
             if n not in registry.custom_names]
    for i, name in enumerate(saved):
        if faults is not None and faults.take(
                "crash_save", at=i, targets=(name,)) is not None:
            raise InjectedFault(
                f"injected crash before writing snapshot member {i} "
                f"({name})")
        arrays, meta = _pack_advisor(registry[name])
        blob, meta["arrays"] = _pack_blob(arrays)
        buf = io.BytesIO()
        np.savez(buf, blob=blob, meta=np.frombuffer(
            json.dumps(meta).encode("utf-8"), dtype=np.uint8))
        data = buf.getvalue()
        digest = hashlib.sha256(data).hexdigest()
        fname = f"{name}.{digest[:12]}.snap.npz"
        path = _atomic_write(directory, fname, data)
        manifest["designs"][name] = {"file": fname, "sha256": digest}
        if faults is not None:
            f = faults.take("corrupt_snapshot", at=i, targets=(name,))
            if f is not None:
                _flip_byte(path, int(f.value))
    if faults is not None and faults.take(
            "crash_save", at=len(saved)) is not None:
        raise InjectedFault(
            "injected crash before publishing the snapshot manifest")
    _atomic_write(directory, MANIFEST, json.dumps(
        manifest, indent=1, sort_keys=True).encode("utf-8"))
    _collect_garbage(directory, manifest, prior)
    return manifest


def _flip_byte(path: str, offset: int) -> None:
    """Corrupt one byte in place (the ``corrupt_snapshot`` fault)."""
    size = os.path.getsize(path)
    offset = offset % max(size, 1)
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


def _collect_garbage(directory: str, manifest: dict,
                     prior: Optional[dict] = None) -> None:
    """Remove member files neither the freshly published manifest nor
    the one it superseded reference (older generations, aborted saves).
    Keeping the prior generation's members lets a reader that loaded
    the previous manifest finish its restore even while this save runs;
    they are reclaimed by the *next* save."""
    live = {e["file"] for e in manifest.get("designs", {}).values()}
    if prior is not None:
        live |= {e.get("file") for e
                 in prior.get("designs", {}).values()
                 if isinstance(e, dict)}
    for fname in os.listdir(directory):
        if fname.endswith(".snap.npz") and fname not in live:
            try:
                os.unlink(os.path.join(directory, fname))
            except OSError:  # pragma: no cover - raced with another save
                pass


# ----------------------------------------------------------------- load
def _unpack_advisor(name: str, z, meta: dict, device) -> FifoAdvisor:
    from repro_torch.designs import make_design
    design = make_design(name)
    config = EvalConfig.from_dict(meta["config"])

    ops = z["tr_ops"]
    splits = np.cumsum(ops)[:-1]
    kinds = np.split(z["tr_kinds"], splits)
    fifos = np.split(z["tr_fifos"], splits)
    deltas = np.split(z["tr_deltas"], splits)
    tasks = [TaskTrace(task=int(z["tr_task"][i]), kinds=kinds[i],
                       fifos=fifos[i], deltas=deltas[i],
                       end_delay=int(z["tr_end"][i]))
             for i in range(len(ops))]
    # functional results are only consumed on freshly collected traces
    # (the fuzzer's differential oracle); a restored trace serves timing
    trace = Trace(design=design, tasks=tasks, results={},
                  write_counts=z["tr_writes"], read_counts=z["tr_reads"])

    graph = SimGraph(
        design=design,
        unbounded_latency=int(meta["graph"]["unbounded_latency"]),
        **{f: z[f"g_{f}"] for f in _array_fields(SimGraph)})

    rungs = []
    for i, rm in enumerate(meta.get("rungs", [])):
        rungs.append(CondensedGraph(
            raw=graph, tag=rm["tag"], _bound=int(rm["bound"]),
            unbounded_latency=int(rm["unbounded_latency"]),
            **{f: z[f"cg{i}_{f}"] for f in _array_fields(CondensedGraph)}))

    cert = None
    if "certification" in meta:
        cm = meta["certification"]
        cert = CertificationResult(
            depths=z["cert_depths"], start=z["cert_start"],
            latency=cm["latency"], bram=cm["bram"],
            n_probes=cm["n_probes"], wall_s=cm["wall_s"],
            n_cache_hits=cm.get("n_cache_hits", 0))

    def baseline(prefix: str, key: str) -> Baseline:
        bm = meta[key]
        return Baseline(depths=z[f"{prefix}_depths"], latency=bm["latency"],
                        bram=bm["bram"], deadlocked=bm["deadlocked"])

    return FifoAdvisor.restore(
        design, trace=trace, graph=graph, config=config,
        upper_bounds=z["upper_bounds"] if "upper_bounds" in z else None,
        rungs=rungs,
        baseline_max=baseline("bmax", "baseline_max"),
        baseline_min=baseline("bmin", "baseline_min"),
        certification=cert,
        lb_cache=z["lb_cache"] if "lb_cache" in z else None,
        cache_data=(z["cache_rows"], z["cache_lat"],
                    z["cache_bram"], z["cache_dead"]),
        device=device)


def _verify_member(directory: str, name: str, entry: dict, device):
    """Checksum-verify and deserialize one snapshot member; returns the
    reason string when the member is damaged (the quarantine path)."""
    path = os.path.join(directory, entry["file"])
    if not os.path.exists(path):
        return None, f"snapshot file missing: {path}"
    digest = _sha256(path)
    if digest != entry["sha256"]:
        return None, (
            f"checksum mismatch for {entry['file']}: manifest "
            f"{entry['sha256'][:12]}..., file {digest[:12]}...")
    try:
        with np.load(path) as npz:
            meta = json.loads(bytes(npz["meta"]).decode("utf-8"))
            if meta.get("version") != SNAPSHOT_VERSION:
                return None, (
                    f"design {name}: snapshot version "
                    f"{meta.get('version')!r} != {SNAPSHOT_VERSION}")
            z = _BlobReader(npz["blob"], meta["arrays"])
        return _unpack_advisor(name, z, meta, device), None
    except Exception as e:   # a checksum-clean file that still fails to
        # deserialize means writer/reader drift — quarantine, don't die
        return None, f"design {name}: failed to deserialize: {e}"


def load_snapshot(directory: str,
                  registry: Optional[DesignRegistry] = None,
                  strict: bool = False, device=None) -> DesignRegistry:
    """Restore a :class:`DesignRegistry` from a snapshot directory.

    Verifies the manifest version, then checksum-verifies and restores
    each member.  A damaged member (missing file, checksum mismatch,
    torn write, deserialization failure) is *quarantined*: the healthy
    designs restore warm and the damaged ones are skipped — they simply
    re-trace on first use.  The outcome is attached to the returned
    registry as ``registry.restore_report``::

        {"restored": [names...], "quarantined": {name: reason, ...}}

    ``strict=True`` turns any damaged member into a
    :class:`SnapshotError` instead (the pre-quarantine behaviour).
    Manifest-level problems — unreadable manifest, version mismatch,
    config mismatch with a caller-supplied ``registry`` — always raise.

    When ``registry`` is given, restored advisors are adopted into it
    and built on its device (its config must match the snapshot's, with
    the backend aliases mapped); otherwise a fresh registry is built
    from the snapshot's config on ``device`` (None = CUDA).
    """
    mpath = os.path.join(directory, MANIFEST)
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise SnapshotError(f"unreadable snapshot manifest {mpath}: {e}")
    version = manifest.get("version")
    if version != SNAPSHOT_VERSION:
        raise SnapshotError(
            f"snapshot version {version!r} != supported {SNAPSHOT_VERSION}")
    config = EvalConfig.from_dict(manifest["config"])
    if registry is None:
        registry = DesignRegistry(config, device=device)
    elif not same_config(registry.config, config):
        raise SnapshotError(
            f"snapshot config {config} != registry config {registry.config}")
    report = {"restored": [], "quarantined": {}}
    for name, entry in manifest.get("designs", {}).items():
        advisor, reason = _verify_member(directory, name, entry,
                                         registry.device)
        if reason is not None:
            if strict:
                raise SnapshotError(reason)
            report["quarantined"][name] = reason
            continue
        registry.adopt(name, advisor)
        report["restored"].append(name)
    registry.restore_report = report
    return registry
