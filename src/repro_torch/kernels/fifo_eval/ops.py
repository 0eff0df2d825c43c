"""Batched evaluation closures around the fifo_eval kernels.

Consumes the shared padded event tensors from
:mod:`repro_torch.core.backends.operands` (built once per graph and device)
and exposes callables ``(C, F) int depths -> numpy results``.  The
depth-dependent per-config operands come from the shared
:func:`~repro_torch.core.backends.operands.depth_operands`, and the
results from :func:`~repro_torch.kernels.fifo_eval.launch_ops
.eval_epilogue`, one packed (C, lanes) int32 array; only the fixpoint
differs between inners:

``use_ref=False``  K2, :func:`repro_torch.kernels.fifo_eval.fifo_eval
                   .fifo_eval` (the CUDA kernel on CUDA tensors, its plain
                   version on CPU tensors)
``use_ref=True``   the plain torch fixpoint (:mod:`.ref`), which is the
                   ``fixpoint`` backend

:func:`make_hetero_batched_eval` is the cross-design closure: rows of many
graphs in one K2 launch in its per-design-table mode (the plain
``fifo_eval_ref_hetero`` on the CPU).

On a lone CUDA device a K2 or K1 call is a fixed sequence: one pinned
copy of the depth rows up, the depth-operand kernel, the fixpoint kernel,
the epilogue kernel, one pinned copy of the packed result back, and one
wait (:class:`_Staging`); the CPU runs the plain versions of the same
steps.

Each closure takes ``mesh=`` (:mod:`repro_torch.launch.mesh`): the rows
are then split into contiguous blocks, one per shard, and every shard
launches its own kernel on its device (:func:`_shard_over_rows`), with
pageable copies and one readback a shard.

Each call is one :mod:`repro_torch.obs` span, ``launch.k2``, ``launch.k1``
or ``launch.k2_hetero`` (``rows``: the rows launched, padding included;
``iters``: the iterations they ran, summed; on ``launch.k2`` and
``launch.k1``, ``device_operands``: 1 where the depth-operand kernel built
the launch's operands, read from its launch count), around the whole host
path.
Its children are ``launch.operands`` (the depth-dependent operands),
``launch.kernel`` (the kernel call, which enqueues it on a CUDA device)
and ``launch.readback`` (the copy to the host, which waits for the
device); a sharded call has these once per shard.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.backends.base import resolve_device
from repro_torch.core.backends.operands import (HeteroTables,
                                                bram_count_torch,
                                                cert_row_operands,
                                                depth_operands,
                                                get_cert_tables,
                                                get_operands,
                                                hetero_depth_operands)
from repro_torch.kernels.fifo_eval.condensed import fifo_eval_condensed
from repro_torch.kernels.fifo_eval.fifo_eval import (fifo_eval,
                                                     fifo_eval_hetero)
from repro_torch.kernels.fifo_eval.launch_ops import (_status,
                                                      depth_operands_device,
                                                      eval_epilogue, unpack)
from repro_torch.kernels.fifo_eval.ref import fifo_eval_plain

#: dispatches per closure kind ("batched" / "hetero" / "condensed").  The
#: cascade device-residency test asserts that a fully-certifying batch
#: costs exactly ONE "condensed" dispatch and never touches the host
#: verifier.
DISPATCH_COUNTS: Counter = Counter()
#: the output lane that holds the iterations a row ran
ITERS_LANE = 3


def _numpy(*xs) -> Tuple[np.ndarray, ...]:
    with obs.span("launch.readback"):
        return tuple(x.cpu().numpy() for x in xs)


def _rows(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int32), device=dev)


def _devices(device, mesh) -> Tuple[torch.device, ...]:
    """The distinct devices a closure runs on: the mesh's, or one."""
    if mesh is None:
        return (resolve_device(device),)
    return tuple(dict.fromkeys(torch.device(d) for d in mesh.devices))


def _shard_over_rows(run: Callable, mesh, kind: str) -> Callable:
    """Partition the rows over ``mesh``: shard ``i`` runs ``run(device_i,
    *blocks, **fixed)`` on the ``i``-th contiguous block of every row
    array, and the numpy results are gathered in shard order.

    Every shard is launched before any result is read back, so shards on
    different cards overlap.  Rows are independent (one fixpoint per
    candidate config) and nothing crosses shards, so the result is
    bit-identical to the unsharded call.  The row count must be a
    multiple of ``mesh.size`` (the backends pad by repeating the last
    row).  Each shard's launch counts in :data:`DISPATCH_COUNTS` under
    ``"<kind>@shard<i>"``.
    """
    devices = tuple(torch.device(d) for d in mesh.devices)
    k = len(devices)

    def call(*row_arrays, **fixed):
        c = row_arrays[0].shape[0]
        if c % k:
            raise ValueError(f"{c} rows do not split over {k} shards; pad "
                             f"the batch to a multiple of the mesh size")
        b = c // k
        outs = []
        for i, dev in enumerate(devices):
            DISPATCH_COUNTS[f"{kind}@shard{i}"] += 1
            outs.append(run(dev, *(a[i * b:(i + 1) * b]
                                   for a in row_arrays), **fixed))
        parts = [_numpy(*o) for o in outs]
        return tuple(np.concatenate(col) for col in zip(*parts))

    return call


def _over(run: Callable, device, mesh, kind: str) -> Callable:
    """``run(dev, *rows, **fixed)`` once on ``device``, or over the shards
    of ``mesh``; results as numpy."""
    if mesh is not None:
        return _shard_over_rows(run, mesh, kind)
    dev = resolve_device(device)

    def call(*row_arrays, **fixed):
        return _numpy(*run(dev, *row_arrays, **fixed))
    return call


class _Staging:
    """Pinned host buffers of one closure on one CUDA device: the depth
    rows go up from one and the packed results come back into the other,
    each grown to the largest batch seen.  A call's readback waits for the
    stream, so the next call finds both buffers free; a closure is called
    from one thread at a time (the service is one asyncio loop)."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self._rows: Optional[torch.Tensor] = None
        self._packed: Optional[torch.Tensor] = None

    @staticmethod
    def _grown(buf: Optional[torch.Tensor], shape) -> torch.Tensor:
        if buf is None or buf.shape[0] < shape[0] or \
                buf.shape[1:] != shape[1:]:
            buf = torch.empty(shape, dtype=torch.int32, pin_memory=True)
        return buf

    def upload(self, a: np.ndarray, dev: torch.device) -> torch.Tensor:
        """The (C, F) rows as int32 on the device (cast as
        :func:`_rows` casts), copied without a wait."""
        self._rows = self._grown(self._rows, a.shape)
        buf = self._rows[:a.shape[0]]
        buf.numpy()[...] = a
        return buf.to(dev, non_blocking=True)

    def readback(self, packed: torch.Tensor,
                 times: Optional[torch.Tensor] = None
                 ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """The packed result (and the times, pageable) on the host after
        one wait: ``(packed, times)`` as numpy arrays of their own."""
        with obs.span("launch.readback"):
            self._packed = self._grown(self._packed, tuple(packed.shape))
            host = self._packed[:packed.shape[0]]
            host.copy_(packed, non_blocking=True)
            t = None if times is None else times.cpu().numpy()
            torch.cuda.current_stream(self.dev).synchronize()
            return host.numpy().copy(), t


def _packed_over(run: Callable, answer: Callable, device, mesh,
                 kind: str) -> Callable:
    """The K2 and K1 closures' ``go(depth_matrix, iters=False)``:
    ``run(dev, depth_matrix, upload)`` returns the device tensors
    ``(packed[, times])``, ``answer(packed, times=None, iters=...)`` the
    closure's tuple from them as numpy.  On a lone CUDA device through a
    :class:`_Staging`; over a mesh or on the CPU as :func:`_over` runs it,
    with :func:`_rows`."""
    dev = None if mesh is not None else resolve_device(device)
    if dev is None or dev.type != "cuda":
        inner = _over(lambda d, a: run(d, a, _rows), device, mesh, kind)
        return lambda a, iters=False: answer(*inner(a), iters=iters)
    staging = _Staging(dev)
    return lambda a, iters=False: answer(
        *staging.readback(*run(dev, a, staging.upload)), iters=iters)


def _launch(name: str, go: Callable, *row_arrays, operand_builds: int = 0,
            **fixed) -> tuple:
    """``go(*row_arrays, **fixed)`` in the span ``name``; while it
    records, ``go`` also returns the iteration lane, which is summed into
    the span's ``iters`` (it rides the same copy back, no extra wait).  A
    call that builds depth operands ``operand_builds`` times (once a
    shard) sets the span's ``device_operands`` to 1 where the
    depth-operand kernel launched for each of them, else 0."""
    with obs.span(name, rows=int(row_arrays[-1].shape[0])) as s:
        if not s:
            return go(*row_arrays, **fixed)
        before = depth_operands_device.launches
        *res, iters = go(*row_arrays, iters=True, **fixed)
        s.set(iters=int(iters.astype(np.int64).sum()))
        if operand_builds:
            built = depth_operands_device.launches - before
            s.set(device_operands=int(built == operand_builds))
        return tuple(res)


def make_batched_eval(g, use_ref: bool = False, max_iters: int = 64,
                      with_times: bool = False, device=None,
                      mesh=None, with_bram: bool = True) -> Callable:
    """Build the batched evaluation closure for a graph (raw or condensed:
    the condensation offsets ride the shared operands).

    ``call(depths) -> (lat f32, bram i32, status i8)`` as numpy arrays,
    plus the (C, E_pad) final times (f32) with ``with_times``; without
    ``with_bram`` (the escalation tier, which reads no BRAM count)
    ``(lat, status)``, the count computed by the epilogue all the same.
    ``device=None`` means ``cuda``.  ``mesh`` (a
    :class:`repro_torch.launch.mesh.Mesh`) shards the rows over its
    devices instead, the operands copied once to each distinct device; the
    row count must then be a multiple of ``mesh.size``.
    """
    max_iters = int(max_iters)
    devs = _devices(device, mesh)
    opses = {d: get_operands(g, d) for d in devs}
    inner = fifo_eval_plain if use_ref else fifo_eval

    def run(dev, depth_matrix, upload):
        ops = opses[dev]
        with obs.span("launch.operands"):
            depths = upload(depth_matrix, dev)
            rd_lat_e, bp_idx, bp_valid, bp_base, structural = \
                depth_operands(ops, depths)
        with obs.span("launch.kernel"):
            out, times = inner(ops.delta, ops.seg_start, ops.is_read,
                               ops.has_data, ops.data_idx, ops.end_bonus,
                               rd_lat_e, bp_idx, bp_valid, bp_base,
                               max_iters=max_iters, bound=ops.bound,
                               with_times=with_times)
        packed = eval_epilogue(out, structural, depths, ops.widths,
                               ops.taskless_lat)
        return (packed, times) if with_times else (packed,)

    def answer(packed, times=None, iters=False):
        lat, bram, status, it, _ = unpack(packed)
        res = (lat, bram, status) if with_bram else (lat, status)
        if with_times:
            res += (times,)
        return res + (it,) if iters else res

    go = _packed_over(run, answer, device, mesh, "batched")
    builds = 1 if mesh is None else len(mesh.devices)

    def call(depth_matrix: np.ndarray) -> Tuple[np.ndarray, ...]:
        DISPATCH_COUNTS["batched"] += 1
        return _launch("launch.k2", go, depth_matrix, operand_builds=builds)

    return call


def make_condensed_eval(cg, max_iters: int = 64, with_times: bool = False,
                        device=None, mesh=None) -> Optional[Callable]:
    """Build the FUSED condensed evaluation closure for a CondensedGraph.

    One K1 launch per batch (per shard under ``mesh``) evaluates the
    condensed fixpoint AND the exactness certificate, returning
    ``call(depths) -> (lat, bram, status, cert)`` (numpy) — ``cert`` is
    the per-row pass/fail mask with ``verify_rows`` semantics, True only
    on CONVERGED rows, so the rung cascade accepts/escalates rows without
    the event-time matrix ever leaving the device.  Returns None when the
    graph has no expressible certificate tables (the caller keeps the
    host verifier).  ``mesh`` as in :func:`make_batched_eval`.
    """
    devs = _devices(device, mesh)
    opses = {d: get_operands(cg, d) for d in devs}
    cts = {d: get_cert_tables(cg, d) for d in devs}
    if cts[devs[0]] is None:
        return None
    max_iters = int(max_iters)

    def run(dev, depth_matrix, upload):
        ops, ct = opses[dev], cts[dev]
        with obs.span("launch.operands"):
            depths = upload(depth_matrix, dev)
            rd_lat_e, bp_idx, bp_valid, bp_base, structural = \
                depth_operands(ops, depths)
            csrc, cdst, cthr, cval = cert_row_operands(ops, ct, depths)
        with obs.span("launch.kernel"):
            out, times = fifo_eval_condensed(
                ops.delta, ops.seg_start, ops.is_read, ops.has_data,
                ops.data_idx, ops.end_bonus, rd_lat_e, bp_idx, bp_valid,
                bp_base, csrc, cdst, cthr, cval, max_iters=max_iters,
                bound=ops.bound, with_times=with_times)
        packed = eval_epilogue(out, structural, depths, ops.widths,
                               ops.taskless_lat)
        return (packed, times) if with_times else (packed,)

    def answer(packed, times=None, iters=False):
        lat, bram, status, it, cert = unpack(packed)
        res = (lat, bram, status, cert)
        if with_times:
            res += (times,)
        return res + (it,) if iters else res

    go = _packed_over(run, answer, device, mesh, "condensed")
    builds = 1 if mesh is None else len(mesh.devices)

    def call(depth_matrix: np.ndarray) -> Tuple[np.ndarray, ...]:
        DISPATCH_COUNTS["condensed"] += 1
        return _launch("launch.k1", go, depth_matrix, operand_builds=builds)

    return call


def make_hetero_batched_eval(max_iters: int = 64, device=None,
                             mesh=None, with_bram: bool = True) -> Callable:
    """Build the CROSS-DESIGN batched evaluation closure.

    ``call(tables, table_of_row, depths) -> (latency i64, bram i64,
    status i8)`` (numpy), ``(latency, status)`` without ``with_bram``:
    ``tables`` a :class:`~repro_torch.core.backends
    .operands.HeteroTables`, ``table_of_row`` (C,) and ``depths`` (C, F*)
    numpy, as :func:`~repro_torch.core.backends.operands.stack_rows` makes
    them.  Every row reads its own design's tables, so one launch mixes
    rows of many graphs: K2 in its per-design-table mode on a CUDA
    device, the plain ``fifo_eval_ref_hetero`` on the CPU.
    ``device=None`` means ``cuda``.  ``mesh`` shards the rows over its
    devices (``table_of_row`` is sliced with them), with the tables
    copied once to each distinct device that does not hold them; the row
    count must then be a multiple of ``mesh.size``.
    """
    max_iters = int(max_iters)
    copies: dict = {}                   # device -> (tables, its copy)

    def tables_on(tables: HeteroTables, dev) -> HeteroTables:
        here = tables.bound.device
        if here == dev or (dev.index is None and here.type == dev.type):
            return tables
        hit = copies.get(dev)
        if hit is None or hit[0] is not tables:
            hit = copies[dev] = (tables, dataclasses.replace(tables, **{
                f.name: getattr(tables, f.name).to(dev)
                for f in dataclasses.fields(tables)
                if isinstance(getattr(tables, f.name), torch.Tensor)}))
        return hit[1]

    def run(dev, table_of_row, depth_matrix, tables, iters=False):
        with obs.span("launch.operands"):
            tables = tables_on(tables, dev)
            tor = _rows(table_of_row, dev)
            depths = _rows(depth_matrix, dev)
            idx = tor.long()
            rd_lat_e, bp_idx, bp_valid, structural, w = \
                hetero_depth_operands(tables, idx, depths)
            bounds = tables.bound[idx]
        with obs.span("launch.kernel"):
            out, _ = fifo_eval_hetero(
                tables.delta, tables.seg_start, tables.is_read,
                tables.has_data, tables.data_idx, tables.end_bonus,
                rd_lat_e, bp_idx, bp_valid, table_of_row=tor,
                bounds=bounds, max_iters=max_iters)
        lat = torch.maximum(out[:, 0], tables.taskless[idx])
        status = _status(out, structural)
        bram = (bram_count_torch(depths, w).sum(dim=1, dtype=torch.int32),
                ) if with_bram else ()
        res = (lat, *bram, status)
        if iters:
            res += (out[:, ITERS_LANE],)
        return res

    go = _over(run, device, mesh, "hetero")

    def call(tables: HeteroTables, table_of_row: np.ndarray,
             depth_matrix: np.ndarray) -> Tuple[np.ndarray, ...]:
        DISPATCH_COUNTS["hetero"] += 1
        res = _launch("launch.k2_hetero", go, table_of_row, depth_matrix,
                      tables=tables)
        lat = np.asarray(np.rint(res[0]), dtype=np.int64)
        if not with_bram:
            return lat, res[1]
        return lat, np.asarray(res[1], dtype=np.int64), res[2]

    return call
