"""Batched evaluation closures around the fifo_eval kernels: callables
``(C, F) int depths -> numpy results`` over the shared padded event
tensors of :mod:`repro_torch.core.backends.operands` (built once per graph
and device).

The three factories are thin calls into one function, :func:`_closure`.
They differ in three steps a device: the depth-dependent operands, the
kernel, and the packer of one (C, lanes) int32 array that
:func:`~repro_torch.kernels.fifo_eval.launch_ops.unpack` reads (latency
bits, BRAM, status, iteration bits, K1's certificate):

``make_batched_eval``  K2 (the CUDA kernel on CUDA tensors, its plain
    version on CPU tensors; with ``use_ref`` the plain torch fixpoint of
    :mod:`.ref`, the ``fixpoint`` backend) over ``depth_operands``,
    packed by ``eval_epilogue``; ``make_condensed_eval`` the same for K1
``make_hetero_batched_eval``  rows of many graphs in one K2 launch in its
    per-design-table mode over ``hetero_depth_operands``, packed by torch
    ops (the plain ``fifo_eval_ref_hetero`` on the CPU)

A call is one path: the row arrays go up, every device runs its three
steps, and every device's packed rows come back with one wait.  A lone
device is a mesh of one.  A CUDA device, alone or a shard, copies through
pinned buffers of its own, the CPU pageable (:class:`_Stage`).  Under
``mesh=`` (:mod:`repro_torch.launch.mesh`) the rows are split into
contiguous blocks, one a shard, all launched before any is read back.

Each call is one :mod:`repro_torch.obs` span, ``launch.k2``, ``launch.k1``
or ``launch.k2_hetero`` (``rows``: the rows launched, padding included;
``iters``: the iterations they ran, summed; on ``launch.k2`` and
``launch.k1``, ``device_operands``: 1 where the depth-operand kernel built
the launch's operands, read from its launch count), around the whole host
path.  Its children, once a shard, are ``launch.operands`` (the upload and
the operands), ``launch.kernel`` (the kernel call, which enqueues it on a
CUDA device) and ``launch.readback`` (the copy back, which waits).
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


def _shards(device, mesh) -> Tuple[torch.device, ...]:
    """The device of each shard: the mesh's, or the one device."""
    if mesh is None:
        return (resolve_device(device),)
    return tuple(torch.device(d) for d in mesh.devices)


class _Stage:
    """The copies of one shard of a closure: pageable on the CPU; on a
    CUDA device through pinned host buffers, each grown to the largest
    batch seen, and one wait a readback, so the next call finds them free
    (a closure is called from one thread at a time; the service is one
    asyncio loop)."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.pinned = dev.type == "cuda"
        self._bufs: dict = {}

    def _buf(self, key, shape) -> torch.Tensor:
        buf = self._bufs.get(key)
        if buf is None or buf.shape[0] < shape[0] or \
                buf.shape[1:] != shape[1:]:
            buf = self._bufs[key] = torch.empty(shape, dtype=torch.int32,
                                                pin_memory=True)
        return buf[:shape[0]]

    def upload(self, *arrays: np.ndarray) -> Tuple[torch.Tensor, ...]:
        """The row arrays as int32 on the device, copied without a wait."""
        if not self.pinned:
            return tuple(torch.as_tensor(np.asarray(a, dtype=np.int32),
                                         device=self.dev) for a in arrays)
        out = []
        for i, a in enumerate(arrays):
            buf = self._buf(i, a.shape)
            buf.numpy()[...] = a
            out.append(buf.to(self.dev, non_blocking=True))
        return tuple(out)

    def readback(self, packed: torch.Tensor, times: Optional[torch.Tensor]
                 ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """The packed rows (a view of the buffer until the next call) and
        the times (pageable) as numpy, after one wait."""
        with obs.span("launch.readback"):
            if self.pinned:
                packed = self._buf("packed", packed.shape).copy_(
                    packed, non_blocking=True)
            t = None if times is None else times.cpu().numpy()
            if self.pinned:
                torch.cuda.current_stream(self.dev).synchronize()
            return packed.numpy(), t


def _closure(kind: str, name: str, devs: Tuple[torch.device, ...],
             sharded: bool, operands: Callable, kernel: Callable,
             pack: Callable, count_operands: bool) -> Callable:
    """``call(*row_arrays, **fixed) -> (lat f32, bram i32, status i8[,
    cert bool][, times f32])`` as numpy, in the span ``name``: on shard
    ``i`` (``devs[i]``) the ``i``-th contiguous block of every row array,
    staged up, goes through ``x = operands(dev, *rows, **fixed)``, ``out,
    times = kernel(x)`` and ``pack(x, out)``.  The row count must be a
    multiple of the shard count.  A call counts in :data:`DISPATCH_COUNTS`
    under ``kind``, each shard of a ``sharded`` one also under
    ``"<kind>@shard<i>"``; ``count_operands`` sets ``device_operands``."""
    stages = [_Stage(d) for d in devs]
    k = len(stages)

    def call(*row_arrays, **fixed):
        DISPATCH_COUNTS[kind] += 1
        with obs.span(name, rows=int(row_arrays[-1].shape[0])) as s:
            before = depth_operands_device.launches
            c = row_arrays[0].shape[0]
            if c % k:
                raise ValueError(f"{c} rows do not split over {k} shards; "
                                 f"pad the batch to a multiple of the mesh "
                                 f"size")
            b = c // k
            outs = []
            for i, stage in enumerate(stages):
                if sharded:
                    DISPATCH_COUNTS[f"{kind}@shard{i}"] += 1
                with obs.span("launch.operands"):
                    x = operands(stage.dev, *stage.upload(
                        *(a[i * b:(i + 1) * b] for a in row_arrays)), **fixed)
                with obs.span("launch.kernel"):
                    out, times = kernel(x)
                outs.append((pack(x, out), times))
            packed, times = zip(*(st.readback(*o)
                                  for st, o in zip(stages, outs)))
            lat, bram, status, iters, cert = unpack(_cat(packed))
            if s:
                s.set(iters=int(iters.astype(np.int64).sum()))
                if count_operands:
                    built = depth_operands_device.launches - before
                    s.set(device_operands=int(built == k))
        times = None if times[0] is None else _cat(times)
        return tuple(x for x in (lat, bram, status, cert, times)
                     if x is not None)

    return call


def _cat(parts) -> np.ndarray:
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


def _epilogue(x, out: torch.Tensor) -> torch.Tensor:
    """K2's and K1's packer over ``(ops, depths, depth operands, ...)``."""
    ops, depths, d = x[:3]
    return eval_epilogue(out, d[4], depths, ops.widths, ops.taskless_lat)


def make_batched_eval(g, use_ref: bool = False, max_iters: int = 64,
                      with_times: bool = False, device=None,
                      mesh=None) -> Callable:
    """Build the batched evaluation closure for a graph (raw or condensed:
    the condensation offsets ride the shared operands).

    ``call(depths) -> (lat f32, bram i32, status i8)`` as numpy arrays,
    plus the (C, E_pad) final times (f32) with ``with_times``.
    ``device=None`` means ``cuda``.  ``mesh`` (a
    :class:`repro_torch.launch.mesh.Mesh`) shards the rows over its
    devices instead, the operands copied once to each distinct device; the
    row count must then be a multiple of ``mesh.size``.
    """
    max_iters = int(max_iters)
    devs = _shards(device, mesh)
    opses = {d: get_operands(g, d) for d in dict.fromkeys(devs)}
    inner = fifo_eval_plain if use_ref else fifo_eval

    def operands(dev, depths):
        return opses[dev], depths, depth_operands(opses[dev], depths)

    def kernel(x):
        ops, _, (rd_lat_e, bp_idx, bp_valid, bp_base, _) = x
        return inner(ops.delta, ops.seg_start, ops.is_read, ops.has_data,
                     ops.data_idx, ops.end_bonus, rd_lat_e, bp_idx,
                     bp_valid, bp_base, max_iters=max_iters,
                     bound=ops.bound, with_times=with_times)

    return _closure("batched", "launch.k2", devs, mesh is not None,
                    operands, kernel, _epilogue, True)


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
    devs = _shards(device, mesh)
    opses = {d: get_operands(cg, d) for d in dict.fromkeys(devs)}
    cts = {d: get_cert_tables(cg, d) for d in opses}
    if cts[devs[0]] is None:
        return None
    max_iters = int(max_iters)

    def operands(dev, depths):
        ops = opses[dev]
        return (ops, depths, depth_operands(ops, depths),
                cert_row_operands(ops, cts[dev], depths))

    def kernel(x):
        ops, _, d, cert = x
        return fifo_eval_condensed(
            ops.delta, ops.seg_start, ops.is_read, ops.has_data,
            ops.data_idx, ops.end_bonus, *d[:4], *cert, max_iters=max_iters,
            bound=ops.bound, with_times=with_times)

    return _closure("condensed", "launch.k1", devs, mesh is not None,
                    operands, kernel, _epilogue, True)


def make_hetero_batched_eval(max_iters: int = 64, device=None,
                             mesh=None) -> Callable:
    """Build the CROSS-DESIGN batched evaluation closure.

    ``call(tables, table_of_row, depths) -> (latency i64, bram i64,
    status i8)`` (numpy): ``tables`` a :class:`~repro_torch.core.backends
    .operands.HeteroTables`, ``table_of_row`` (C,) and ``depths`` (C, F*)
    numpy, as :func:`~repro_torch.core.backends.operands.stack_rows` makes
    them.  Every row reads its own design's tables, so one launch mixes
    rows of many graphs: K2 in its per-design-table mode on a CUDA
    device, the plain ``fifo_eval_ref_hetero`` on the CPU; the latency
    clamp, status and BRAM count are torch ops packed into the lanes of
    :func:`~repro_torch.kernels.fifo_eval.launch_ops.unpack`.
    ``device=None`` means ``cuda``.  ``mesh`` shards the rows over
    its devices (``table_of_row`` is sliced with them), with the tables
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

    def operands(dev, tor, depths, tables):
        tables = tables_on(tables, dev)
        idx = tor.long()
        return (tables, tor, idx, depths, tables.bound[idx],
                *hetero_depth_operands(tables, idx, depths))

    def kernel(x):
        tables, tor, _, _, bounds, rd_lat_e, bp_idx, bp_valid = x[:8]
        return fifo_eval_hetero(
            tables.delta, tables.seg_start, tables.is_read,
            tables.has_data, tables.data_idx, tables.end_bonus, rd_lat_e,
            bp_idx, bp_valid, table_of_row=tor, bounds=bounds,
            max_iters=max_iters)

    def pack(x, out):
        tables, _, idx, depths = x[:4]
        structural, w = x[8:]
        i32 = torch.int32
        lat = torch.maximum(out[:, 0], tables.taskless[idx])
        return torch.stack([
            lat.view(i32), bram_count_torch(depths, w).sum(dim=1, dtype=i32),
            _status(out, structural).to(i32),
            out[:, ITERS_LANE].contiguous().view(i32)], dim=1)

    go = _closure("hetero", "launch.k2_hetero", _shards(device, mesh),
                  mesh is not None, operands, kernel, pack, False)

    def call(tables: HeteroTables, table_of_row: np.ndarray,
             depth_matrix: np.ndarray) -> Tuple[np.ndarray, ...]:
        lat, bram, status = go(table_of_row, depth_matrix, tables=tables)
        return (np.asarray(np.rint(lat), dtype=np.int64),
                bram.astype(np.int64), status)

    return call
