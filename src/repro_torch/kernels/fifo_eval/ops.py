"""Batched evaluation closures around the fifo_eval kernels.

Consumes the shared padded event tensors from
:mod:`repro_torch.core.backends.operands` (built once per graph and device)
and exposes callables ``(C, F) int depths -> numpy results``.  The
depth-dependent per-config operands come from the shared
:func:`~repro_torch.core.backends.operands.depth_operands`; only the
fixpoint differs between inners:

``use_ref=False``  K2, :func:`repro_torch.kernels.fifo_eval.fifo_eval
                   .fifo_eval` (the CUDA kernel on CUDA tensors, its plain
                   version on CPU tensors)
``use_ref=True``   the plain torch fixpoint (:mod:`.ref`), which is the
                   ``fixpoint`` backend

:func:`make_hetero_batched_eval` is the cross-design closure: rows of many
graphs in one K2 launch in its per-design-table mode (the plain
``fifo_eval_ref_hetero`` on the CPU).
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.backends.base import (CONVERGED, DEADLOCK, UNRESOLVED,
                                            resolve_device)
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
from repro_torch.kernels.fifo_eval.ref import fifo_eval_plain

#: dispatches per closure kind ("batched" / "hetero" / "condensed").  The
#: cascade device-residency test asserts that a fully-certifying batch
#: costs exactly ONE "condensed" dispatch and never touches the host
#: verifier.
DISPATCH_COUNTS: Counter = Counter()


def _status(out: torch.Tensor, structural: torch.Tensor) -> torch.Tensor:
    """DEADLOCK on structural deadlock or over the bound, else CONVERGED
    or UNRESOLVED (int8)."""
    conv = out[:, 1] > 0
    over = out[:, 2] > 0
    dead = torch.full_like(structural, DEADLOCK, dtype=torch.int8)
    return torch.where(
        structural | over, dead,
        torch.where(conv, torch.full_like(dead, CONVERGED),
                    torch.full_like(dead, UNRESOLVED)))


def _numpy(*xs) -> Tuple[np.ndarray, ...]:
    return tuple(x.cpu().numpy() for x in xs)


def make_batched_eval(g, use_ref: bool = False, max_iters: int = 64,
                      with_times: bool = False, device=None) -> Callable:
    """Build the batched evaluation closure for a graph (raw or condensed:
    the condensation offsets ride the shared operands).

    ``call(depths) -> (lat f32, bram i32, status i8)`` as numpy arrays,
    plus the (C, E_pad) final times (f32) with ``with_times``.
    ``device=None`` means ``cuda``.
    """
    max_iters = int(max_iters)
    dev = resolve_device(device)
    ops = get_operands(g, dev)
    inner = fifo_eval_plain if use_ref else fifo_eval

    def call(depth_matrix: np.ndarray) -> Tuple[np.ndarray, ...]:
        DISPATCH_COUNTS["batched"] += 1
        depths = torch.as_tensor(np.asarray(depth_matrix, dtype=np.int32),
                                 device=dev)
        rd_lat_e, bp_idx, bp_valid, bp_base, structural = depth_operands(
            ops, depths)
        out, times = inner(ops.delta, ops.seg_start, ops.is_read,
                           ops.has_data, ops.data_idx, ops.end_bonus,
                           rd_lat_e, bp_idx, bp_valid, bp_base,
                           max_iters=max_iters, bound=ops.bound,
                           with_times=with_times)
        lat = torch.clamp(out[:, 0], min=ops.taskless_lat)
        status = _status(out, structural)
        bram = bram_count_torch(depths, ops.widths[None, :]).sum(
            dim=1, dtype=torch.int32)
        if with_times:
            return _numpy(lat, bram, status, times)
        return _numpy(lat, bram, status)

    return call


def make_condensed_eval(cg, max_iters: int = 64, with_times: bool = False,
                        device=None) -> Optional[Callable]:
    """Build the FUSED condensed evaluation closure for a CondensedGraph.

    One K1 launch per batch evaluates the condensed fixpoint AND the
    exactness certificate, returning ``call(depths) -> (lat, bram,
    status, cert)`` (numpy) — ``cert`` is the per-row pass/fail mask with
    ``verify_rows`` semantics, True only on CONVERGED rows, so the rung
    cascade accepts/escalates rows without the event-time matrix ever
    leaving the device.  Returns None when the graph has no expressible
    certificate tables (the caller keeps the host verifier).
    """
    dev = resolve_device(device)
    ops = get_operands(cg, dev)
    ct = get_cert_tables(cg, dev)
    if ct is None:
        return None
    max_iters = int(max_iters)

    def call(depth_matrix: np.ndarray) -> Tuple[np.ndarray, ...]:
        DISPATCH_COUNTS["condensed"] += 1
        depths = torch.as_tensor(np.asarray(depth_matrix, dtype=np.int32),
                                 device=dev)
        rd_lat_e, bp_idx, bp_valid, bp_base, structural = depth_operands(
            ops, depths)
        csrc, cdst, cthr, cval = cert_row_operands(ops, ct, depths)
        out, times = fifo_eval_condensed(
            ops.delta, ops.seg_start, ops.is_read, ops.has_data,
            ops.data_idx, ops.end_bonus, rd_lat_e, bp_idx, bp_valid,
            bp_base, csrc, cdst, cthr, cval, max_iters=max_iters,
            bound=ops.bound, with_times=with_times)
        lat = torch.clamp(out[:, 0], min=ops.taskless_lat)
        status = _status(out, structural)
        # kernel cert = conv & ~over & no violated slot; a structurally
        # deadlocked row must additionally never certify
        cert = (out[:, 4] > 0) & (status == CONVERGED)
        bram = bram_count_torch(depths, ops.widths[None, :]).sum(
            dim=1, dtype=torch.int32)
        res = (lat, bram, status, cert)
        if with_times:
            res = res + (times,)
        return _numpy(*res)

    return call


def make_hetero_batched_eval(max_iters: int = 64, device=None,
                             mesh=None) -> Callable:
    """Build the CROSS-DESIGN batched evaluation closure.

    ``call(tables, table_of_row, depths) -> (latency i64, bram i64,
    status i8)`` (numpy): ``tables`` a :class:`~repro_torch.core.backends
    .operands.HeteroTables` on this closure's device, ``table_of_row``
    (C,) and ``depths`` (C, F*) numpy, as
    :func:`~repro_torch.core.backends.operands.stack_rows` makes them.
    Every row reads its own design's tables, so one launch mixes rows
    of many graphs: K2 in its per-design-table mode on a CUDA device, the
    plain ``fifo_eval_ref_hetero`` on the CPU.  ``device=None`` means
    ``cuda``.  ``mesh`` (row sharding over devices) is ROADMAP P11.
    """
    if mesh is not None:
        raise NotImplementedError(
            "hetero row sharding over devices is not ported yet: ROADMAP "
            "P11 (multi-device row sharding)")
    max_iters = int(max_iters)
    dev = resolve_device(device)

    def call(tables: HeteroTables, table_of_row: np.ndarray,
             depth_matrix: np.ndarray
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        DISPATCH_COUNTS["hetero"] += 1
        tor = torch.as_tensor(np.asarray(table_of_row, dtype=np.int32),
                              device=dev)
        depths = torch.as_tensor(np.asarray(depth_matrix, dtype=np.int32),
                                 device=dev)
        idx = tor.long()
        rd_lat_e, bp_idx, bp_valid, structural, w = hetero_depth_operands(
            tables, idx, depths)
        out, _ = fifo_eval_hetero(
            tables.delta, tables.seg_start, tables.is_read,
            tables.has_data, tables.data_idx, tables.end_bonus, rd_lat_e,
            bp_idx, bp_valid, table_of_row=tor, bounds=tables.bound[idx],
            max_iters=max_iters)
        lat = torch.maximum(out[:, 0], tables.taskless[idx])
        status = _status(out, structural)
        bram = bram_count_torch(depths, w).sum(dim=1, dtype=torch.int32)
        lat, bram, status = _numpy(lat, bram, status)
        return (np.asarray(np.rint(lat), dtype=np.int64),
                np.asarray(bram, dtype=np.int64), status)

    return call
