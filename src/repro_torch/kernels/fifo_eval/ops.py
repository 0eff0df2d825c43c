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
"""

from __future__ import annotations

from collections import Counter
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.backends.base import (CONVERGED, DEADLOCK, UNRESOLVED,
                                            resolve_device)
from repro_torch.core.backends.operands import (bram_count_torch,
                                                cert_row_operands,
                                                depth_operands,
                                                get_cert_tables,
                                                get_operands)
from repro_torch.kernels.fifo_eval.condensed import fifo_eval_condensed
from repro_torch.kernels.fifo_eval.fifo_eval import fifo_eval
from repro_torch.kernels.fifo_eval.ref import fifo_eval_plain

#: dispatches per closure kind ("batched" / "condensed").  The cascade
#: device-residency test asserts that a fully-certifying batch costs
#: exactly ONE "condensed" dispatch and never touches the host verifier.
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
