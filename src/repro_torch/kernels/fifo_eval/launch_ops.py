"""The two kernels around each K2 and K1 launch (``csrc/launch_ops.cu``).

``depth_operands_device(ops, depths)``
    What :func:`repro_torch.core.backends.operands.depth_operands_plain`
    computes, in one launch on a CUDA device: the (C, E_pad) read
    latencies, back-pressure gather indices, masks and adds, and the (C,)
    structural-deadlock flag.
    :func:`~repro_torch.core.backends.operands.depth_operands` calls it for
    CUDA tensors.

``eval_epilogue(out, structural, depths, widths, taskless_lat)``
    K2's (C, 4) or K1's (C, 5) output -> one packed (C, lanes) int32
    result: [:data:`LAT`] the latency clamped below at ``taskless_lat``
    (float32 bits), [:data:`BRAM`] the BRAM18K count of the row,
    [:data:`STATUS`] CONVERGED / DEADLOCK / UNRESOLVED, [:data:`ITERS`] the
    iterations (float32 bits) and, for K1, [:data:`CERT`] the certificate
    (1 only on CONVERGED rows).  The kernel on CUDA tensors,
    :func:`eval_epilogue_plain` on CPU tensors; :func:`unpack` reads the
    packed rows back as numpy.

Neither replaces a TPU kernel: the reference package leaves this work to
XLA around its Pallas call.  In eager PyTorch it was about 60 operator
launches a call, more host time than K2's device time (PERF.md); each
kernel here is one launch of a few microseconds.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.backends.base import CONVERGED, DEADLOCK, UNRESOLVED
from repro_torch.core.backends.operands import (GraphOperands,
                                                bram_count_torch)
from repro_torch.kernels.fifo_eval import build
from repro_torch.kernels.fifo_eval.fifo_eval import _ptr, check_operands

#: the lanes of a packed result (:data:`CERT` on K1's only)
LAT, BRAM, STATUS, ITERS, CERT = range(5)

_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool


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


def _cuda(x: torch.Tensor, what: str) -> torch.device:
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on cuda tensors, not {dev}")
    return dev


def depth_operands_device(ops: GraphOperands, depths: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """``(rd_lat_e, bp_idx, bp_valid, bp_base, structural)`` for the
    (C, F) integer ``depths`` on a CUDA device, from one launch of the
    depth-operand kernel; bit for bit what
    :func:`~repro_torch.core.backends.operands.depth_operands_plain`
    returns."""
    dev = _cuda(depths, "depth_operands_device")
    depths = depths.to(_I32).contiguous()
    C, F = depths.shape
    if F != ops.n_fifos:
        raise ValueError(f"depths have {F} columns, the graph "
                         f"{ops.n_fifos} FIFOs")
    e, r = (ops.e_pad,), (ops.n_flat_reads,)
    check_operands(ops.e_pad, {
        "depths": (depths, _I32, (C, F)), "widths": (ops.widths, _I32, (F,)),
        "fifo": (ops.fifo, _I32, e), "rank": (ops.rank, _I32, e),
        "is_write": (ops.is_write, _BOOL, e),
        "evt_n_reads": (ops.evt_n_reads, _I32, e),
        "evt_read_base": (ops.evt_read_base, _I32, e),
        "read_evt_flat": (ops.read_evt_flat, _I32, r),
        "read_off_flat": (ops.read_off_flat, _F32, r),
        "data_off": (ops.data_off, _F32, e)}, {}, dev)
    shape = (C, ops.e_pad)
    rd_lat = torch.empty(shape, dtype=_F32, device=dev)
    bp_idx = torch.empty(shape, dtype=_I32, device=dev)
    bp_valid = torch.empty(shape, dtype=_F32, device=dev)
    bp_base = torch.empty(shape, dtype=_F32, device=dev)
    structural = torch.empty((C,), dtype=_BOOL, device=dev)
    if C:
        lib = build.load()
        with torch.cuda.device(dev):
            rc = lib.depth_operands_launch(
                _ptr(depths), _ptr(ops.widths), _ptr(ops.fifo),
                _ptr(ops.rank), _ptr(ops.is_write), _ptr(ops.evt_n_reads),
                _ptr(ops.evt_read_base), _ptr(ops.read_evt_flat),
                _ptr(ops.read_off_flat), _ptr(ops.data_off), _ptr(rd_lat),
                _ptr(bp_idx), _ptr(bp_valid), _ptr(bp_base),
                _ptr(structural), C, F, ops.e_pad, ops.n_flat_reads,
                torch.cuda.current_stream(dev).cuda_stream)
        build.check(rc, "depth_operands")
        depth_operands_device.launches += 1
    return rd_lat, bp_idx, bp_valid, bp_base, structural


def eval_epilogue_plain(out: torch.Tensor, structural: torch.Tensor,
                        depths: torch.Tensor, widths: torch.Tensor,
                        taskless_lat: float) -> torch.Tensor:
    """The packed (C, lanes) int32 result, in plain torch ops."""
    lat = torch.clamp(out[:, 0], min=taskless_lat)
    status = _status(out, structural)
    bram = bram_count_torch(depths, widths[None, :]).sum(dim=1,
                                                         dtype=_I32)
    lanes = [lat.view(_I32), bram, status.to(_I32),
             out[:, ITERS].contiguous().view(_I32)]
    if out.shape[1] > CERT:
        # K1's certificate (converged, under the bound, no slot violated),
        # and never on a row that deadlocks structurally
        lanes.append(((out[:, CERT] > 0) & (status == CONVERGED)).to(_I32))
    return torch.stack(lanes, dim=1)


def eval_epilogue(out: torch.Tensor, structural: torch.Tensor,
                  depths: torch.Tensor, widths: torch.Tensor,
                  taskless_lat: float) -> torch.Tensor:
    """K2's (C, 4) or K1's (C, 5) float32 output, the (C,) structural
    flag, the (C, F) int32 depths and (F,) int32 widths -> the packed
    (C, lanes) int32 result: one launch of the epilogue kernel on CUDA
    tensors, :func:`eval_epilogue_plain` on CPU tensors."""
    if out.device.type == "cpu":
        return eval_epilogue_plain(out, structural, depths, widths,
                                   taskless_lat)
    dev = _cuda(out, "eval_epilogue")
    C, lanes = out.shape
    if lanes not in (ITERS + 1, CERT + 1):
        raise ValueError(f"eval_epilogue takes 4 or 5 output lanes, not "
                         f"{lanes}")
    F = widths.shape[0]
    check_operands(0, {
        "out": (out, _F32, (C, lanes)),
        "structural": (structural, _BOOL, (C,)),
        "depths": (depths, _I32, (C, F)),
        "widths": (widths, _I32, (F,))}, {}, dev)
    packed = torch.empty((C, lanes), dtype=_I32, device=dev)
    if C:
        lib = build.load()
        with torch.cuda.device(dev):
            rc = lib.eval_epilogue_launch(
                _ptr(out), _ptr(structural), _ptr(depths), _ptr(widths),
                _ptr(packed), C, lanes, F, float(taskless_lat),
                torch.cuda.current_stream(dev).cuda_stream)
        build.check(rc, "eval_epilogue")
        eval_epilogue.launches += 1
    return packed


def unpack(packed: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                        np.ndarray, Optional[np.ndarray]]:
    """A packed (C, lanes) int32 result as numpy ``(lat f32, bram i32,
    status i8, iters f32, cert bool or None)``, each an array of its
    own."""
    lat = packed[:, LAT].copy().view(np.float32)
    iters = packed[:, ITERS].copy().view(np.float32)
    cert = packed[:, CERT].astype(bool) if packed.shape[1] > CERT else None
    return (lat, packed[:, BRAM].copy(), packed[:, STATUS].astype(np.int8),
            iters, cert)


#: launches so far (plain counts; reset them by assigning 0)
depth_operands_device.launches = 0
eval_epilogue.launches = 0
