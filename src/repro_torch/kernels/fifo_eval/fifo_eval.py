"""K2 wrapper: batched fixpoint over the full event stream.

``fifo_eval`` launches the CUDA kernel (``csrc/fifo_eval.cu``, one thread
block per config row) on CUDA tensors, and runs the plain torch version
(:func:`repro_torch.kernels.fifo_eval.ref.fifo_eval_plain`) on CPU tensors.
On any other device, or on inputs the kernel does not take, it raises.

Output layout (float32, one row per config):
    [0] latency   [1] converged (0/1)   [2] over-bound (0/1)   [3] iters
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.fifo_eval import build
from repro_torch.kernels.fifo_eval.ref import fifo_eval_plain

#: largest padded event count the kernel takes (1024 threads x 32 events;
#: the row's times must fit one block's shared memory)
MAX_E_PAD = 32768
OUT_LANES = 4

_SHARED_F32 = ("delta", "segst", "is_read", "has_data", "end_bonus")
_ROW_F32 = ("rd_lat", "bp_valid", "bp_base")


def check_operands(e_pad: int, shared: dict, row: dict,
                   device: torch.device) -> None:
    """Raise on anything the kernels do not take: device, dtype, shape,
    contiguity, and ``e_pad`` beyond :data:`MAX_E_PAD`."""
    if e_pad > MAX_E_PAD:
        raise ValueError(f"e_pad {e_pad} exceeds the kernel's {MAX_E_PAD}")
    for name, (x, dtype, shape) in {**shared, **row}.items():
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, not {device}")
        if x.dtype != dtype:
            raise ValueError(f"{name} is {x.dtype}, expected {dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def fifo_eval(delta, segst, is_read, has_data, data_idx, end_bonus,
              rd_lat, bp_idx, bp_valid, bp_base, *, max_iters: int,
              bound: float, with_times: bool = False
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Shared operands (1, E_pad), per-config operands (C, E_pad).
    Returns (C, 4) float32 rows, plus the final (C, E_pad) times when
    ``with_times`` (else None)."""
    dev = rd_lat.device
    if dev.type == "cpu":
        return fifo_eval_plain(delta, segst, is_read, has_data, data_idx,
                               end_bonus, rd_lat, bp_idx, bp_valid, bp_base,
                               max_iters=max_iters, bound=bound,
                               with_times=with_times)
    if dev.type != "cuda":
        raise ValueError(f"fifo_eval runs on cuda or cpu tensors, not {dev}")
    C, e_pad = rd_lat.shape
    f32, i32 = torch.float32, torch.int32
    shared = {n: (x, f32, (1, e_pad)) for n, x in zip(
        _SHARED_F32, (delta, segst, is_read, has_data, end_bonus))}
    shared["data_idx"] = (data_idx, i32, (1, e_pad))
    row = {n: (x, f32, (C, e_pad))
           for n, x in zip(_ROW_F32, (rd_lat, bp_valid, bp_base))}
    row["bp_idx"] = (bp_idx, i32, (C, e_pad))
    check_operands(e_pad, shared, row, dev)
    out = torch.empty((C, OUT_LANES), dtype=f32, device=dev)
    times = (torch.empty((C, e_pad), dtype=f32, device=dev)
             if with_times else None)
    if C == 0:
        return out, times
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fifo_eval_launch(
            _ptr(delta), _ptr(segst), _ptr(is_read), _ptr(has_data),
            _ptr(data_idx), _ptr(end_bonus), _ptr(rd_lat), _ptr(bp_idx),
            _ptr(bp_valid), _ptr(bp_base), _ptr(out), _ptr(times),
            C, e_pad, int(max_iters), float(bound), stream)
    build.check(rc, "fifo_eval")
    fifo_eval.launches += 1
    return out, times


#: kernel launches so far (a plain count; reset it by assigning 0)
fifo_eval.launches = 0
