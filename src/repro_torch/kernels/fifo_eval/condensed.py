"""K1 wrapper: fused condensed evaluation + exactness certificate.

``fifo_eval_condensed`` launches the CUDA kernel (``csrc/condensed.cu``,
one thread block per config row) on CUDA tensors, and runs the plain torch
version (:func:`repro_torch.kernels.fifo_eval.ref
.fifo_eval_condensed_plain`) on CPU tensors.  On any other device, or on
inputs the kernel does not take, it raises.

The kernel evaluates the condensed fixpoint with per-row freezing and then
checks every folded cross constraint as a flat gather slot
(``t[src] - t[dst] > thr``, see :func:`repro_torch.core.backends.operands
.cert_row_operands`), so the event times never leave the device and a
fully certifying batch is one launch.

Output layout (float32, one row per config):
    [0] latency  [1] converged  [2] over-bound  [3] iters  [4] certified
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.fifo_eval import build
from repro_torch.kernels.fifo_eval.fifo_eval import (_ROW_F32, _SHARED_F32,
                                                     _ptr, check_operands)
from repro_torch.kernels.fifo_eval.ref import fifo_eval_condensed_plain

OUT_LANES = 5


def fifo_eval_condensed(delta, segst, is_read, has_data, data_idx,
                        end_bonus, rd_lat, bp_idx, bp_valid, bp_base,
                        cert_src, cert_dst, cert_thr, cert_valid, *,
                        max_iters: int, bound: float,
                        with_times: bool = False
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Shared operands (1, E_pad), per-config operands (C, E_pad),
    certificate slots (C, V_pad).  Returns (C, 5) float32 rows, plus the
    final (C, E_pad) times when ``with_times`` (else None)."""
    dev = rd_lat.device
    if dev.type == "cpu":
        return fifo_eval_condensed_plain(
            delta, segst, is_read, has_data, data_idx, end_bonus, rd_lat,
            bp_idx, bp_valid, bp_base, cert_src, cert_dst, cert_thr,
            cert_valid, max_iters=max_iters, bound=bound,
            with_times=with_times)
    if dev.type != "cuda":
        raise ValueError(
            f"fifo_eval_condensed runs on cuda or cpu tensors, not {dev}")
    C, e_pad = rd_lat.shape
    v_pad = cert_src.shape[1]
    f32, i32 = torch.float32, torch.int32
    shared = {n: (x, f32, (1, e_pad)) for n, x in zip(
        _SHARED_F32, (delta, segst, is_read, has_data, end_bonus))}
    shared["data_idx"] = (data_idx, i32, (1, e_pad))
    row = {n: (x, f32, (C, e_pad))
           for n, x in zip(_ROW_F32, (rd_lat, bp_valid, bp_base))}
    row["bp_idx"] = (bp_idx, i32, (C, e_pad))
    row.update(cert_src=(cert_src, i32, (C, v_pad)),
               cert_dst=(cert_dst, i32, (C, v_pad)),
               cert_thr=(cert_thr, f32, (C, v_pad)),
               cert_valid=(cert_valid, f32, (C, v_pad)))
    check_operands(e_pad, shared, row, dev)
    out = torch.empty((C, OUT_LANES), dtype=f32, device=dev)
    times = (torch.empty((C, e_pad), dtype=f32, device=dev)
             if with_times else None)
    if C == 0:
        return out, times
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fifo_eval_condensed_launch(
            _ptr(delta), _ptr(segst), _ptr(is_read), _ptr(has_data),
            _ptr(data_idx), _ptr(end_bonus), _ptr(rd_lat), _ptr(bp_idx),
            _ptr(bp_valid), _ptr(bp_base), _ptr(cert_src), _ptr(cert_dst),
            _ptr(cert_thr), _ptr(cert_valid), _ptr(out), _ptr(times),
            C, e_pad, v_pad, int(max_iters), float(bound), stream)
    build.check(rc, "fifo_eval_condensed")
    fifo_eval_condensed.launches += 1
    return out, times


#: kernel launches so far (a plain count; reset it by assigning 0)
fifo_eval_condensed.launches = 0
