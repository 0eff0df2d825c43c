"""K1 wrapper: fused condensed evaluation + exactness certificate.

``fifo_eval_condensed`` launches the CUDA kernel (``csrc/condensed.cu``) on
CUDA tensors, and runs the plain torch version
(:func:`repro_torch.kernels.fifo_eval.ref.fifo_eval_condensed_plain`) on
CPU tensors.  On any other device, or on inputs the kernel does not take,
it raises.

The kernel evaluates the condensed fixpoint with per-row freezing and then
checks every folded cross constraint as a flat gather slot
(``t[src] - t[dst] > thr``, see :func:`repro_torch.core.backends.operands
.cert_row_operands`), so the event times never leave the device and a
fully certifying batch is one launch.

Output layout (float32, one row per config):
    [0] latency  [1] converged  [2] over-bound  [3] iters  [4] certified

What bounds K1 on the H100: each fixpoint step is a chain of latencies on
a short row (128 to 3200 events), while the bytes are the certificate
slots' (16 a slot, 7 to 60 slots an event).  The design, in the launch
shape :class:`K1Shape` that :func:`k1_launch_shape` picks:

1. **Rows on warps.**  A row runs on a CTA of ``warps`` warps (one up to
   1024 events), ``k`` consecutive events a lane.  One warp needs
   shuffles only; several meet at the CTA's barrier.
2. **Operands folded once.**  Each lane loads its events' operands once,
   in 16-byte vectors, into a gather address, an add, a delta and a
   segment bit held in registers; only the times move, in shared memory.
3. **Certificate slots read wide.**  After the fixpoint the lanes stream
   the row's slots in 16-byte vectors, eight slots in flight a lane.
4. **Few rows spread.**  With ``split`` > 1 a row runs on a cluster of
   that many CTAs, each repeating the cheap fixpoint and checking one slice
   of the slots (:func:`k1_cert_slices`); the verdicts meet in the leader.
   The chooser spreads only while every row of the batch is resident in
   one wave (``cudaOccupancyMaxActiveClusters``) and the CTAs fit on the
   card's SMs.
"""

from __future__ import annotations

import functools
from typing import List, Mapping, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels.fifo_eval import build
from repro_torch.kernels.fifo_eval.fifo_eval import (_ROW_F32, _SHARED_F32,
                                                     _ptr, check_operands)
from repro_torch.kernels.fifo_eval.ref import fifo_eval_condensed_plain

OUT_LANES = 5

#: events per lane the kernel is built for
K1_EVENTS_PER_LANE = (4, 8, 12, 16, 20, 24, 28, 32)
#: threads of a CTA (the kernel's launch bound): up to 8 warps
MAX_CTA_WARPS = 8
#: largest padded event count K1 takes: 8 warps x 32 lanes x 32 events,
#: so that the folded operands fit in registers.  A fused rung is at least
#: 8x compressed (FUSED_MIN_COMPRESSION) from a raw stream of at most K2's
#: 32768 events, so it holds at most 4096.
K1_MAX_E_PAD = MAX_CTA_WARPS * 32 * 32
#: events one warp takes
WARP_EVENTS = 32 * 32
#: fewest slots a CTA of a spread row checks
MIN_SPLIT_SLOTS = 512
#: largest cluster K1 is built for (16 needs the non-portable size, which
#: the chooser uses only where the card reports clusters of it resident)
K1_MAX_SPLIT = 16


class K1Shape(NamedTuple):
    """K1's launch shape: a CTA of ``warps`` warps for each row, ``k``
    events per lane, ``split`` CTAs per row (a cluster; each checks one
    slice of the slots)."""
    warps: int
    k: int
    split: int


def k1_row_shape(e_pad: int) -> Tuple[int, int]:
    """``(warps, k)`` for a row of ``e_pad`` events: the fewest warps whose
    lanes hold 32 events each, then the fewest events a lane (a multiple
    of 4) that cover the row."""
    if not 0 < e_pad <= K1_MAX_E_PAD or e_pad % 4:
        raise ValueError(f"e_pad {e_pad} is not a multiple of 4 in "
                         f"(0, {K1_MAX_E_PAD}]")
    warps = -(-e_pad // WARP_EVENTS)
    k = -(-e_pad // (32 * warps))
    return warps, -(-k // 4) * 4


def k1_slice(v_pad: int, split: int) -> int:
    """Slots of each CTA's slice when a row's ``v_pad`` slots are cut into
    ``split`` slices: whole groups of four."""
    per_cta = -(-v_pad // split)
    return -(-per_cta // 4) * 4


def k1_cert_slices(v_pad: int, split: int) -> List[Tuple[int, int]]:
    """``[lo, hi)`` of the slots that each CTA of a row checks (the
    kernel's ``lo`` and ``n_slots``)."""
    s = k1_slice(v_pad, split)
    return [(min(r * s, v_pad), min(r * s + s, v_pad)) for r in range(split)]


def k1_splits(v_pad: int) -> Tuple[int, ...]:
    """Every ``split`` K1 can cut a row's slots into: 1, then powers of
    two up to :data:`K1_MAX_SPLIT` while each slice keeps
    :data:`MIN_SPLIT_SLOTS`."""
    out, s = [1], 2
    while s <= K1_MAX_SPLIT and k1_slice(v_pad, s) >= MIN_SPLIT_SLOTS:
        out.append(s)
        s *= 2
    return tuple(out)


def k1_shapes(e_pad: int, v_pad: int) -> Tuple[K1Shape, ...]:
    """Every shape K1 can run a row of ``e_pad`` events and ``v_pad``
    slots in: the row's :func:`k1_row_shape` at each split of
    :func:`k1_splits`."""
    warps, k = k1_row_shape(e_pad)
    return tuple(K1Shape(warps, k, s) for s in k1_splits(v_pad))


def k1_launch_shape(c: int, e_pad: int, v_pad: int,
                    active: Mapping[int, int], n_sms: int,
                    shape: Optional[K1Shape] = None) -> K1Shape:
    """K1's :class:`K1Shape` for ``c`` rows of ``e_pad`` events and
    ``v_pad`` certificate slots on a card of ``n_sms`` SMs.

    ``active[s]`` is how many clusters of ``s`` CTAs (one row each) the
    card holds at once; 0 or missing for a size it cannot launch.  The
    split is the largest of :func:`k1_splits` under which all ``c`` rows
    run in one wave (``c <= active[s]``) with a CTA to each SM
    (``c * s <= n_sms``); else 1.  ``shape`` forces a shape; it must be
    one of :func:`k1_shapes`."""
    if shape is not None:
        shape = K1Shape(*shape)
        if shape not in k1_shapes(e_pad, v_pad):
            raise ValueError(f"shape {shape} not allowed for "
                             f"e_pad={e_pad}, v_pad={v_pad}")
        return shape
    warps, k = k1_row_shape(e_pad)
    split = 1
    for s in k1_splits(v_pad)[1:]:
        if c <= active.get(s, 0) and c * s <= n_sms:
            split = s
    return K1Shape(warps, k, split)


@functools.lru_cache(maxsize=None)
def active_clusters(index: int, e_pad: int, v_pad: int, shape: K1Shape
                    ) -> int:
    """Clusters of ``shape`` (split > 1) that CUDA device ``index`` holds
    at once (0 when it cannot launch that size)."""
    with torch.cuda.device(index):
        n = build.load().fifo_eval_condensed_active(e_pad, v_pad, *shape)
    if n < 0:
        build.check(-n, "fifo_eval_condensed_active")
    return n


def launch_shape(c: int, e_pad: int, v_pad: int, device: torch.device,
                 shape: Optional[K1Shape] = None) -> K1Shape:
    """:func:`k1_launch_shape` for a CUDA ``device``."""
    if shape is not None:
        return k1_launch_shape(c, e_pad, v_pad, {}, 0, shape)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    warps, k = k1_row_shape(e_pad)
    active = {s: active_clusters(index, e_pad, v_pad, K1Shape(warps, k, s))
              for s in k1_splits(v_pad)[1:]}
    n_sms = torch.cuda.get_device_properties(index).multi_processor_count
    return k1_launch_shape(c, e_pad, v_pad, active, n_sms)


def fifo_eval_condensed(delta, segst, is_read, has_data, data_idx,
                        end_bonus, rd_lat, bp_idx, bp_valid, bp_base,
                        cert_src, cert_dst, cert_thr, cert_valid, *,
                        max_iters: int, bound: float,
                        with_times: bool = False,
                        shape: Optional[K1Shape] = None
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Shared operands (1, E_pad), per-config operands (C, E_pad),
    certificate slots (C, V_pad).  Returns (C, 5) float32 rows, plus the
    final (C, E_pad) times when ``with_times`` (else None).  ``shape``
    forces K1's launch shape (one of :func:`k1_shapes`); None lets
    :func:`k1_launch_shape` choose.  The plain version on CPU tensors
    ignores it."""
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
    for name, (x, _, _) in {**shared, **row}.items():
        if x.data_ptr() % 16:
            raise ValueError(f"{name} is not 16-byte aligned")
    if v_pad % 4:
        raise ValueError(f"v_pad {v_pad} is not a multiple of 4")
    out = torch.empty((C, OUT_LANES), dtype=f32, device=dev)
    times = (torch.empty((C, e_pad), dtype=f32, device=dev)
             if with_times else None)
    if C == 0:
        return out, times
    sh = launch_shape(C, e_pad, v_pad, dev, shape)
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fifo_eval_condensed_launch(
            _ptr(delta), _ptr(segst), _ptr(is_read), _ptr(has_data),
            _ptr(data_idx), _ptr(end_bonus), _ptr(rd_lat), _ptr(bp_idx),
            _ptr(bp_valid), _ptr(bp_base), _ptr(cert_src), _ptr(cert_dst),
            _ptr(cert_thr), _ptr(cert_valid), _ptr(out), _ptr(times),
            C, e_pad, v_pad, int(max_iters), float(bound), *sh, stream)
    build.check(rc, "fifo_eval_condensed")
    fifo_eval_condensed.launches += 1
    fifo_eval_condensed.rows[C] = fifo_eval_condensed.rows.get(C, 0) + 1
    return out, times


#: kernel launches so far (a plain count; reset it by assigning 0)
fifo_eval_condensed.launches = 0
#: launches so far by rows per launch (reset it by assigning {})
fifo_eval_condensed.rows = {}
