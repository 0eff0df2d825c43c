"""K2 wrapper: batched fixpoint over the full event stream.

``fifo_eval`` launches the CUDA kernel (``csrc/fifo_eval.cu``) on CUDA
tensors, and runs the plain torch version
(:func:`repro_torch.kernels.fifo_eval.ref.fifo_eval_plain`) on CPU tensors.
On any other device, or on inputs the kernel does not take, it raises.

``fifo_eval_hetero`` launches the same kernel in its per-design-table
mode, for cross-design batches: the event tables of D designs stacked as
``(D, E*)``, each row's table index, and each row's bound; on CPU tensors
it runs :func:`repro_torch.kernels.fifo_eval.ref.fifo_eval_ref_hetero`.

Output layout (float32, one row per config):
    [0] latency   [1] converged (0/1)   [2] over-bound (0/1)   [3] iters

What bounds K2 on the H100 is the latency of one row-iteration, not bytes
or operations: the main path sends batches of at most 8 rows, each row
runs up to ``max_iters`` Jacobi steps in sequence, and every step is a
gather, a scan and a reduction separated by barriers.  The design does
three things about it:

1. **Fold, once.**  Each thread loads its events' ten operands once per
   launch (contiguous chunks, up to 16 bytes a thread and array) and
   folds them into one gather address, one add and one delta per event
   plus a mask of segment starts: 12 bytes an event instead of ~40.
2. **Operands on chip.**  The folded operands stay in registers for the
   whole launch; only the times move between iterations, in shared
   memory.
3. **One row over a thread-block cluster.**  A row is cut into
   ``cluster`` slices, one per CTA; gathers outside the slice read the
   peer CTA's shared memory, and the scan and the reductions cross the
   cluster through distributed shared memory.  :func:`k2_launch_shape`
   picks the cluster before the launch: long rows need enough CTAs to keep
   their operands in registers, and few rows spread over more SMs as long
   as they all fit the card at once (``cudaOccupancyMaxActiveClusters``,
   through :func:`active_clusters`).
"""

from __future__ import annotations

import functools
from typing import Mapping, Optional, Tuple

import torch

from repro_torch.kernels.fifo_eval import build
from repro_torch.kernels.fifo_eval.ref import (fifo_eval_plain,
                                               fifo_eval_ref_hetero)

#: largest padded event count the kernel takes (16 CTAs x 4096 events:
#: beyond 32768 a row needs a cluster of 16, where the card allows one)
MAX_E_PAD = 65536
OUT_LANES = 4

#: events a CTA can keep in registers: 1024 threads x 4 events
MAX_CTA_EVENTS = 4096
#: events per thread the kernel is built for
K2_EVENTS_PER_THREAD = (1, 2, 4)
#: largest portable cluster (16 needs the card's non-portable opt-in)
PORTABLE_CLUSTER = 8
#: largest cluster the kernel takes
MAX_CLUSTER = 16
#: fewest events a CTA takes when the chooser spreads a row for latency
MIN_SPREAD_EVENTS = 1024
#: fewest events a CTA takes under a forced cluster
MIN_CTA_EVENTS = 128

_SHARED_F32 = ("delta", "segst", "is_read", "has_data", "end_bonus")
_ROW_F32 = ("rd_lat", "bp_valid", "bp_base")

def check_operands(e_pad: int, shared: dict, row: dict,
                   device: torch.device,
                   table_of_row: Optional[torch.Tensor] = None) -> None:
    """Raise on anything the kernels do not take: device, dtype, shape,
    contiguity, and ``e_pad`` beyond :data:`MAX_E_PAD`; with
    ``table_of_row`` (the per-design-table mode), also an index outside
    ``[0, D)`` for the ``(D, e_pad)`` shared tables."""
    if e_pad > MAX_E_PAD:
        raise ValueError(f"e_pad {e_pad} exceeds the kernel's {MAX_E_PAD}")
    if table_of_row is not None and table_of_row.numel():
        n_tables = shared["delta"][2][0]
        lo, hi = (int(v) for v in torch.aminmax(table_of_row))
        if lo < 0 or hi >= n_tables:
            raise ValueError(f"table_of_row holds {lo}..{hi}, outside "
                             f"[0, {n_tables})")
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


def _pow2_ceil(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def k2_cluster_sizes(e_pad: int, max_cluster: int = PORTABLE_CLUSTER
                     ) -> Tuple[int, ...]:
    """Every cluster size K2 can run a row of ``e_pad`` events on: a power
    of two, at least enough CTAs to hold the row's operands in registers
    (:data:`MAX_CTA_EVENTS` each), at most ``max_cluster``, and at least
    :data:`MIN_CTA_EVENTS` events a CTA.  Raises where the row needs more
    CTAs than ``max_cluster``."""
    if not 0 < e_pad <= MAX_E_PAD:
        raise ValueError(f"e_pad {e_pad} outside (0, {MAX_E_PAD}]")
    need = _pow2_ceil(-(-e_pad // MAX_CTA_EVENTS))
    if need > max_cluster:
        raise ValueError(f"e_pad {e_pad} needs a cluster of {need} CTAs; "
                         f"at most {max_cluster} launch")
    sizes, s = [], need
    while s <= max_cluster and (s == need or e_pad >= s * MIN_CTA_EVENTS):
        sizes.append(s)
        s *= 2
    return tuple(sizes)


def k2_cta_shape(e_pad: int, cluster: int) -> Tuple[int, int]:
    """``(threads, k)`` of each CTA when a row of ``e_pad`` events is cut
    into ``cluster`` slices: ``k`` is the fewest events per thread that fit
    1024 threads, so each CTA runs as many threads as its slice allows."""
    slice_ = -(-e_pad // cluster)
    k = next(k for k in K2_EVENTS_PER_THREAD if -(-slice_ // k) <= 1024)
    return -(-slice_ // (32 * k)) * 32, k


def k2_launch_shape(c: int, e_pad: int, active: Mapping[int, int],
                    max_cluster: int = PORTABLE_CLUSTER,
                    cluster: Optional[int] = None) -> Tuple[int, int, int]:
    """``(cluster, threads, k)`` of K2's launch for ``c`` rows of
    ``e_pad`` events: CTAs per row, threads per CTA and events per thread
    (each CTA owns ``threads * k`` consecutive events of its row).

    ``active[s]`` is how many clusters of ``s`` CTAs (each of the shape
    :func:`k2_cta_shape` gives) the card holds at once.  The cluster is
    the smallest of :func:`k2_cluster_sizes` (enough CTAs for the operands
    to stay in registers), raised while all ``c`` rows still run in one
    wave (``c <= active[s]``) and each CTA keeps at least
    :data:`MIN_SPREAD_EVENTS` events.  ``cluster`` forces a size; it must
    be one of :func:`k2_cluster_sizes`."""
    sizes = k2_cluster_sizes(e_pad, max_cluster)
    if cluster is None:
        cluster = sizes[0]
        for s in sizes[1:]:
            if c <= active.get(s, 0) and e_pad >= s * MIN_SPREAD_EVENTS:
                cluster = s
    elif cluster not in sizes:
        raise ValueError(f"cluster {cluster} not in {sizes} for e_pad "
                         f"{e_pad}")
    return (cluster, *k2_cta_shape(e_pad, cluster))


@functools.lru_cache(maxsize=None)
def active_clusters(index: int, cluster: int, threads: int, k: int) -> int:
    """Clusters of ``cluster`` CTAs of ``threads`` threads and ``k`` events
    each that CUDA device ``index`` holds at once (0 when it cannot launch
    that size)."""
    with torch.cuda.device(index):
        n = build.load().fifo_eval_active_clusters(cluster, threads, k)
    if n < 0:
        build.check(-n, "fifo_eval_active_clusters")
    return n


def max_cluster(index: int) -> int:
    """The largest cluster K2 can launch on CUDA device ``index``: 16 when
    one cluster of 16 CTAs of the largest shape fits, else 8."""
    big = active_clusters(index, MAX_CLUSTER, 1024, K2_EVENTS_PER_THREAD[-1])
    return MAX_CLUSTER if big >= 1 else PORTABLE_CLUSTER


def launch_shape(c: int, e_pad: int, device: torch.device,
                 cluster: Optional[int] = None) -> Tuple[int, int, int]:
    """:func:`k2_launch_shape` for a CUDA ``device``."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    top = max_cluster(index)
    active = {s: active_clusters(index, s, *k2_cta_shape(e_pad, s))
              for s in k2_cluster_sizes(e_pad, top)}
    return k2_launch_shape(c, e_pad, active, top, cluster)


def _ptr(x: Optional[torch.Tensor]):
    return None if x is None else x.data_ptr()


def _launch(shared: dict, row: dict, c: int, e_pad: int, max_iters: int,
            bound: float, with_times: bool, cluster: Optional[int],
            dev: torch.device, table_of_row=None, bounds=None
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor], int]:
    """Check the operands and launch K2 once: (out, times, cluster)."""
    check_operands(e_pad, shared, row, dev, table_of_row)
    out = torch.empty((c, OUT_LANES), dtype=torch.float32, device=dev)
    times = (torch.empty((c, e_pad), dtype=torch.float32, device=dev)
             if with_times else None)
    if c == 0:
        return out, times, 0
    n_cl, threads, k = launch_shape(c, e_pad, dev, cluster)
    x = {n: v[0] for n, v in {**shared, **row}.items()}
    lib = build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fifo_eval_launch(
            _ptr(x["delta"]), _ptr(x["segst"]), _ptr(x["is_read"]),
            _ptr(x["has_data"]), _ptr(x["data_idx"]), _ptr(x["end_bonus"]),
            _ptr(x["rd_lat"]), _ptr(x["bp_idx"]), _ptr(x["bp_valid"]),
            _ptr(x.get("bp_base")), _ptr(out), _ptr(times), _ptr(table_of_row),
            _ptr(bounds), c, e_pad, int(max_iters), float(bound), n_cl,
            threads, k, stream)
    build.check(rc, "fifo_eval")
    fifo_eval.launches += 1
    fifo_eval.clusters[n_cl] = fifo_eval.clusters.get(n_cl, 0) + 1
    fifo_eval.rows[c] = fifo_eval.rows.get(c, 0) + 1
    return out, times, n_cl


def _operands(names, xs, dtypes, shape) -> dict:
    return {n: (x, dt, shape) for n, x, dt in zip(names, xs, dtypes)}


_F32, _I32 = torch.float32, torch.int32
_SHARED = _SHARED_F32 + ("data_idx",)
_SHARED_TYPES = (_F32,) * 5 + (_I32,)
_ROW = _ROW_F32 + ("bp_idx",)
_ROW_TYPES = (_F32,) * 3 + (_I32,)


def fifo_eval(delta, segst, is_read, has_data, data_idx, end_bonus,
              rd_lat, bp_idx, bp_valid, bp_base, *, max_iters: int,
              bound: float, with_times: bool = False,
              cluster: Optional[int] = None
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Shared operands (1, E_pad), per-config operands (C, E_pad).
    Returns (C, 4) float32 rows, plus the final (C, E_pad) times when
    ``with_times`` (else None).  ``cluster`` forces K2's cluster size
    (one of :func:`k2_cluster_sizes`); None lets :func:`k2_launch_shape`
    choose.  The plain version on CPU tensors ignores it."""
    dev = rd_lat.device
    if dev.type == "cpu":
        return fifo_eval_plain(delta, segst, is_read, has_data, data_idx,
                               end_bonus, rd_lat, bp_idx, bp_valid, bp_base,
                               max_iters=max_iters, bound=bound,
                               with_times=with_times)
    if dev.type != "cuda":
        raise ValueError(f"fifo_eval runs on cuda or cpu tensors, not {dev}")
    C, e_pad = rd_lat.shape
    shared = _operands(_SHARED, (delta, segst, is_read, has_data, end_bonus,
                                 data_idx), _SHARED_TYPES, (1, e_pad))
    row = _operands(_ROW, (rd_lat, bp_valid, bp_base, bp_idx), _ROW_TYPES,
                    (C, e_pad))
    out, times, _ = _launch(shared, row, C, e_pad, max_iters, bound,
                            with_times, cluster, dev)
    return out, times


def fifo_eval_hetero(delta, segst, is_read, has_data, data_idx, end_bonus,
                     rd_lat, bp_idx, bp_valid, *, table_of_row, bounds,
                     max_iters: int, with_times: bool = False,
                     cluster: Optional[int] = None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K2's per-design-table mode.  Event tables ``(D, E*)``, one row per
    design; per-config operands ``(C, E*)``; ``table_of_row`` (C,) int32
    in ``[0, D)``; ``bounds`` (C,) float32, each row's deadlock bound.
    The back-pressure add is the raw stream's 1, which the kernel adds
    itself (no ``bp_base`` operand).  Returns what
    :func:`fifo_eval` returns.  On CPU tensors it runs the plain
    :func:`~repro_torch.kernels.fifo_eval.ref.fifo_eval_ref_hetero` on
    each row's tables."""
    dev = rd_lat.device
    if dev.type == "cpu":
        tor = table_of_row.long()
        return fifo_eval_ref_hetero(
            delta[tor], segst[tor], is_read[tor], has_data[tor],
            data_idx[tor], end_bonus[tor], rd_lat, bp_idx, bp_valid, bounds,
            max_iters=max_iters, with_times=with_times)
    if dev.type != "cuda":
        raise ValueError(f"fifo_eval_hetero runs on cuda or cpu tensors, "
                         f"not {dev}")
    C, e_pad = rd_lat.shape
    D = delta.shape[0]
    shared = _operands(_SHARED, (delta, segst, is_read, has_data, end_bonus,
                                 data_idx), _SHARED_TYPES, (D, e_pad))
    row = _operands(("rd_lat", "bp_valid", "bp_idx"),
                    (rd_lat, bp_valid, bp_idx), (_F32, _F32, _I32),
                    (C, e_pad))
    row["table_of_row"] = (table_of_row, _I32, (C,))
    row["bounds"] = (bounds, _F32, (C,))
    out, times, n_cl = _launch(shared, row, C, e_pad, max_iters, 0.0,
                               with_times, cluster, dev, table_of_row,
                               bounds)
    if C:
        fifo_eval_hetero.launches += 1
        fifo_eval_hetero.clusters[n_cl] = \
            fifo_eval_hetero.clusters.get(n_cl, 0) + 1
        fifo_eval_hetero.rows[C] = fifo_eval_hetero.rows.get(C, 0) + 1
    return out, times


#: kernel launches so far (a plain count; reset it by assigning 0)
fifo_eval.launches = 0
#: launches so far by cluster size (reset it by assigning {})
fifo_eval.clusters = {}
#: launches so far by rows per launch (reset it by assigning {})
fifo_eval.rows = {}
#: launches in the per-design-table mode so far (each also counts in
#: ``fifo_eval.launches``), by cluster size and by rows per launch
fifo_eval_hetero.launches = 0
fifo_eval_hetero.clusters = {}
fifo_eval_hetero.rows = {}
