"""Shared operand preparation for the tensor backends (torch).

``GraphOperands``
    The depth-INDEPENDENT operands of one graph on one device: event
    tensors padded to a 128-event multiple, segment-start / read masks,
    data-edge gather indices, the per-event ``end_bonus`` (task end delay
    at each task's last event), and the flattened read-event table for
    back-pressure gathers.  Built once per (graph, device) and cached on
    the graph object.

``depth_operands``
    The depth-DEPENDENT operands for a batch of candidate configurations:
    per-event read latencies, back-pressure gather indices/masks, and the
    structural-deadlock flag.  One kernel launch on a CUDA device
    (``csrc/launch_ops.cu``), plain torch ops (``depth_operands_plain``)
    on the CPU.

``CertTables`` / ``cert_row_operands``
    The fused exactness certificate's slots on a condensed graph (see the
    comment block above :class:`CertTables`).

``HeteroOperands`` / ``extend_operands`` / ``stack_hetero``
    One design's event tables re-padded to a cross-design envelope, and a
    batch of rows from many designs: each design's tables once, stacked
    as ``(D, E*)``, plus each row's table index.

Padding contract (what both CUDA kernels expect): events are padded to
``E_pad`` (a multiple of 128, minimum 128); the first padded event opens a
fresh segment (``seg_start[E] = 1``) so the pad chain can never leak times
into real events; padded events carry ``delta = 0``, no data edge, no
back-pressure edge, and ``end_bonus = NEG``.

Gather indices: indexing in the kernels is unchecked, so every index that
reaches a kernel is clipped into range here (as the reference's indexing
clips) and asserted to lie in ``[0, E_pad)`` when the operands are built.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.bram import BRAM18K_CONFIGS, SRL_BITS, SRL_DEPTH
from repro_torch.core.design import READ, WRITE

LANES = 128
NEG = np.float32(-1e9)


def _floordiv(a: torch.Tensor, b) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def bram_count_torch(depths: torch.Tensor,
                     widths: torch.Tensor) -> torch.Tensor:
    """Algorithm 1, vectorized (mirrors ``bram.bram_count_np``)."""
    d = depths.to(torch.int32)
    w0 = torch.broadcast_to(widths.to(torch.int32), d.shape)
    n = torch.zeros_like(d)
    w = w0
    for d_i, w_i in BRAM18K_CONFIGS:
        n = n + _floordiv(w, w_i) * -_floordiv(-d, d_i)
        w = torch.remainder(w, w_i)
        fits = (w > 0) & (d <= d_i)
        n = n + fits.to(torch.int32)
        w = torch.where(fits, torch.zeros_like(w), w)
    srl = (d <= SRL_DEPTH) | (d * w0 <= SRL_BITS)
    return torch.where(srl, torch.zeros_like(n), n)


@dataclasses.dataclass(frozen=True)
class GraphOperands:
    """Depth-independent, padded event tensors for one graph."""

    n_events: int            # E, real events
    e_pad: int               # E padded to a LANES multiple (>= LANES)
    n_fifos: int
    n_flat_reads: int        # R, length of the padded read_evt_flat table
    bound: float             # schedule upper bound (deadlock threshold)
    taskless_lat: float      # latency floor from tasks with no FIFO events
    device: torch.device
    # (1, E_pad) f32 — the kernels' shared operands
    delta: torch.Tensor
    seg_start: torch.Tensor
    is_read: torch.Tensor
    has_data: torch.Tensor
    end_bonus: torch.Tensor
    # (1, E_pad) i32
    data_idx: torch.Tensor
    # (E_pad,) per-event tables for the depth-dependent gathers
    fifo: torch.Tensor       # i32 fifo of each event
    rank: torch.Tensor       # i32 per-fifo op rank
    is_write: torch.Tensor   # bool
    evt_read_base: torch.Tensor   # i32 read_base[fifo[e]]
    evt_n_reads: torch.Tensor     # i32 n_reads[fifo[e]]
    # (F,) / (R,)
    widths: torch.Tensor     # i32
    read_evt_flat: torch.Tensor   # i32
    # condensation offsets (all-zero on a raw SimGraph)
    data_off: torch.Tensor        # (E_pad,) f32
    read_off_flat: torch.Tensor   # (R,) f32


def _pad_to(a: np.ndarray, n: int, fill, dtype) -> np.ndarray:
    out = np.full(n, fill, dtype=dtype)
    out[: len(a)] = a
    return out


def _check_index(name: str, idx: np.ndarray, n: int) -> None:
    if idx.size and (idx.min() < 0 or idx.max() >= n):
        raise ValueError(
            f"{name}: gather index out of [0, {n}) "
            f"(min {idx.min()}, max {idx.max()})")


def build_operands(g, device) -> GraphOperands:
    """Build the padded event tensors for ``g`` on ``device`` (use
    :func:`get_operands`).  ``g`` is a SimGraph or a CondensedGraph."""
    E = g.n_events
    e_pad = max(LANES, -(-max(E, 1) // LANES) * LANES)
    real = np.arange(e_pad) < E

    kind = _pad_to(g.kind, e_pad, READ, np.int32)   # pad kind is irrelevant
    fifo = _pad_to(g.fifo, e_pad, 0, np.int64)
    delta = _pad_to(g.delta, e_pad, 0, np.float32)
    seg_start = _pad_to(g.seg_start, e_pad, 0, np.float32)
    if E < e_pad:
        seg_start[E] = 1.0                          # isolate the pad chain
    rank = _pad_to(g.rank, e_pad, 0, np.int64)
    data_src = _pad_to(g.data_src, e_pad, -1, np.int64)

    is_read = ((kind == READ) & real).astype(np.float32)
    is_write = (kind == WRITE) & real
    has_data = ((data_src >= 0) & (is_read > 0)).astype(np.float32)
    data_idx = np.clip(data_src, 0, e_pad - 1).astype(np.int32)

    end_bonus = np.full(e_pad, float(NEG), dtype=np.float32)
    taskless_lat = 0.0
    for t in range(g.n_tasks):
        le = int(g.last_evt[t])
        if le >= 0:
            end_bonus[le] = float(g.end_delay[t])
        else:
            taskless_lat = max(taskless_lat, float(g.end_delay[t]))

    R = max(int(g.n_reads.sum()), 1)
    read_evt_flat = np.zeros(R, dtype=np.int64)
    read_evt_flat[: len(g.read_evt_flat)] = g.read_evt_flat
    _check_index("read_evt_flat", read_evt_flat, e_pad)

    # condensation offsets (zeros on a raw SimGraph)
    data_off_src = getattr(g, "data_off", None)
    data_off = np.zeros(e_pad, dtype=np.float32)
    if data_off_src is not None:
        data_off[:E] = data_off_src
    read_off_src = getattr(g, "read_off_flat", None)
    read_off_flat = np.zeros(R, dtype=np.float32)
    if read_off_src is not None:
        read_off_flat[: len(read_off_src)] = read_off_src

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    f32, i32 = torch.float32, torch.int32
    return GraphOperands(
        n_events=E,
        e_pad=e_pad,
        n_fifos=g.n_fifos,
        n_flat_reads=R,
        bound=float(g.latency_upper_bound()),
        taskless_lat=taskless_lat,
        device=torch.device(device),
        delta=t(delta, f32)[None, :],
        seg_start=t(seg_start, f32)[None, :],
        is_read=t(is_read, f32)[None, :],
        has_data=t(has_data, f32)[None, :],
        end_bonus=t(end_bonus, f32)[None, :],
        data_idx=t(data_idx, i32)[None, :],
        fifo=t(fifo, i32),
        rank=t(rank, i32),
        is_write=t(is_write, torch.bool),
        evt_read_base=t(g.read_base.astype(np.int64)[fifo], i32),
        evt_n_reads=t(g.n_reads.astype(np.int64)[fifo], i32),
        widths=t(g.widths, i32),
        read_evt_flat=t(read_evt_flat, i32),
        data_off=t(data_off, f32),
        read_off_flat=t(read_off_flat, f32),
    )


def get_operands(g, device) -> GraphOperands:
    """Cached :class:`GraphOperands` for ``g`` on ``device``."""
    device = torch.device(device)
    cache = g.__dict__.setdefault("_torch_operands_cache", {})
    ops = cache.get(str(device))
    if ops is None:
        ops = cache[str(device)] = build_operands(g, device)
    return ops


@dataclasses.dataclass(frozen=True)
class HeteroOperands:
    """One design's event tables re-padded to a shared hetero envelope.

    All arrays are numpy, field for field the reference's
    ``HeteroOperands``.  The extension region ``[own e_pad, E*)`` follows
    the standard padding contract: it opens a fresh segment, carries no
    edges, zero delta, and ``end_bonus = NEG``, so it can never leak
    times into real events.  Padded FIFO columns get width 1 (with depth
    padded to 2 they are SRL by construction, contributing zero BRAM),
    and padded read-table slots are never gathered because
    ``evt_n_reads`` masks them out.
    """

    e_pad: int               # shared E* (lane-aligned)
    n_fifos_max: int         # shared F*
    n_flat_reads_max: int    # shared R*
    n_fifos: int             # this design's real F
    n_flat_reads: int        # this design's real R
    bound: float
    taskless_lat: float
    # (E*,) event tables
    delta: np.ndarray        # f32
    seg_start: np.ndarray    # f32
    is_read: np.ndarray      # f32
    has_data: np.ndarray     # f32
    end_bonus: np.ndarray    # f32
    data_idx: np.ndarray     # i32
    fifo: np.ndarray         # i32
    rank: np.ndarray         # i32
    is_write: np.ndarray     # bool
    evt_read_base: np.ndarray    # i32
    evt_n_reads: np.ndarray      # i32
    # (F*,) / (R*,)
    widths: np.ndarray       # i32
    read_evt_flat: np.ndarray    # i32


def _host(x: torch.Tensor) -> np.ndarray:
    """A tensor's values as a 1-D numpy array (its first row if 2-D)."""
    a = x.detach().cpu().numpy()
    return a[0] if a.ndim == 2 else a


def _extend(a: np.ndarray, n: int, fill) -> np.ndarray:
    out = np.full(n, fill, dtype=a.dtype)
    out[: len(a)] = a
    return out


def extend_operands(ops: GraphOperands, e_pad: int, f_max: int,
                    r_max: int) -> HeteroOperands:
    """Re-pad one design's :class:`GraphOperands` (on any device) to a
    shared ``(E*, F*, R*)`` envelope."""
    if e_pad % LANES or e_pad < ops.e_pad:
        raise ValueError(f"envelope E* {e_pad} must be a {LANES} multiple "
                         f">= the design's {ops.e_pad}")
    if f_max < ops.n_fifos or r_max < ops.n_flat_reads:
        raise ValueError("envelope F*/R* below the design's")
    seg_start = _extend(_host(ops.seg_start), e_pad, 0.0)
    if e_pad > ops.e_pad:
        seg_start[ops.e_pad] = 1.0     # isolate the extension chain
    return HeteroOperands(
        e_pad=e_pad,
        n_fifos_max=f_max,
        n_flat_reads_max=r_max,
        n_fifos=ops.n_fifos,
        n_flat_reads=ops.n_flat_reads,
        bound=ops.bound,
        taskless_lat=ops.taskless_lat,
        delta=_extend(_host(ops.delta), e_pad, 0.0),
        seg_start=seg_start,
        is_read=_extend(_host(ops.is_read), e_pad, 0.0),
        has_data=_extend(_host(ops.has_data), e_pad, 0.0),
        end_bonus=_extend(_host(ops.end_bonus), e_pad, float(NEG)),
        data_idx=_extend(_host(ops.data_idx), e_pad, 0),
        fifo=_extend(_host(ops.fifo), e_pad, 0),
        rank=_extend(_host(ops.rank), e_pad, 0),
        is_write=_extend(_host(ops.is_write), e_pad, False),
        evt_read_base=_extend(_host(ops.evt_read_base), e_pad, 0),
        evt_n_reads=_extend(_host(ops.evt_n_reads), e_pad, 0),
        widths=_extend(_host(ops.widths), f_max, 1),
        read_evt_flat=_extend(_host(ops.read_evt_flat), r_max, 0),
    )


#: the per-design tables of :class:`HeteroOperands` that rows index
HETERO_TABLES = ("delta", "seg_start", "is_read", "has_data", "end_bonus",
                 "data_idx", "fifo", "rank", "is_write", "evt_read_base",
                 "evt_n_reads", "widths", "read_evt_flat")


@dataclasses.dataclass(frozen=True)
class HeteroTables:
    """The tables of D designs in one envelope, each stored once on one
    device: every :data:`HETERO_TABLES` field stacked as ``(D, E*)``
    (``widths`` ``(D, F*)``, ``read_evt_flat`` ``(D, R*)``), f32, i32 or
    bool as in :class:`HeteroOperands`, plus the per-design ``bound``,
    ``taskless`` (f32) and ``n_flat_reads`` (i32), ``(D,)``.  A row of
    design ``d`` reads row ``d`` of every table, so a batch never holds a
    per-row copy of a table."""

    e_pad: int
    n_fifos_max: int
    delta: torch.Tensor
    seg_start: torch.Tensor
    is_read: torch.Tensor
    has_data: torch.Tensor
    end_bonus: torch.Tensor
    data_idx: torch.Tensor
    fifo: torch.Tensor
    rank: torch.Tensor
    is_write: torch.Tensor
    evt_read_base: torch.Tensor
    evt_n_reads: torch.Tensor
    widths: torch.Tensor
    read_evt_flat: torch.Tensor
    bound: torch.Tensor
    taskless: torch.Tensor
    n_flat_reads: torch.Tensor

    @property
    def n_designs(self) -> int:
        return int(self.bound.shape[0])


def stack_tables(hets: Sequence[HeteroOperands], device) -> HeteroTables:
    """Stack the tables of designs padded to ONE envelope onto
    ``device``: design ``d`` of the result is ``hets[d]``."""
    if not hets:
        raise ValueError("stack_tables needs at least one design")
    env = {(h.e_pad, h.n_fifos_max, h.n_flat_reads_max) for h in hets}
    if len(env) != 1:
        raise ValueError(f"designs padded to different envelopes: {env}")
    dev = torch.device(device)

    def t(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=dev)

    tables = {}
    for name in HETERO_TABLES:
        a = np.stack([getattr(h, name) for h in hets])
        dtype = (torch.bool if a.dtype == np.bool_ else torch.float32
                 if a.dtype.kind == "f" else torch.int32)
        tables[name] = t(a, dtype)
    return HeteroTables(
        e_pad=hets[0].e_pad, n_fifos_max=hets[0].n_fifos_max, **tables,
        bound=t([h.bound for h in hets], torch.float32),
        taskless=t([h.taskless_lat for h in hets], torch.float32),
        n_flat_reads=t([h.n_flat_reads for h in hets], torch.int32))


def stack_rows(entries: Sequence[Tuple[int, np.ndarray]], f_max: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """``[(table index, (c_i, F_i) depths), ...]`` -> ``(table_of_row
    (C,) i32, depths (C, F*) i64)``, rows concatenated in entry order.
    Depth rows are padded to F* with depth 2 (zero-BRAM SRL columns that
    no event references)."""
    index, depths = [], []
    for d, m in entries:
        m = np.atleast_2d(np.asarray(m, dtype=np.int64))
        index.append(np.full(m.shape[0], d, dtype=np.int32))
        pad = np.full((m.shape[0], f_max), 2, dtype=np.int64)
        pad[:, : m.shape[1]] = m
        depths.append(pad)
    return np.concatenate(index), np.concatenate(depths, axis=0)


def stack_hetero(entries, device="cpu"
                 ) -> Tuple[HeteroTables, np.ndarray, np.ndarray]:
    """Stack ``[(HeteroOperands, (c_i, F_i) depths), ...]`` into one
    batch: ``(tables, table_of_row, depths)``.  Each distinct
    :class:`HeteroOperands` is stored once (in order of first
    appearance); row ``i`` reads table row ``table_of_row[i]``, so
    ``tables.<field>[table_of_row]`` is the reference ``stack_hetero``'s
    per-row array of that field."""
    hets: List[HeteroOperands] = []
    slot: Dict[int, int] = {}
    rows = []
    for h, m in entries:
        if id(h) not in slot:
            slot[id(h)] = len(hets)
            hets.append(h)
        rows.append((slot[id(h)], m))
    table_of_row, depths = stack_rows(rows, hets[0].n_fifos_max)
    return stack_tables(hets, device), table_of_row, depths


def hetero_depth_operands(tables: HeteroTables, table_of_row: torch.Tensor,
                          depths: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """:func:`depth_operands` for a cross-design batch: each row gathers
    its own design's tables (``table_of_row``, (C,) long) and its own
    widths.  Returns ``(rd_lat_e, bp_idx, bp_valid, structural, w)``:
    (C, E*) f32 / i32 / f32 like :func:`depth_operands` (the
    back-pressure add of a raw stream is 1), the (C,) structural-deadlock
    flag, and the (C, F*) i32 widths of each row.  The rows of one design
    are computed together against its ``(E*,)`` tables, so no table is
    copied per row."""
    d = depths.to(torch.int32)                             # (C, F*)
    w = tables.widths[table_of_row]                        # (C, F*)
    is_bram = ~((d <= SRL_DEPTH) | (d * w <= SRL_BITS))
    rd_lat_f = 1.0 + is_bram.to(torch.float32)
    shape = (d.shape[0], tables.e_pad)
    rd_lat_e = torch.empty(shape, dtype=torch.float32, device=d.device)
    bp_idx = torch.empty(shape, dtype=tables.read_evt_flat.dtype,
                         device=d.device)
    bp_valid = torch.empty(shape, dtype=torch.float32, device=d.device)
    structural = torch.empty(shape[:1], dtype=torch.bool, device=d.device)
    for t in torch.unique(table_of_row).tolist():
        rows = torch.nonzero(table_of_row == t).squeeze(1)
        fifo = tables.fifo[t].long()                       # (E*,)
        rd_lat_e[rows] = rd_lat_f[rows][:, fifo]
        bp_pos = tables.rank[t] - d[rows][:, fifo]         # (C_t, E*)
        is_write = tables.is_write[t]
        overrun = is_write & (bp_pos >= tables.evt_n_reads[t])
        structural[rows] = overrun.any(dim=1)
        bp_valid[rows] = (is_write & (bp_pos >= 0) & ~overrun
                          ).to(torch.float32)
        flat = torch.minimum(torch.clamp(tables.evt_read_base[t] + bp_pos,
                                         min=0),
                             tables.n_flat_reads[t] - 1)
        bp_idx[rows] = tables.read_evt_flat[t][flat.long()]
    return rd_lat_e, bp_idx, bp_valid, structural, w


def depth_operands(ops: GraphOperands, depths: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                              torch.Tensor, torch.Tensor]:
    """Depth-dependent per-config operands (see
    :func:`depth_operands_plain`): one launch of the depth-operand kernel
    (:func:`repro_torch.kernels.fifo_eval.launch_ops.depth_operands_device`)
    on CUDA tensors, :func:`depth_operands_plain` on CPU tensors."""
    if depths.device.type == "cuda":
        from repro_torch.kernels.fifo_eval.launch_ops import \
            depth_operands_device
        return depth_operands_device(ops, depths)
    if depths.device.type != "cpu":
        raise ValueError(f"depth_operands runs on cuda or cpu tensors, not "
                         f"{depths.device}")
    return depth_operands_plain(ops, depths)


def depth_operands_plain(ops: GraphOperands, depths: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                    torch.Tensor, torch.Tensor]:
    """Depth-dependent per-config operands, in plain torch ops.

    depths: (C, F) integer tensor on the operands' device.  Returns

    - ``rd_lat_e``  (C, E_pad) f32: read latency at each event's fifo
      (1 cycle SRL, 2 cycles BRAM) plus the condensation data-source
      offset (zero on raw graphs),
    - ``bp_idx``    (C, E_pad) i32: back-pressure gather index — write j
      of fifo f waits on read event ``j - d_f`` (its covering anchor on a
      condensed graph),
    - ``bp_valid``  (C, E_pad) f32: mask of writes with an active
      back-pressure edge,
    - ``bp_base``   (C, E_pad) f32: additive term of the back-pressure
      edge — 1.0 on raw graphs, 1.0 + covering-anchor offset on
      condensed ones,
    - ``structural`` (C,) bool: config deadlocks structurally (a write's
      back-pressure partner read does not exist).
    """
    depths = depths.to(torch.int32)
    fifo = ops.fifo.long()
    is_bram = ~((depths <= SRL_DEPTH) | (depths * ops.widths <= SRL_BITS))
    rd_lat_f = 1.0 + is_bram.to(torch.float32)            # (C, F)
    rd_lat_e = rd_lat_f[:, fifo] + ops.data_off[None, :]

    bp_pos = ops.rank[None, :] - depths[:, fifo]          # (C, E_pad)
    overrun = ops.is_write[None, :] & (bp_pos >= ops.evt_n_reads[None, :])
    structural = overrun.any(dim=1)                       # (C,)
    bp_valid = (ops.is_write[None, :] & (bp_pos >= 0) & ~overrun
                ).to(torch.float32)
    flat = torch.clamp(ops.evt_read_base[None, :] + bp_pos, 0,
                       ops.n_flat_reads - 1).long()
    bp_idx = ops.read_evt_flat[flat]                      # (C, E_pad)
    bp_base = ops.read_off_flat[flat] + 1.0               # (C, E_pad)
    return rd_lat_e, bp_idx, bp_valid, bp_base, structural


# --------------------------------------------------------------------------
# fused exactness-certificate tables (condensed graphs only)
# --------------------------------------------------------------------------
#
# ``repro_torch.core.condense.verify_rows`` checks, per depth row, every
# folded event's dropped cross constraint against the *expanded* raw-space
# times ``t_hat[e] = t_cond[cond_of[e]] + off_of[e]``.  Every one of those
# checks compares two expanded times plus a per-row integer, so it
# rewrites into CONDENSED anchor space as a flat list of slots
#
#     violated  iff  valid and  t_cond[src] - t_cond[dst] > thr
#
# * folded read r (raw data source s):  src = cond_of[s],
#   dst = cond_of[r], thr = (off_of[r] - off_of[s]) - rd_lat[row, fifo_r];
# * folded write w at rank j of fifo f with depth d:  active iff j >= d;
#   its partner read slot is ``pos = read_base[f] + j - d`` whose
#   condensed anchor/offset are ``read_evt_flat[pos]`` /
#   ``read_off_flat[pos]``, so src = read_evt_flat[pos], dst = cond_of[w],
#   thr = off_of[w] - read_off_flat[pos] - 1;  a write whose partner read
#   does not exist (``j - d >= n_reads[f]``) is a structural deadlock at
#   that row and is encoded as a forced-fail slot (src = dst = 0,
#   thr = -1: ``t - t > -1`` always fires).
#
# All quantities are integers below the f32-exact limit, so evaluating the
# slots in float32 inside the kernel is bit-for-bit the int64 host check.


@dataclasses.dataclass(frozen=True)
class CertTables:
    """Depth-independent certificate slots for one CondensedGraph.

    Slots are padded to ``v_pad`` (a LANES multiple) with ``valid = 0``;
    the depth-dependent parts are filled per row by
    :func:`cert_row_operands`.
    """

    n_read: int              # folded-read slot count
    n_write: int             # folded-write slot count
    v_pad: int               # total slots padded to a LANES multiple
    # folded reads: static anchors, depth-dependent threshold
    r_src: torch.Tensor      # (Nr,) i32 cond_of[data_src]
    r_dst: torch.Tensor      # (Nr,) i32 cond_of[read]
    r_base: torch.Tensor     # (Nr,) f32 off_of[read] - off_of[data_src]
    r_fifo: torch.Tensor     # (Nr,) i32
    # folded writes: depth-dependent partner anchor AND threshold
    w_dst: torch.Tensor      # (Nw,) i32 cond_of[write]
    w_dst_off: torch.Tensor  # (Nw,) f32 off_of[write]
    w_fifo: torch.Tensor     # (Nw,) i32
    w_rank: torch.Tensor     # (Nw,) i32
    w_read_base: torch.Tensor    # (Nw,) i32 read_base[fifo]
    w_n_reads: torch.Tensor      # (Nw,) i32 n_reads[fifo]


def build_cert_tables(cg, device) -> Optional[CertTables]:
    """Certificate slots for a CondensedGraph (use :func:`get_cert_tables`).

    Returns None when the graph's folded tables cannot be expressed as
    gather slots (a folded read without a data source: such graphs keep
    the host verifier).
    """
    vr_src = np.asarray(cg.vr_src, dtype=np.int64)
    if vr_src.size and (vr_src < 0).any():
        return None
    cond_of = np.asarray(cg.cond_of, dtype=np.int64)
    off_of = np.asarray(cg.off_of, dtype=np.float32)
    vr_idx = np.asarray(cg.vr_idx, dtype=np.int64)
    vw_idx = np.asarray(cg.vw_idx, dtype=np.int64)
    vw_fifo = np.asarray(cg.vw_fifo, dtype=np.int64)
    n_read, n_write = vr_idx.size, vw_idx.size
    v_pad = max(LANES, -(-max(n_read + n_write, 1) // LANES) * LANES)
    e_pad = max(LANES, -(-max(cg.n_events, 1) // LANES) * LANES)
    r_src, r_dst, w_dst = cond_of[vr_src], cond_of[vr_idx], cond_of[vw_idx]
    for name, idx in (("r_src", r_src), ("r_dst", r_dst), ("w_dst", w_dst)):
        _check_index(name, idx, e_pad)
    g = cg.raw

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    f32, i32 = torch.float32, torch.int32
    return CertTables(
        n_read=n_read,
        n_write=n_write,
        v_pad=v_pad,
        r_src=t(r_src, i32),
        r_dst=t(r_dst, i32),
        r_base=t(off_of[vr_idx] - off_of[vr_src], f32),
        r_fifo=t(cg.vr_fifo, i32),
        w_dst=t(w_dst, i32),
        w_dst_off=t(off_of[vw_idx], f32),
        w_fifo=t(vw_fifo, i32),
        w_rank=t(cg.vw_rank, i32),
        w_read_base=t(g.read_base[vw_fifo], i32),
        w_n_reads=t(g.n_reads[vw_fifo], i32),
    )


_CERT_MISS = object()


def get_cert_tables(cg, device) -> Optional[CertTables]:
    """Cached :class:`CertTables` for ``cg`` on ``device`` (None = host
    verify only)."""
    device = torch.device(device)
    cache = cg.__dict__.setdefault("_torch_cert_tables_cache", {})
    ct = cache.get(str(device), _CERT_MISS)
    if ct is _CERT_MISS:
        ct = cache[str(device)] = build_cert_tables(cg, device)
    return ct


def cert_row_operands(ops: GraphOperands, ct: CertTables,
                      depths: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                 torch.Tensor]:
    """Per-row certificate slots.

    depths: (C, F) int tensor.  Returns ``(src i32, dst i32, thr f32,
    valid f32)``, each (C, v_pad): slot ``v`` of row ``c`` is violated iff
    ``valid > 0`` and ``t[src] - t[dst] > thr`` at that row's condensed
    fixpoint — exactly the constraint ``verify_rows`` checks in raw index
    space.
    """
    depths = depths.to(torch.int32)
    C = depths.shape[0]
    dev = depths.device
    f32, i32 = torch.float32, torch.int32
    srcs, dsts, thrs, vals = [], [], [], []
    if ct.n_read:
        is_bram = ~((depths <= SRL_DEPTH) | (depths * ops.widths <= SRL_BITS))
        rd_lat_f = 1.0 + is_bram.to(f32)                      # (C, F)
        srcs.append(ct.r_src[None, :].expand(C, ct.n_read))
        dsts.append(ct.r_dst[None, :].expand(C, ct.n_read))
        thrs.append(ct.r_base[None, :] - rd_lat_f[:, ct.r_fifo.long()])
        vals.append(torch.ones((C, ct.n_read), dtype=f32, device=dev))
    if ct.n_write:
        d = depths[:, ct.w_fifo.long()]                       # (C, Nw)
        j = ct.w_rank[None, :]
        act = j >= d
        overrun = act & (j - d >= ct.w_n_reads[None, :])
        pos = torch.clamp(ct.w_read_base[None, :] + j - d, 0,
                          ops.n_flat_reads - 1).long()
        zero = torch.zeros((), dtype=i32, device=dev)
        src = torch.where(overrun, zero, ops.read_evt_flat[pos])
        dst = torch.where(overrun, zero, ct.w_dst[None, :].expand_as(d))
        thr = torch.where(overrun, torch.tensor(-1.0, device=dev),
                          ct.w_dst_off[None, :]
                          - ops.read_off_flat[pos] - 1.0)
        srcs.append(src)
        dsts.append(dst)
        thrs.append(thr)
        vals.append(act.to(f32))
    pad = ct.v_pad - (ct.n_read + ct.n_write)
    if pad:
        srcs.append(torch.zeros((C, pad), dtype=i32, device=dev))
        dsts.append(torch.zeros((C, pad), dtype=i32, device=dev))
        thrs.append(torch.zeros((C, pad), dtype=f32, device=dev))
        vals.append(torch.zeros((C, pad), dtype=f32, device=dev))
    return (torch.cat(srcs, dim=1).to(i32).contiguous(),
            torch.cat(dsts, dim=1).to(i32).contiguous(),
            torch.cat(thrs, dim=1).contiguous(),
            torch.cat(vals, dim=1).contiguous())
