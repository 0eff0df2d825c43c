"""Packed simulation graph: trace -> dense, fixed-shape arrays.

This is the LightningSim-style artifact that makes incremental re-simulation
cheap: the event structure below is computed ONCE per design; evaluating a
new depth vector touches only these arrays (no re-execution of the design).

Layout is *task-contiguous* (each task's ops form one contiguous segment in
program order) so that intra-task timing is a segmented max-plus scan — the
key to the batched evaluator in :mod:`repro_torch.core.simulate` and the
CUDA kernels in :mod:`repro_torch.kernels.fifo_eval`.

Arrays (E = total FIFO-op events, F = fifos, T = tasks):

=================  ======  ====================================================
``kind``           (E,)    READ / WRITE
``fifo``           (E,)    fifo index of the op
``delta``          (E,)    cycles between previous same-task op and this op
``seg_start``      (E,)    1 at each task's first event
``rank``           (E,)    k for the k-th read / j for the j-th write of fifo
``data_src``       (E,)    for READ rank k: event index of write k (else -1)
``read_evt_flat``  (R,)    all read event indices, grouped by fifo, rank order
``read_base``      (F,)    offset of each fifo's reads in ``read_evt_flat``
``n_reads``        (F,)    reads per fifo
``n_writes``       (F,)    writes per fifo
``last_evt``       (T,)    index of each task's final event (-1 if none)
``end_delay``      (T,)    trailing compute cycles after the final event
``widths``         (F,)    fifo element bit-widths
=================  ======  ====================================================

Back-pressure edges are the only depth-dependent part: write j of fifo f
waits on read ``j - d_f``, i.e. event ``read_evt_flat[read_base[f] + j - d_f]``
— a gather the evaluator performs per candidate configuration.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.design import Design, READ, WRITE
from repro_torch.core.tracer import Trace, collect_trace


@dataclasses.dataclass
class SimGraph:
    design: Design
    # per-event
    kind: np.ndarray
    fifo: np.ndarray
    delta: np.ndarray
    seg_start: np.ndarray
    rank: np.ndarray
    data_src: np.ndarray
    # per-fifo
    read_evt_flat: np.ndarray
    read_base: np.ndarray
    n_reads: np.ndarray
    n_writes: np.ndarray
    widths: np.ndarray
    # per-task
    last_evt: np.ndarray
    end_delay: np.ndarray
    # metadata
    upper_bounds: np.ndarray       # default per-fifo search upper bound u_i
    max_occupancy: np.ndarray      # per-fifo max in-flight under no back-pressure
    unbounded_latency: int         # latency with all back-pressure disabled

    @property
    def n_events(self) -> int:
        return int(self.kind.shape[0])

    @property
    def n_fifos(self) -> int:
        return int(self.widths.shape[0])

    @property
    def n_tasks(self) -> int:
        return int(self.last_evt.shape[0])

    def groups(self) -> Dict[str, List[int]]:
        return self.design.groups()

    def latency_upper_bound(self) -> int:
        """Any deadlock-free schedule finishes within sum(delta) + 2*E + sum(end_delay)
        cycles (every event waits at most once for one other event)."""
        return int(self.delta.sum() + 2 * self.n_events
                   + self.end_delay.sum() + 16)


class DesignRuleError(ValueError):
    pass


def build_simgraph(design: Design, trace: Optional[Trace] = None) -> SimGraph:
    trace = trace if trace is not None else collect_trace(design)
    F = design.n_fifos
    T = design.n_tasks

    kinds, fifos, deltas, seg_start = [], [], [], []
    last_evt = np.full(T, -1, dtype=np.int64)
    end_delay = np.zeros(T, dtype=np.int64)

    # Per-fifo single-producer / single-consumer validation.
    writer_task = np.full(F, -1, dtype=np.int64)
    reader_task = np.full(F, -1, dtype=np.int64)

    write_events: List[List[int]] = [[] for _ in range(F)]
    read_events: List[List[int]] = [[] for _ in range(F)]
    rank = []

    e = 0
    for tt in trace.tasks:
        n = tt.n_ops
        for i in range(n):
            k = int(tt.kinds[i]); f = int(tt.fifos[i])
            kinds.append(k); fifos.append(f); deltas.append(int(tt.deltas[i]))
            seg_start.append(1 if i == 0 else 0)
            if k == WRITE:
                if writer_task[f] not in (-1, tt.task):
                    raise DesignRuleError(
                        f"fifo {design.fifos[f].name!r} has multiple writers")
                writer_task[f] = tt.task
                rank.append(len(write_events[f]))
                write_events[f].append(e)
            else:
                if reader_task[f] not in (-1, tt.task):
                    raise DesignRuleError(
                        f"fifo {design.fifos[f].name!r} has multiple readers")
                reader_task[f] = tt.task
                rank.append(len(read_events[f]))
                read_events[f].append(e)
            e += 1
        if n > 0:
            last_evt[tt.task] = e - 1
        end_delay[tt.task] = tt.end_delay

    E = e
    kind = np.asarray(kinds, dtype=np.int8)
    fifo = np.asarray(fifos, dtype=np.int32)
    delta = np.asarray(deltas, dtype=np.int64)
    seg_start_a = np.asarray(seg_start, dtype=np.int8)
    rank_a = np.asarray(rank, dtype=np.int64)

    n_reads = np.asarray([len(r) for r in read_events], dtype=np.int64)
    n_writes = np.asarray([len(w) for w in write_events], dtype=np.int64)
    read_base = np.zeros(F, dtype=np.int64)
    if F:
        read_base[1:] = np.cumsum(n_reads)[:-1]
    read_evt_flat = (np.concatenate([np.asarray(r, dtype=np.int64)
                                     for r in read_events])
                     if n_reads.sum() else np.zeros(0, dtype=np.int64))

    data_src = np.full(E, -1, dtype=np.int64)
    for f in range(F):
        wr = write_events[f]
        for k, rev in enumerate(read_events[f]):
            # sequential executability guarantees k < len(wr)
            data_src[rev] = wr[k]

    widths = np.asarray(design.widths(), dtype=np.int64)

    g = SimGraph(
        design=design, kind=kind, fifo=fifo, delta=delta,
        seg_start=seg_start_a, rank=rank_a, data_src=data_src,
        read_evt_flat=read_evt_flat, read_base=read_base,
        n_reads=n_reads, n_writes=n_writes, widths=widths,
        last_evt=last_evt, end_delay=end_delay,
        upper_bounds=trace.default_upper_bounds(),
        max_occupancy=np.zeros(F, dtype=np.int64),
        unbounded_latency=0,
    )

    # Unbounded (no back-pressure) schedule: gives per-fifo max occupancy
    # (used by greedy ranking + pruning) and the latency floor.
    t_inf = _unbounded_times(g)
    g.unbounded_latency = int(_latency_from_times(g, t_inf))
    g.max_occupancy = _max_occupancy(g, t_inf)
    return g


def _unbounded_times(g: SimGraph) -> np.ndarray:
    """Exact event completion times with back-pressure disabled (numpy).

    Kahn worklist over data edges only; O(E) with a per-task cursor.
    Uses SRL read latency (1) — this schedule is used for *structure*
    (occupancy, ordering) rather than reported latency.
    """
    E = g.n_events
    t = np.zeros(E, dtype=np.int64)
    # Task segment boundaries (segments appear in task order).
    starts = np.flatnonzero(g.seg_start).tolist()
    bounds = starts + [E]
    n_segs = len(starts)
    cursor = [0] * n_segs
    # per-fifo write completion times in rank order
    wtimes: List[List[int]] = [[] for _ in range(g.n_fifos)]
    prev_t = [0] * n_segs
    done = [False] * n_segs
    progress = True
    while progress:
        progress = False
        for s in range(n_segs):
            if done[s]:
                continue
            i = bounds[s] + cursor[s]
            while i < bounds[s + 1]:
                ready = prev_t[s] + int(g.delta[i])
                if g.kind[i] == READ:
                    f = int(g.fifo[i]); k = int(g.rank[i])
                    if len(wtimes[f]) <= k:
                        break  # producer not there yet
                    ti_ = max(ready, wtimes[f][k] + 1)
                else:
                    f = int(g.fifo[i])
                    ti_ = ready
                    wtimes[f].append(ti_)
                t[i] = ti_
                prev_t[s] = ti_
                cursor[s] += 1
                i += 1
                progress = True
            if i >= bounds[s + 1]:
                done[s] = True
    if not all(done):  # pragma: no cover - sequential executability rules this out
        raise RuntimeError("unbounded schedule did not complete")
    return t


def _latency_from_times(g: SimGraph, t: np.ndarray) -> int:
    lat = 0
    for ti in range(g.n_tasks):
        le = g.last_evt[ti]
        base = int(t[le]) if le >= 0 else 0
        lat = max(lat, base + int(g.end_delay[ti]))
    return lat


def _max_occupancy(g: SimGraph, t: np.ndarray) -> np.ndarray:
    """Max in-flight element count per fifo under the unbounded schedule.

    Element k occupies its fifo during [t_write_k, t_read_k).  Any depth
    >= this occupancy is behaviourally unbounded (no stall can occur), which
    both ranks FIFOs for the greedy optimizer and caps useful search depths.
    Unread elements occupy forever -> occupancy counts them all.
    """
    F = g.n_fifos
    occ = np.zeros(F, dtype=np.int64)
    for f in range(F):
        mask_w = (g.fifo == f) & (g.kind == WRITE)
        mask_r = (g.fifo == f) & (g.kind == READ)
        tw = np.sort(t[mask_w])
        tr = np.sort(t[mask_r])
        if tw.size == 0:
            continue
        # Sweep: +1 at write, -1 at read.  At equal timestamps the write is
        # counted FIRST (a slot only frees one cycle after its read), so a
        # depth equal to this occupancy is provably stall-free.
        times = np.concatenate([tw, tr])
        deltas = np.concatenate([np.ones_like(tw), -np.ones_like(tr)])
        order = np.lexsort((-deltas, times))
        running = np.cumsum(deltas[order])
        occ[f] = max(1, int(running.max()))
    return occ
