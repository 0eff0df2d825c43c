"""Event-driven Kahn-worklist backend (the LightningSim CPU primitive).

Exact longest-path solve of one configuration at a time, O(E + wakeups).
This is the reference evaluator, the arbiter for rows the batched backends
cannot classify within their iteration cap, and — crucially — the home of
the *incremental* fast path that makes FIFO sizing tractable as black-box
DSE: given a solved base configuration and a change to k FIFOs, only the
task segments whose timing actually diverges from the base solve re-run.

Incremental soundness.  Segments interact only through FIFO streams: a
segment's event times depend on the write times of FIFOs it reads (data
edges) and the read times of FIFOs it writes (back-pressure edges), each
consumed in rank order.  The delta solve re-runs the changed FIFOs'
endpoint segments from scratch and propagates *by observed difference*:

- a re-run segment reads streams of un-rerun producers straight out of the
  base solution (their inputs are unchanged, so their times stand);
- every value a re-run segment appends to a stream is compared against the
  base solution at the same rank — the consumer is only woken (and itself
  re-run from scratch) when the value differs or did not exist in the base;
- at quiescence, any re-run segment that produced *fewer* stream entries
  than the base forces its consumer to re-run (the base entries it consumed
  no longer exist).

A segment that is never woken therefore sees bit-identical inputs to the
base solve and keeps its base event times verbatim — including segments
that were incomplete (deadlocked) in the base.  The result is the same
least fixpoint the full worklist computes, at the cost of only the
divergent region; a depth change that does not move any event time costs
O(changed segments) instead of O(E).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.bram import (design_bram_np, fifo_read_latency,
                             read_latency_np)
from repro_torch.core.design import READ
from repro_torch.core.simgraph import SimGraph

from repro_torch.core.backends.base import (CONVERGED, DEADLOCK, EvalBackend,
                                      register_backend)


def _worklist_tables(g: SimGraph):
    """Cached per-graph tables for the event-driven worklist."""
    cached = getattr(g, "_worklist_cache", None)
    if cached is not None:
        return cached
    E = g.n_events
    starts = np.flatnonzero(g.seg_start)
    bounds = np.concatenate([starts, [E]]).astype(np.int64)
    n_segs = len(starts)
    # segment of each event
    seg_of_evt = np.searchsorted(starts, np.arange(E), side="right") - 1
    F = g.n_fifos
    reader_seg = np.full(F, -1, dtype=np.int64)
    writer_seg = np.full(F, -1, dtype=np.int64)
    # the owning segment of each fifo endpoint is the LAST event touching
    # it; seg_of_evt is nondecreasing, so last-touched == max over touches
    fifo_idx = g.fifo.astype(np.int64)
    is_read = g.kind == READ
    np.maximum.at(reader_seg, fifo_idx[is_read], seg_of_evt[is_read])
    np.maximum.at(writer_seg, fifo_idx[~is_read], seg_of_evt[~is_read])
    kind = g.kind.astype(np.int64)
    fifo = g.fifo.astype(np.int64)
    delta = g.delta.astype(np.int64)
    rank = g.rank.astype(np.int64)
    cached = (bounds, n_segs, kind, fifo, delta, rank, reader_seg, writer_seg)
    g._worklist_cache = cached
    return cached


def _delta_tables(g: SimGraph):
    """Cached tables for the incremental solver: per-fifo per-RANK event
    and offset tables (every rank maps to the event that determines its
    stream time — itself on a raw graph, its covering anchor plus a
    delta-chain offset on a condensed one), per-segment owned fifos, and
    the raw owner segment of each fifo's streams."""
    cached = getattr(g, "_delta_cache", None)
    if cached is not None:
        return cached
    (bounds, n_segs, kind, fifo, _, _, reader_seg, writer_seg) = \
        _worklist_tables(g)
    F = g.n_fifos
    starts = bounds[:-1]
    if getattr(g, "cov_ptr", None) is None:
        write_events: List[List[int]] = [[] for _ in range(F)]
        for e in range(g.n_events):
            if kind[e] != READ:
                write_events[int(g.fifo[e])].append(e)
        write_evt = [np.asarray(w, dtype=np.int64) for w in write_events]
        read_evt = [np.asarray(
            g.read_evt_flat[g.read_base[f]: g.read_base[f] + g.n_reads[f]],
            dtype=np.int64) for f in range(F)]
        w_off = [np.zeros(len(w), dtype=np.int64) for w in write_evt]
        r_off = [np.zeros(len(r), dtype=np.int64) for r in read_evt]
        owner_wseg = writer_seg
        owner_rseg = reader_seg
    else:
        write_evt = [np.asarray(
            g.w_anchor_flat[g.w_base[f]: g.w_base[f] + g.n_writes[f]],
            dtype=np.int64) for f in range(F)]
        w_off = [np.asarray(
            g.w_off_flat[g.w_base[f]: g.w_base[f] + g.n_writes[f]],
            dtype=np.int64) for f in range(F)]
        read_evt = [np.asarray(
            g.read_evt_flat[g.read_base[f]: g.read_base[f] + g.n_reads[f]],
            dtype=np.int64) for f in range(F)]
        r_off = [np.asarray(
            g.read_off_flat[g.read_base[f]: g.read_base[f] + g.n_reads[f]],
            dtype=np.int64) for f in range(F)]
        # raw owner segment via the first rank's covering anchor (a fifo
        # whose ops are ALL folded has no anchor-level reader/writer seg)
        def _seg_of(ci: int) -> int:
            return int(np.searchsorted(starts, ci, side="right") - 1)
        owner_wseg = np.asarray(
            [_seg_of(int(write_evt[f][0])) if g.n_writes[f] else -1
             for f in range(F)], dtype=np.int64)
        owner_rseg = np.asarray(
            [_seg_of(int(read_evt[f][0])) if g.n_reads[f] else -1
             for f in range(F)], dtype=np.int64)
    reads_of_seg: List[List[int]] = [[] for _ in range(n_segs)]
    writes_of_seg: List[List[int]] = [[] for _ in range(n_segs)]
    for f in range(F):
        if owner_rseg[f] >= 0:
            reads_of_seg[int(owner_rseg[f])].append(f)
        if owner_wseg[f] >= 0:
            writes_of_seg[int(owner_wseg[f])].append(f)
    cached = (write_evt, read_evt, w_off, r_off,
              reads_of_seg, writes_of_seg, owner_wseg, owner_rseg)
    g._delta_cache = cached
    return cached


@dataclasses.dataclass
class WorklistState:
    """Reusable artifact of one solve — the base for later deltas."""

    depths: np.ndarray        # (F,) int64 the config this state solves
    t: np.ndarray             # (E,) int64 event completion times
    seg_cursor: np.ndarray    # (S,) int64 ops completed per segment
    seg_complete: np.ndarray  # (S,) bool  per-segment completion
    latency: int              # -1 when deadlocked
    deadlocked: bool


def _latency(g: SimGraph, t) -> int:
    le = g.last_evt
    t = np.asarray(t)
    if t.size == 0:
        return int(g.end_delay.max(initial=0))
    base = np.where(le >= 0, t[np.clip(le, 0, t.size - 1)], 0)
    return int((base + g.end_delay).max(initial=0))


def _vector_tables(g: SimGraph):
    """Extra cached tables for the vectorized stretch solver: flat
    per-fifo stream layouts (write/read times indexed by op rank), the
    per-event boolean kind, and python-list mirrors for the scalar
    fallback path (list indexing is ~3x cheaper than numpy scalar
    indexing inside an interpreter loop)."""
    cached = getattr(g, "_vector_cache", None)
    if cached is not None:
        return cached
    (bounds, n_segs, kind, fifo, delta, rank, _, _) = _worklist_tables(g)
    F = g.n_fifos
    is_write = kind != READ
    # per-fifo RAW stream sizes: on a CondensedGraph only anchors appear
    # as events, but streams keep full rank-dense layout (folded entries
    # are bulk-scattered when their covering anchor completes)
    n_writes = g.n_writes.astype(np.int64)
    wbase = np.zeros(F, dtype=np.int64)
    np.cumsum(n_writes[:-1], out=wbase[1:])
    rbase = g.read_base.astype(np.int64)
    total_w = int(n_writes.sum())
    total_r = int(g.n_reads.sum())
    is_read = ~is_write
    cached = (is_read, wbase, total_w, rbase, total_r,
              fifo.tolist(), rank.tolist(), delta.tolist(),
              is_read.tolist(), wbase.tolist(), rbase.tolist())
    g._vector_cache = cached
    return cached


def _cov_tables(g):
    """Cached folded-op scatter tables for a CondensedGraph (None for a
    raw SimGraph).  Vector path: flat arrays indexed by ``cov_ptr``
    anchor slices; scalar/delta paths: per-anchor python lists of
    ``(is_read, fifo, stream_slot, offset)``."""
    cov_ptr = getattr(g, "cov_ptr", None)
    if cov_ptr is None:
        return None
    cached = getattr(g, "_cov_cache", None)
    if cached is not None:
        return cached
    (is_read, wbase, _, rbase, _, *_rest) = _vector_tables(g)
    base = np.where(g.cov_is_read, rbase[g.cov_fifo], wbase[g.cov_fifo])
    cov_slot = base + g.cov_rank
    per_anchor = []
    for ci in range(g.n_events):
        lo, hi = int(cov_ptr[ci]), int(cov_ptr[ci + 1])
        per_anchor.append([
            (bool(g.cov_is_read[k]), int(g.cov_fifo[k]), int(cov_slot[k]),
             int(g.cov_off[k])) for k in range(lo, hi)])
    cached = (cov_ptr.astype(np.int64), g.cov_is_read, g.cov_fifo,
              cov_slot.astype(np.int64), g.cov_off.astype(np.int64),
              per_anchor)
    g._cov_cache = cached
    return cached


#: sentinel "no cross-edge" time for the stretch scan (stays far below
#: any real time after the prefix-max, far above int64 underflow)
_NO_CROSS = -(2 ** 62)

#: initial availability-scan window (galloped geometrically)
_GALLOP0 = 64


def solve(g: SimGraph, depths: np.ndarray) -> WorklistState:
    """Full exact solve of one depth vector, returning a reusable state.

    Event-driven over task segments like the classic worklist, but each
    segment *run* is solved as one vectorized stretch instead of an
    event-at-a-time python loop:

    1. gallop an availability scan to find how far the segment can run
       with the streams produced so far (a read needs its rank'th write,
       a write at rank >= depth needs its back-pressure slot freed);
    2. gather every cross-edge time for the stretch in two fancy-index
       reads (write stream + read-latency for reads, read stream + 1 for
       back-pressured writes);
    3. close the intra-segment chain recurrence
       ``t_i = max(t_{i-1} + delta_i, cross_i)`` in closed form:
       ``t = D + max(pt, cummax(cross - D))`` with ``D = cumsum(delta)``;
    4. scatter the new stream times and wake the coupled segments.

    Feasible configs run in a handful of long stretches (hundreds of
    events each on the benchmark designs), so the python-interpreter cost
    per event collapses (2.5-3.5x end to end).  Heavily back-pressured
    configs ping-pong in short stretches where the vector setup overhead
    loses to the plain loop — each segment ADAPTS: a blocked-early vector
    run demotes that segment to the event-at-a-time scalar path for the
    rest of the solve.
    """
    depths = np.asarray(depths, dtype=np.int64)
    E = g.n_events
    F = g.n_fifos
    widths = np.asarray(g.widths, dtype=np.int64)
    rd_lat_f = read_latency_np(depths, widths).astype(np.int64)
    (bounds, n_segs, kind, fifo, delta, rank,
     reader_seg, writer_seg) = _worklist_tables(g)
    (is_read, wbase, total_w, rbase, total_r,
     fifol, rankl, deltal, is_readl, wbasel, rbasel) = _vector_tables(g)
    cov = _cov_tables(g)
    cov_lists = cov[5] if cov is not None else None
    depths_l = depths.tolist()
    rd_lat_l = rd_lat_f.tolist()

    t = np.zeros(E, dtype=np.int64)
    wtimes = np.zeros(total_w, dtype=np.int64)
    rtimes = np.zeros(total_r, dtype=np.int64)
    # stream cursors as python lists: shared by both paths, converted to
    # arrays only inside vector runs (F is small)
    wcount = [0] * F
    rcount = [0] * F
    cursor = [0] * n_segs
    prev_t = [0] * n_segs
    vec_ok = [True] * n_segs      # adaptive path choice per segment
    boundsl = bounds.tolist()
    queue = deque(range(n_segs))
    queued = [True] * n_segs

    while queue:
        s = queue.popleft()
        queued[s] = False
        lo = boundsl[s] + cursor[s]
        hi = boundsl[s + 1]
        if lo >= hi:
            continue

        if not vec_ok[s]:
            # ---------------- scalar path: event at a time until blocked
            i = lo
            pt = prev_t[s]
            woke_r: set = set()
            woke_w: set = set()
            while i < hi:
                f = fifol[i]
                r = rankl[i]
                ti = pt + deltal[i]
                if is_readl[i]:
                    if r >= wcount[f]:
                        break
                    cross = int(wtimes[wbasel[f] + r]) + rd_lat_l[f]
                    if cross > ti:
                        ti = cross
                    rtimes[rbasel[f] + r] = ti
                    rcount[f] = r + 1
                    woke_r.add(f)
                else:
                    dd = depths_l[f]
                    if r >= dd:
                        if r - dd >= rcount[f]:
                            break
                        slot = int(rtimes[rbasel[f] + r - dd]) + 1
                        if slot > ti:
                            ti = slot
                    wtimes[wbasel[f] + r] = ti
                    wcount[f] = r + 1
                    woke_w.add(f)
                t[i] = ti
                pt = ti
                if cov_lists is not None and cov_lists[i]:
                    # bulk-complete the folded ops this anchor covers
                    for cisr, f2, slot2, off2 in cov_lists[i]:
                        if cisr:
                            rtimes[slot2] = ti + off2
                            rcount[f2] += 1
                            woke_r.add(f2)
                        else:
                            wtimes[slot2] = ti + off2
                            wcount[f2] += 1
                            woke_w.add(f2)
                i += 1
            n = i - lo
            if n:
                cursor[s] += n
                prev_t[s] = pt
                for f in woke_r:           # freed slots -> wake writer
                    ws = writer_seg[f]
                    if ws >= 0 and not queued[ws]:
                        queue.append(ws)
                        queued[ws] = True
                for f in woke_w:           # new data -> wake reader
                    rseg = reader_seg[f]
                    if rseg >= 0 and not queued[rseg]:
                        queue.append(rseg)
                        queued[rseg] = True
            continue

        # ------------------- vector path -----------------------------
        # 1. availability gallop: find the stretch end
        wc = np.asarray(wcount, dtype=np.int64)
        rc = np.asarray(rcount, dtype=np.int64)
        window = _GALLOP0
        stop = lo
        while True:
            end = min(lo + window, hi)
            ks = is_read[lo:end]
            fs = fifo[lo:end]
            rs = rank[lo:end]
            ds = depths[fs]
            avail = np.where(ks, rs < wc[fs],
                             (rs < ds) | (rs - ds < rc[fs]))
            blocked = np.flatnonzero(~avail)
            if blocked.size:
                stop = lo + int(blocked[0])
                break
            stop = end
            if end == hi:
                break
            window *= 4
        n = stop - lo
        if n < _GALLOP0 and stop < hi:
            vec_ok[s] = False    # ping-pong segment: demote permanently
        if n == 0:
            continue

        # 2. cross-edge gather for the stretch
        ks = is_read[lo:stop]
        fs = fifo[lo:stop]
        rs = rank[lo:stop]
        cross = np.full(n, _NO_CROSS, dtype=np.int64)
        r_idx = np.flatnonzero(ks)
        if r_idx.size:
            fr = fs[r_idx]
            cross[r_idx] = wtimes[wbase[fr] + rs[r_idx]] + rd_lat_f[fr]
        w_idx = np.flatnonzero(~ks & (rs >= depths[fs]))
        if w_idx.size:
            fw = fs[w_idx]
            cross[w_idx] = rtimes[rbase[fw] + rs[w_idx]
                                  - depths[fw]] + 1

        # 3. chain recurrence in closed form
        D = np.cumsum(delta[lo:stop])
        ts = D + np.maximum(np.maximum.accumulate(cross - D), prev_t[s])
        t[lo:stop] = ts

        # 4. scatter stream times, advance, wake coupled segments
        #    (bincount over the touched fifos: one C-level pass replaces
        #    the per-fifo np.unique loop — this epilogue is the fixed
        #    per-stretch cost that bounds condensed-graph speedups)
        r_cnt = w_cnt = None
        if r_idx.size:
            fr = fs[r_idx]
            rtimes[rbase[fr] + rs[r_idx]] = ts[r_idx]
            r_cnt = np.bincount(fr, minlength=F)
        aw_idx = np.flatnonzero(~ks)
        if aw_idx.size:
            fw = fs[aw_idx]
            wtimes[wbase[fw] + rs[aw_idx]] = ts[aw_idx]
            w_cnt = np.bincount(fw, minlength=F)

        # 5. bulk-scatter the folded ops covered by the stretch anchors
        if cov is not None:
            cptr, _, cov_f, cov_slot, cov_off, _ = cov
            c0, c1 = int(cptr[lo]), int(cptr[stop])
            if c1 > c0:
                ctimes = (np.repeat(ts, np.diff(cptr[lo:stop + 1]))
                          + cov_off[c0:c1])
                cisr = g.cov_is_read[c0:c1]
                cf = cov_f[c0:c1]
                cslot = cov_slot[c0:c1]
                rsel = np.flatnonzero(cisr)
                if rsel.size:
                    rtimes[cslot[rsel]] = ctimes[rsel]
                    cnt = np.bincount(cf[rsel], minlength=F)
                    r_cnt = cnt if r_cnt is None else r_cnt + cnt
                wsel = np.flatnonzero(~cisr)
                if wsel.size:
                    wtimes[cslot[wsel]] = ctimes[wsel]
                    cnt = np.bincount(cf[wsel], minlength=F)
                    w_cnt = cnt if w_cnt is None else w_cnt + cnt

        if r_cnt is not None:
            for f in np.flatnonzero(r_cnt):
                rcount[f] += int(r_cnt[f])
                ws = writer_seg[f]         # freed slots -> wake writer
                if ws >= 0 and not queued[ws]:
                    queue.append(ws)
                    queued[ws] = True
        if w_cnt is not None:
            for f in np.flatnonzero(w_cnt):
                wcount[f] += int(w_cnt[f])
                rseg = reader_seg[f]       # new data -> wake reader
                if rseg >= 0 and not queued[rseg]:
                    queue.append(rseg)
                    queued[rseg] = True
        cursor[s] += n
        prev_t[s] = int(ts[-1])

    cursor_a = np.asarray(cursor, dtype=np.int64)
    complete = cursor_a + bounds[:-1] >= bounds[1:]
    deadlocked = not bool(complete.all())
    lat = -1 if deadlocked else _latency(g, t)
    return WorklistState(depths=depths.copy(), t=t,
                         seg_cursor=cursor_a, seg_complete=complete,
                         latency=lat, deadlocked=deadlocked)


def solve_delta(g: SimGraph, base: WorklistState, depths: np.ndarray,
                counters: Optional[list] = None) -> WorklistState:
    """Incremental re-solve against a solved base configuration.

    Re-runs the changed FIFOs' endpoint segments and whatever the observed
    timing differences transitively wake; everything else keeps its base
    event times.  ``counters``, when given, is a 1-element list incremented
    by the number of segments re-run (for stats/benchmarks).
    """
    depths = np.asarray(depths, dtype=np.int64)
    changed = np.flatnonzero(base.depths != depths)
    if changed.size == 0:
        return base

    (bounds, n_segs, kind, fifo, delta, rank,
     reader_seg, writer_seg) = _worklist_tables(g)
    (write_evt, read_evt, w_off, r_off, reads_of_seg, writes_of_seg,
     owner_wseg, owner_rseg) = _delta_tables(g)
    cov = _cov_tables(g)
    cov_lists = cov[5] if cov is not None else None
    rd_lat = [fifo_read_latency(int(d), int(w))
              for d, w in zip(depths, g.widths)]
    dl = depths.tolist()
    kindl = kind.tolist()
    fifol = fifo.tolist()
    deltal = delta.tolist()
    rankl = rank.tolist()
    boundsl = bounds.tolist()
    reader_segl = reader_seg.tolist()
    writer_segl = writer_seg.tolist()
    base_t = base.t
    base_cursor = base.seg_cursor

    # the solve loop only reads FIFO streams, never t: a numpy copy with
    # per-event scalar writes beats a full tolist/asarray round-trip
    t = base_t.copy()
    cursor = base_cursor.tolist()
    prev_t = [0] * n_segs
    visited = [False] * n_segs
    F = g.n_fifos
    # Authoritative streams: the base snapshot while the owner is not
    # re-run, swapped for a fresh list the moment the owner is visited.
    # ``base_w/base_r`` keep the base snapshots for the diff checks.
    cur_w: List[Optional[List[int]]] = [None] * F
    cur_r: List[Optional[List[int]]] = [None] * F
    base_w: List[Optional[List[int]]] = [None] * F
    base_r: List[Optional[List[int]]] = [None] * F

    def base_wstream(f: int) -> List[int]:
        s = base_w[f]
        if s is None:
            ev = write_evt[f]
            ws = int(owner_wseg[f])
            end = boundsl[ws] + cursor_base_l[ws] if ws >= 0 else 0
            # a rank's value exists in the base once its determining
            # event (its covering anchor on condensed graphs) completed
            n = int(np.searchsorted(ev, end))
            s = (base_t[ev[:n]] + w_off[f][:n]).tolist()
            base_w[f] = s
            if cur_w[f] is None:
                cur_w[f] = s
        return s

    def base_rstream(f: int) -> List[int]:
        s = base_r[f]
        if s is None:
            ev = read_evt[f]
            rs = int(owner_rseg[f])
            end = boundsl[rs] + cursor_base_l[rs] if rs >= 0 else 0
            n = int(np.searchsorted(ev, end))
            s = (base_t[ev[:n]] + r_off[f][:n]).tolist()
            base_r[f] = s
            if cur_r[f] is None:
                cur_r[f] = s
        return s

    cursor_base_l = base_cursor.tolist()
    queue = deque()
    queued = [False] * n_segs

    def visit(s: int):
        """Add segment s to the re-run set, restarting it from scratch.

        Restart cascades through already-visited consumers: a visited
        segment may have consumed s's *base* stream values (s was not
        being re-run when it read them), and those values are about to be
        re-produced — everything downstream of a reset stream restarts.
        Unvisited consumers are untouched; they join later only if the
        re-produced values actually differ from the base (wake-on-diff).

        Every stream a visited segment can touch is materialized here, so
        the hot loop below only ever does plain list indexing.
        """
        visited[s] = True
        stack = [s]
        seen = {s}
        while stack:
            x = stack.pop()
            cursor[x] = 0
            prev_t[x] = 0
            for f in writes_of_seg[x]:
                base_wstream(f)          # snapshot before the rebuild
                base_rstream(f)          # back-pressure stream x consumes
                cur_w[f] = []            # rebuilt from scratch
                rs = reader_segl[f]
                if rs >= 0 and visited[rs] and rs not in seen:
                    seen.add(rs)
                    stack.append(rs)
            for f in reads_of_seg[x]:
                base_rstream(f)
                base_wstream(f)          # data stream x consumes
                cur_r[f] = []
                ws = writer_segl[f]
                if ws >= 0 and visited[ws] and ws not in seen:
                    seen.add(ws)
                    stack.append(ws)
            if not queued[x]:
                queue.append(x)
                queued[x] = True
        return seen

    for f in changed:
        for s in (reader_segl[f], writer_segl[f]):
            if s >= 0 and not visited[s]:
                visit(s)

    while True:
        while queue:
            s = queue.popleft()
            queued[s] = False
            i = boundsl[s] + cursor[s]
            hi = boundsl[s + 1]
            pt = prev_t[s]
            wake: set = set()
            restarted = False
            while i < hi:
                f = fifol[i]
                ready = pt + deltal[i]
                if kindl[i] == READ:
                    wt = cur_w[f]
                    if len(wt) <= rankl[i]:
                        break
                    ti = wt[rankl[i]] + rd_lat[f]
                    if ready > ti:
                        ti = ready
                    rf = cur_r[f]
                    k = len(rf)
                    rf.append(ti)
                    ws = writer_segl[f]
                    if ws >= 0:
                        if visited[ws]:
                            wake.add(ws)
                        else:
                            bs = base_r[f]
                            if k >= len(bs) or bs[k] != ti:
                                # timing diverged: pull the writer into
                                # the re-run set (visit() enqueues it)
                                if s in visit(ws):
                                    restarted = True
                                    break
                else:
                    j = rankl[i]
                    d = dl[f]
                    ti = ready
                    if j >= d:
                        rt = cur_r[f]
                        if len(rt) <= j - d:
                            break
                        slot = rt[j - d] + 1
                        if slot > ti:
                            ti = slot
                    wf = cur_w[f]
                    k = len(wf)
                    wf.append(ti)
                    rs = reader_segl[f]
                    if rs >= 0:
                        if visited[rs]:
                            wake.add(rs)
                        else:
                            bs = base_w[f]
                            if k >= len(bs) or bs[k] != ti:
                                if s in visit(rs):
                                    restarted = True
                                    break
                t[i] = ti
                pt = ti
                if cov_lists is not None and cov_lists[i]:
                    # append the folded ops this anchor covers, with the
                    # same wake-on-diff propagation as own ops
                    for cisr, f2, _slot2, off2 in cov_lists[i]:
                        tv = ti + off2
                        if cisr:
                            rf2 = cur_r[f2]
                            k2 = len(rf2)
                            rf2.append(tv)
                            ws2 = writer_segl[f2]
                            if ws2 >= 0:
                                if visited[ws2]:
                                    wake.add(ws2)
                                else:
                                    bs2 = base_r[f2]
                                    if k2 >= len(bs2) or bs2[k2] != tv:
                                        if s in visit(ws2):
                                            restarted = True
                                            break
                        else:
                            wf2 = cur_w[f2]
                            k2 = len(wf2)
                            wf2.append(tv)
                            rs2 = reader_segl[f2]
                            if rs2 >= 0:
                                if visited[rs2]:
                                    wake.add(rs2)
                                else:
                                    bs2 = base_w[f2]
                                    if k2 >= len(bs2) or bs2[k2] != tv:
                                        if s in visit(rs2):
                                            restarted = True
                                            break
                    if restarted:
                        break
                cursor[s] += 1
                i += 1
            if not restarted:
                # a cascade that restarted s already reset its cursor and
                # re-queued it; committing pt would corrupt that state
                prev_t[s] = pt
            for n in wake:
                if not queued[n]:
                    queue.append(n)
                    queued[n] = True

        # Shortfall pass: a re-run producer that ended with fewer stream
        # entries than the base invalidates its consumer's base prefix.
        progressed = False
        for s in range(n_segs):
            if not visited[s]:
                continue
            for f in writes_of_seg[s]:
                rs = reader_segl[f]
                if rs >= 0 and not visited[rs] \
                        and len(cur_w[f]) < len(base_w[f]):
                    visit(rs)
                    progressed = True
            for f in reads_of_seg[s]:
                ws = writer_segl[f]
                if ws >= 0 and not visited[ws] \
                        and len(cur_r[f]) < len(base_r[f]):
                    visit(ws)
                    progressed = True
        if not progressed:
            break

    if counters is not None:
        counters[0] += sum(visited)

    cursor_a = np.asarray(cursor, dtype=np.int64)
    complete = cursor_a + bounds[:-1] >= bounds[1:]
    deadlocked = not bool(complete.all())
    lat = -1 if deadlocked else _latency(g, t)
    return WorklistState(depths=depths.copy(), t=t,
                         seg_cursor=cursor_a, seg_complete=complete,
                         latency=lat, deadlocked=deadlocked)


def evaluate_np(g: SimGraph, depths: np.ndarray) -> Tuple[int, bool]:
    """Exact (latency, deadlocked) for one depth vector (full solve)."""
    st = solve(g, depths)
    return st.latency, st.deadlocked


def affected_segments(g: SimGraph, changed_fifos: np.ndarray) -> np.ndarray:
    """Structural upper bound on the segments a delta can re-run: the
    forward closure of the changed FIFOs' endpoints over data and
    back-pressure edges.  The observed-difference propagation in
    :func:`solve_delta` typically re-runs far fewer."""
    (_, n_segs, _, _, _, _, _, _) = _worklist_tables(g)
    (_, _, _, _, reads_of_seg, writes_of_seg,
     writer_seg, reader_seg) = _delta_tables(g)
    seen = np.zeros(n_segs, dtype=bool)
    stack = []
    for f in np.asarray(changed_fifos):
        for s in (int(reader_seg[f]), int(writer_seg[f])):
            if s >= 0 and not seen[s]:
                seen[s] = True
                stack.append(s)
    while stack:
        s = stack.pop()
        for f in writes_of_seg[s]:
            n = int(reader_seg[f])
            if n >= 0 and not seen[n]:
                seen[n] = True
                stack.append(n)
        for f in reads_of_seg[s]:
            n = int(writer_seg[f])
            if n >= 0 and not seen[n]:
                seen[n] = True
                stack.append(n)
    return np.flatnonzero(seen)


@dataclasses.dataclass
class IncrementalStats:
    n_full: int = 0           # full solves
    n_delta: int = 0          # incremental solves
    segs_resolved: int = 0    # segments re-run across all deltas
    segs_total: int = 0       # segments a full solve would have run

    @property
    def resolve_fraction(self) -> float:
        return self.segs_resolved / max(self.segs_total, 1)


@register_backend
class WorklistBackend(EvalBackend):
    """Numpy Kahn worklist: exact, one config at a time, no iteration cap."""

    name = "worklist"
    aliases = ("numpy",)
    wants_bucketing = False

    def __init__(self, max_iters: int = 64, device=None):
        super().__init__(max_iters, device)   # device: unused (numpy)
        self.incr_stats = IncrementalStats()

    def prepare(self, g: SimGraph):
        self.g = g
        return _worklist_tables(g)

    def evaluate(self, depth_matrix: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        m = np.atleast_2d(np.asarray(depth_matrix, dtype=np.int64))
        C = m.shape[0]
        lat = np.zeros(C, dtype=np.int64)
        status = np.zeros(C, dtype=np.int8)
        for i in range(C):
            li, dead = evaluate_np(self.g, m[i])
            lat[i] = li
            status[i] = DEADLOCK if dead else CONVERGED
        bram = design_bram_np(m, np.asarray(self.g.widths))
        return lat, bram, status

    def evaluate_with_times(self, depth_matrix: np.ndarray
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                       np.ndarray]:
        """Like :meth:`evaluate`, also returning the (C, E) final event
        times — the condensation certificate's input."""
        m = np.atleast_2d(np.asarray(depth_matrix, dtype=np.int64))
        C = m.shape[0]
        lat = np.zeros(C, dtype=np.int64)
        status = np.zeros(C, dtype=np.int8)
        times = np.zeros((C, self.g.n_events), dtype=np.int64)
        for i in range(C):
            st = solve(self.g, m[i])
            lat[i] = st.latency
            status[i] = DEADLOCK if st.deadlocked else CONVERGED
            times[i] = st.t
        bram = design_bram_np(m, np.asarray(self.g.widths))
        return lat, bram, status, times

    # ---------------------------------------------------- incremental API
    def solve(self, depths: np.ndarray) -> WorklistState:
        self.incr_stats.n_full += 1
        return solve(self.g, depths)

    def solve_delta(self, base: WorklistState,
                    depths: np.ndarray) -> WorklistState:
        counters = [0]
        st = solve_delta(self.g, base, depths, counters=counters)
        self.incr_stats.n_delta += 1
        self.incr_stats.segs_total += int(base.seg_cursor.shape[0])
        self.incr_stats.segs_resolved += counters[0]
        return st
