"""Beyond-paper pruning: SOUND per-FIFO depth lower bounds.

The paper prunes the search space to BRAM breakpoints (§III-C).  We add a
second, orthogonal pruning: for each writer/reader task pair, consider the
SUBGRAPH containing only those two tasks' events and the FIFOs between
them, with every other cross-task constraint dropped.  Dropping
constraints only removes cycles, so

    pair-subgraph deadlocks at depth vector d  =>  full design deadlocks
    for EVERY configuration that is pointwise <= d on the pair's FIFOs.

Hence the smallest d for which (fifo f = d, siblings at their upper
bounds) is pair-feasible is a sound LOWER bound on f's useful depths: all
smaller candidates are deadlocked in every configuration and can be
removed from the grid.  On reorder-hazard designs (k15mmtree: transposed
operand consumption) this eliminates ~all deadlocked proposals, which
otherwise burn most of a random/SA budget (EXPERIMENTS.md §1.6).

Single-FIFO pairs are always feasible at any depth >= the structural
minimum (rank-to-rank matching cannot reorder), so the analysis only does
work where multiple FIFOs connect the same task pair (stream arrays —
exactly where the hazard lives).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core.bounds import last_owner
from repro_torch.core.design import WRITE
from repro_torch.core.simgraph import SimGraph


def _segments(g: SimGraph) -> Tuple[np.ndarray, np.ndarray]:
    starts = np.flatnonzero(g.seg_start)
    bounds = np.concatenate([starts, [g.n_events]]).astype(np.int64)
    seg_of_evt = np.searchsorted(starts, np.arange(g.n_events),
                                 side="right") - 1
    return bounds, seg_of_evt


def task_pairs(g: SimGraph) -> Dict[Tuple[int, int], List[int]]:
    """(writer_seg, reader_seg) -> fifo indices connecting them; a fifo's
    writer and reader are the segments of its last write and last read."""
    _, seg_of_evt = _segments(g)
    writer = last_owner(seg_of_evt, np.flatnonzero(g.kind == WRITE),
                        g.fifo, g.n_fifos)
    reader = last_owner(seg_of_evt, np.flatnonzero(g.kind != WRITE),
                        g.fifo, g.n_fifos)
    pairs: Dict[Tuple[int, int], List[int]] = {}
    for f in np.flatnonzero((writer >= 0) & (reader >= 0)).tolist():
        pairs.setdefault((int(writer[f]), int(reader[f])), []).append(f)
    return pairs


class _PairChains:
    """The event chains of one task pair, with only ``fifos`` bounded.

    Chain 0 is segment ``pair[0]`` and chain 1 is segment ``pair[1]``
    (empty when the two are one segment).  Each bounded event waits on
    one other event: a read on the write of its rank (``data_src``), a
    write of rank ``k`` on the read of rank ``k - d`` (on none below 0).
    That wait is stated as the number of events of the other chain that
    must be done first.  A wait on an earlier event of the event's own
    chain is 0; on a later one, on an event of neither chain, or on an
    event that does not exist, it is :attr:`never`.  Only the writes'
    waits depend on the depths, so the reads' are computed once.
    """

    def __init__(self, g: SimGraph, pair: Tuple[int, int],
                 fifos: List[int]):
        bounds, _ = _segments(g)
        s0, s1 = pair
        lo0, hi0 = int(bounds[s0]), int(bounds[s0 + 1])
        lo1, hi1 = ((int(bounds[s1]), int(bounds[s1 + 1])) if s1 != s0
                    else (hi0, hi0))
        self.g = g
        self.lo, self.hi = (lo0, lo1), (hi0, hi1)
        self.n = (hi0 - lo0, hi1 - lo1)
        self.never = self.n[0] + self.n[1] + 1
        bounded = np.zeros(g.n_fifos, dtype=bool)
        bounded[np.asarray(fifos, dtype=np.int64)] = True
        ev = np.concatenate([np.arange(lo0, hi0), np.arange(lo1, hi1)])
        ev = ev[bounded[g.fifo[ev]]]
        write = g.kind[ev] == WRITE
        reads = ev[~write]
        self.read_waits = [np.zeros(n, dtype=np.int64) for n in self.n]
        self._place(reads, self._wait(reads, g.data_src[reads]),
                    self.read_waits)
        self.writes = ev[write]
        self.w_fifo = g.fifo[self.writes]
        self.w_rank = g.rank[self.writes]
        self.w_base = g.read_base[self.w_fifo]
        self.w_reads = g.n_reads[self.w_fifo]
        self.checks = 0

    def _chain(self, e: np.ndarray) -> np.ndarray:
        return (e >= self.lo[1]) & (e < self.hi[1])

    def _wait(self, e: np.ndarray, t: np.ndarray) -> np.ndarray:
        """The wait of events ``e`` on events ``t`` (-1: none)."""
        ce, ct = self._chain(e), self._chain(t)
        in_t = (((t >= self.lo[0]) & (t < self.hi[0])) | ct) & (t >= 0)
        lo_t = np.where(ct, self.lo[1], self.lo[0])
        return np.where(in_t & (ce == ct), np.where(t < e, 0, self.never),
                        np.where(in_t, t - lo_t + 1, self.never))

    def _place(self, e: np.ndarray, wait: np.ndarray, out) -> None:
        c = self._chain(e)
        out[0][e[~c] - self.lo[0]] = wait[~c]
        out[1][e[c] - self.lo[1]] = wait[c]

    def feasible(self, depth: np.ndarray) -> bool:
        """Whether the count-only Kahn walk runs both chains to their
        ends with each bounded fifo ``f`` at ``depth[f]``.

        With ``i`` events of chain 0 done, chain 1 gets through ``Y[i]``
        events: those whose prefix max of waits is at most ``i``.  Chain
        0's event ``i`` then issues iff its wait is at most ``Y[i]``, so
        the walk completes iff that holds for every ``i`` and ``Y`` at
        the end of chain 0 is all of chain 1."""
        g = self.g
        self.checks += 1
        m = self.w_rank - depth[self.w_fifo]
        hit = (m >= 0) & (m < self.w_reads)
        t = np.full(m.shape, -1, dtype=np.int64)
        t[hit] = g.read_evt_flat[self.w_base[hit] + m[hit]]
        a, b = (w.copy() for w in self.read_waits)
        self._place(self.writes,
                    np.where(m < 0, 0, self._wait(self.writes, t)), (a, b))
        y = np.searchsorted(np.maximum.accumulate(b),
                            np.arange(self.n[0] + 1), side="right")
        return bool(y[-1] == self.n[1] and np.all(a <= y[:-1]))


def pair_feasible(g: SimGraph, pair: Tuple[int, int], fifos: List[int],
                  depths: Dict[int, int]) -> bool:
    """Count-only Kahn over the two segments with ONLY ``fifos`` bounded.

    Reads of third-party FIFOs are treated as instantly available and
    writes to third parties as never blocking (constraints dropped —
    that's what makes the bound sound).
    """
    return _PairChains(g, pair, fifos).feasible(_depth_vector(g, depths))


def _depth_vector(g: SimGraph, depths: Dict[int, int]) -> np.ndarray:
    d = np.zeros(g.n_fifos, dtype=np.int64)
    for f, v in depths.items():
        d[f] = v
    return d


def local_lower_bounds(g: SimGraph,
                       candidates: List[np.ndarray]) -> np.ndarray:
    """Per-FIFO minimal candidate depth that is pair-feasible with all
    sibling FIFOs at their largest candidates.  Returns (n_fifos,) depths
    (2 where no pruning applies).  Timed by the :mod:`repro_torch.obs`
    span ``local_bounds`` (``fifos``; ``pairs``: the multi-FIFO pairs
    examined; ``checks``: the depth vectors tested)."""
    with obs.span("local_bounds", fifos=g.n_fifos) as span:
        out, pairs, checks = _local_lower_bounds(g, candidates)
        if span:
            span.set(pairs=pairs, checks=checks)
    return out


def _local_lower_bounds(g: SimGraph, candidates: List[np.ndarray]):
    out = np.full(g.n_fifos, 2, dtype=np.int64)
    n_pairs = n_checks = 0
    for pair, fifos in task_pairs(g).items():
        if len(fifos) < 2:
            continue        # single-FIFO pairs cannot reorder-deadlock
        n_pairs += 1
        chains = _PairChains(g, pair, fifos)
        top = _depth_vector(g, {f: int(candidates[f][-1]) for f in fifos})

        def feasible(f, d):
            depth = top.copy()
            depth[f] = d
            return chains.feasible(depth)

        for f in fifos:
            grid = candidates[f]
            # bisect the first feasible candidate (feasibility is monotone)
            lo, hi = 0, len(grid) - 1
            if feasible(f, int(grid[0])):
                out[f] = int(grid[0])
                continue
            while hi - lo > 1:
                mid = (lo + hi) // 2
                if feasible(f, int(grid[mid])):
                    hi = mid
                else:
                    lo = mid
            out[f] = int(grid[hi])
        n_checks += chains.checks
    return out, n_pairs, n_checks
