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
from repro_torch.core.design import READ, WRITE
from repro_torch.core.simgraph import SimGraph


def _segments(g: SimGraph) -> Tuple[np.ndarray, np.ndarray]:
    starts = np.flatnonzero(g.seg_start)
    bounds = np.concatenate([starts, [g.n_events]]).astype(np.int64)
    seg_of_evt = np.searchsorted(starts, np.arange(g.n_events),
                                 side="right") - 1
    return bounds, seg_of_evt


def task_pairs(g: SimGraph) -> Dict[Tuple[int, int], List[int]]:
    """(writer_seg, reader_seg) -> fifo indices connecting them."""
    _, seg_of_evt = _segments(g)
    writer = {}
    reader = {}
    for e in range(g.n_events):
        f = int(g.fifo[e])
        if g.kind[e] == WRITE:
            writer[f] = int(seg_of_evt[e])
        else:
            reader[f] = int(seg_of_evt[e])
    pairs: Dict[Tuple[int, int], List[int]] = {}
    for f in range(g.n_fifos):
        if f in writer and f in reader:
            pairs.setdefault((writer[f], reader[f]), []).append(f)
    return pairs


def pair_feasible(g: SimGraph, pair: Tuple[int, int], fifos: List[int],
                  depths: Dict[int, int]) -> bool:
    """Count-only Kahn over the two segments with ONLY ``fifos`` bounded.

    Reads of third-party FIFOs are treated as instantly available and
    writes to third parties as never blocking (constraints dropped —
    that's what makes the bound sound).
    """
    bounds, _ = _segments(g)
    fset = set(fifos)
    segs = [pair[0], pair[1]] if pair[0] != pair[1] else [pair[0]]
    ev = {s: list(range(bounds[s], bounds[s + 1])) for s in segs}
    cursor = {s: 0 for s in segs}
    wcount = {f: 0 for f in fset}
    rcount = {f: 0 for f in fset}
    progress = True
    while progress:
        progress = False
        for s in segs:
            evs = ev[s]
            while cursor[s] < len(evs):
                e = evs[cursor[s]]
                f = int(g.fifo[e])
                if f in fset:
                    r = int(g.rank[e])
                    if g.kind[e] == READ:
                        if r >= wcount[f]:
                            break
                        rcount[f] += 1
                    else:
                        if r >= rcount[f] + depths[f]:
                            break
                        wcount[f] += 1
                cursor[s] += 1
                progress = True
    return all(cursor[s] == len(ev[s]) for s in segs)


def local_lower_bounds(g: SimGraph,
                       candidates: List[np.ndarray]) -> np.ndarray:
    """Per-FIFO minimal candidate depth that is pair-feasible with all
    sibling FIFOs at their largest candidates.  Returns (n_fifos,) depths
    (2 where no pruning applies).  Timed by the :mod:`repro_torch.obs`
    span ``local_bounds`` (``fifos``)."""
    with obs.span("local_bounds", fifos=g.n_fifos):
        return _local_lower_bounds(g, candidates)


def _local_lower_bounds(g: SimGraph,
                        candidates: List[np.ndarray]) -> np.ndarray:
    out = np.full(g.n_fifos, 2, dtype=np.int64)
    for pair, fifos in task_pairs(g).items():
        if len(fifos) < 2:
            continue        # single-FIFO pairs cannot reorder-deadlock
        top = {f: int(candidates[f][-1]) for f in fifos}
        for f in fifos:
            grid = candidates[f]
            # bisect the first feasible candidate (feasibility is monotone)
            lo, hi = 0, len(grid) - 1
            if pair_feasible(g, pair, fifos, {**top, f: int(grid[0])}):
                out[f] = int(grid[0])
                continue
            while hi - lo > 1:
                mid = (lo + hi) // 2
                if pair_feasible(g, pair, fifos, {**top, f: int(grid[mid])}):
                    hi = mid
                else:
                    lo = mid
            out[f] = int(grid[hi])
    return out
