"""Minimal deadlock-free depth certification via monotone binary search.

Feasibility (absence of deadlock) is **monotone** in every FIFO depth:
enlarging a FIFO only removes back-pressure edges from the dependency
structure, so it can never *introduce* a deadlock.  That makes per-FIFO
minimal safe depths binary-searchable.

The certifier maintains one invariant — the current depth vector is
always verified deadlock-free — and lowers one coordinate at a time:

1. start from a provably feasible vector: the per-FIFO ``max_occupancy``
   of the no-back-pressure schedule (a depth at or above that occupancy
   is behaviourally unbounded, see :mod:`repro_torch.core.simgraph` — and it
   is usually far below the declared/observed upper bounds, which keeps
   the binary searches short);
2. for each FIFO in index order, binary search the smallest depth that
   keeps the *whole current vector* feasible, then pin it there.

Because lowering later coordinates only ever tightens the design, the
final vector is **coordinate-wise minimal**: it is deadlock-free, and
decreasing any single FIFO below its certified depth deadlocks.  (It is
one minimal element of the feasible lattice, not a bound on every
feasible configuration — but any configuration **at or above it
everywhere** is guaranteed deadlock-free, which is what lets optimizers
clamp their search spaces with it.)

Every probe differs from the invariant vector in exactly one FIFO, so
probes go through the advisor-wide
:class:`~repro_torch.core.backends.ConfigCache` and, on the worklist
backend, ride the incremental ``solve_delta`` fast path (a few re-run
task segments per probe instead of a full oracle simulation).  On a
tensor backend on a CUDA device a probe costs a launch, whatever its
rows, so the search is **speculative**: one evaluator call carries the
next levels of the FIFO's bisection tree (the deepest tree that fits the
dispatch policy's smallest bucket above one row: 3 levels, 7 rows, in
the 8-row bucket), and the walk then follows the path the one-row search
would take through the answers.  Only the visited rows count as probes,
are escalated where UNRESOLVED and enter the cache, in visiting order,
so the result, the counts and the cache are the one-row search's.
:func:`certify_min_depths_oracle` is the naive discrete-event-simulation
bisection, kept as the independent cross-check.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np

from repro_torch import obs
from repro_torch.core.backends import ConfigCache
from repro_torch.core.design import Design
from repro_torch.core.oracle import simulate
from repro_torch.core.simgraph import SimGraph

__all__ = ["CertificationResult", "certify_min_depths",
           "certify_min_depths_oracle"]


@dataclasses.dataclass
class CertificationResult:
    """Outcome of one certification run.

    ``depths`` is deadlock-free and coordinate-wise minimal w.r.t. the
    ``start`` vector the search descended from.
    """

    depths: np.ndarray        # (F,) certified minimal safe depths
    start: np.ndarray         # (F,) the feasible vector the search started at
    latency: int              # design latency at the certified depths
    bram: int                 # BRAM cost at the certified depths
    n_probes: int             # feasibility probes that missed the cache
    wall_s: float
    n_cache_hits: int = 0     # feasibility probes answered by the cache


def _tree_levels(evaluator) -> int:
    """Bisection levels one evaluator call carries: 1 where a probe pays
    by the row; where it pays by the launch
    (``BatchedEvaluator._pays_per_launch``), the deepest tree, ``2**k - 1``
    rows, that fits the dispatch policy's smallest bucket above one row."""
    if not getattr(evaluator, "_pays_per_launch", False):
        return 1
    bucket = min(b for b in evaluator.dispatch.buckets if b > 1)
    return (bucket + 1).bit_length() - 1


def _tree_mids(lo: int, hi: int, levels: int) -> list:
    """The midpoints of the bisection tree's first ``levels`` levels below
    ``(lo, hi)``, level by level: a node exists while its ``lo < hi``, a
    feasible midpoint leads to ``(lo, mid)``, a deadlocked one to
    ``(mid + 1, hi)``."""
    mids, level = [], [(lo, hi)]
    for _ in range(levels):
        below = []
        for a, b in level:
            if a < b:
                mid = (a + b) // 2
                mids.append(mid)
                below += [(a, mid), (mid + 1, b)]
        level = below
    return mids


class _CachedProbe:
    """``probe(row, base) -> (deadlocked, latency, bram, cached)`` routed
    through the cache and, when the evaluator prefers it, the incremental
    re-simulation path (single-FIFO deltas of a solved base).  ``cached``
    is True when the cache answered — the driver counts those separately
    so ``n_probes`` reports real evaluator work.  :meth:`tree` is the
    speculative form, ``levels`` how deep it goes (1: not at all)."""

    def __init__(self, evaluator, cache: Optional[ConfigCache]):
        self.evaluator = evaluator
        self.cache = cache
        self.levels = _tree_levels(evaluator)

    def __call__(self, row: np.ndarray, base: Optional[np.ndarray]):
        evaluator, cache = self.evaluator, self.cache
        m = row[None, :]
        if cache is not None:
            lat, bram, dead, miss = cache.lookup(m)
            if not miss.any():
                return bool(dead[0]), int(lat[0]), int(bram[0]), True
        if (base is not None
                and getattr(evaluator, "prefer_incremental", False)):
            lat, bram, dead = evaluator.evaluate_incremental(
                base[None, :], m)
        else:
            lat, bram, dead = evaluator.evaluate(m)
        if cache is not None:
            cache.insert(m, lat, bram, dead)
        return bool(dead[0]), int(lat[0]), int(bram[0]), False

    def tree(self, rows: np.ndarray):
        """The distinct ``rows`` of a bisection tree looked up in the
        cache, and the misses launched as one evaluator call at the first
        cap.  Returns ``(visit, launched)``: ``visit(i) -> (deadlocked,
        cached)`` answers row ``i`` as a probe of it would, escalating it
        where UNRESOLVED and recording it in the cache and its counts;
        ``launched`` is the rows the call carried (0: no call)."""
        cache, ev = self.cache, self.evaluator
        if cache is not None:
            counted = cache.stats.hits, cache.stats.misses
            _, _, dead, miss = cache.lookup(rows)
            # a row counts once it is visited, as a one-row probe counts
            cache.stats.hits, cache.stats.misses = counted
        else:
            dead, miss = np.zeros(len(rows), dtype=bool), \
                np.ones(len(rows), dtype=bool)
        todo = np.flatnonzero(miss)
        if todo.size:
            lat, bram, status = ev._launch_unsettled(rows[todo])
        slot = {int(i): j for j, i in enumerate(todo)}

        def visit(i: int):
            if not miss[i]:
                if cache is not None:
                    cache.stats.hits += 1
                return bool(dead[i]), True
            j = slot[i]
            lat_i, dead_i = ev._settle(rows[i], lat[j], status[j])
            if cache is not None:
                cache.stats.misses += 1
                cache.insert(rows[i][None, :], np.array([lat_i]),
                             bram[j:j + 1], np.array([dead_i]))
            return dead_i, False
        return visit, int(todo.size)


def _coordinate_descent(g: SimGraph, probe,
                        upper: Optional[np.ndarray],
                        lower: Optional[np.ndarray],
                        bounds=None) -> CertificationResult:
    """The shared certification driver.

    ``probe(row, base) -> (deadlocked, latency, bram, cached)`` is the
    only pluggable part — the fast path routes it through the
    incremental evaluator + cache, the oracle arbiter through full
    discrete-event simulations.  Keeping one driver means the two
    certifiers can only ever disagree through their *evaluators* (the
    property the differential tests pin), never through drifted search
    logic.

    ``bounds`` (a :class:`~repro_torch.core.bounds.ChannelBounds`) seeds the
    search: its sound per-FIFO lower bounds raise the floors (pinned
    channels collapse their binary search to nothing), and one extra
    *shortcut probe* of the floor vector settles the whole descent when
    it is jointly feasible — by monotonicity, descending coordinate-wise
    from any feasible ``cur >= floor`` with per-coordinate minima at or
    above ``floor`` can only land exactly on ``floor``.

    Timed by the :mod:`repro_torch.obs` span ``certify``: ``probes``
    (cache misses), ``cache_hits``, ``pinned`` (FIFOs certified above
    depth 1), ``launches`` (the evaluator calls the descent made) and
    ``spec_rows`` (rows launched that the walk never visited).
    """
    with obs.span("certify") as span:
        res, tally = _descend(g, probe, upper, lower, bounds)
        if span:
            span.set(probes=res.n_probes, cache_hits=res.n_cache_hits,
                     pinned=int(np.sum(res.depths > 1)), **tally)
    return res


def _descend(g: SimGraph, probe, upper: Optional[np.ndarray],
             lower: Optional[np.ndarray], bounds=None,
             levels: Optional[int] = None):
    """The descent: ``(CertificationResult, {"launches", "spec_rows"})``.

    ``levels`` is how many bisection levels one evaluator call carries;
    None takes the probe's own (``probe.levels``, 1 where it has none),
    and above 1 the probe must have a ``tree`` (:class:`_CachedProbe`).
    """
    t0 = time.perf_counter()
    if levels is None:
        levels = getattr(probe, "levels", 1)
    F = g.n_fifos
    start = (np.asarray(upper, dtype=np.int64) if upper is not None
             else g.max_occupancy)
    start = np.maximum(start, 1)
    floor = (np.asarray(lower, dtype=np.int64) if lower is not None
             else np.ones(F, dtype=np.int64))
    if bounds is not None:
        # Clip to the start: analytical floors are sound below it, but
        # must never raise the search above user-supplied `upper` caps
        # (only an explicit `lower` is allowed to do that).
        floor = np.maximum(floor, np.minimum(bounds.lower, start))
    floor = np.maximum(floor, 1)
    stats = {"miss": 0, "hit": 0}
    tally = {"launches": 0, "spec_rows": 0}

    def run(row, base):
        dead, lat, bram, cached = probe(row, base)
        stats["hit" if cached else "miss"] += 1
        tally["launches"] += not cached
        return dead, lat, bram

    # Floors above the start raise it: the result must respect `lower`
    # everywhere, so the invariant vector starts at max(start, floor).
    cur = np.maximum(start, floor)
    dead, lat, bram = run(cur, None)
    if dead:
        if (floor > start).any():
            raise ValueError(
                "floored certification start deadlocks: the requested "
                "`lower`/`bounds` floors raise depths above a start "
                "vector that is itself infeasible; pass a feasible "
                "`upper` (declared depths or observed write counts)")
        raise ValueError(
            "certification start vector deadlocks; pass a feasible "
            "`upper` (declared depths or observed write counts)")

    if bounds is not None and not np.array_equal(floor, cur):
        d, _, _ = run(floor, cur)
        if not d:
            cur = floor.copy()

    for f in range(F):
        lo, hi = int(floor[f]), int(cur[f])
        # invariant: cur with cur[f] = hi is verified deadlock-free
        while lo < hi:
            if levels == 1:
                mid = (lo + hi) // 2
                row = cur.copy()
                row[f] = mid
                d, _, _ = run(row, cur)
                lo, hi = (mid + 1, hi) if d else (lo, mid)
                continue
            mids = _tree_mids(lo, hi, levels)
            rows = np.repeat(cur[None, :], len(mids), axis=0)
            rows[:, f] = mids
            visit, launched = probe.tree(rows)
            tally["launches"] += launched > 0
            tally["spec_rows"] += launched
            node = {m: i for i, m in enumerate(mids)}
            for _ in range(levels):
                if lo >= hi:
                    break
                mid = (lo + hi) // 2
                d, cached = visit(node[mid])
                stats["hit" if cached else "miss"] += 1
                tally["spec_rows"] -= not cached
                lo, hi = (mid + 1, hi) if d else (lo, mid)
        cur[f] = hi

    # final vector: re-resolve its objectives (cached when already probed)
    dead, lat, bram = run(cur, None)
    assert not dead, "certified vector must be feasible (invariant)"
    return CertificationResult(depths=cur, start=start, latency=lat,
                               bram=bram, n_probes=stats["miss"],
                               n_cache_hits=stats["hit"],
                               wall_s=time.perf_counter() - t0), tally


def certify_min_depths(g: SimGraph, evaluator,
                       cache: Optional[ConfigCache] = None,
                       upper: Optional[np.ndarray] = None,
                       lower: Optional[np.ndarray] = None,
                       bounds=None) -> CertificationResult:
    """Certify minimal deadlock-free depths for ``g`` using ``evaluator``.

    ``evaluator`` is any object with the :class:`BatchedEvaluator`
    surface (``evaluate`` and, optionally, ``evaluate_incremental`` +
    ``prefer_incremental``).  ``upper`` overrides the start vector;
    ``lower`` sets per-FIFO search floors (default 1); ``bounds``
    (:func:`repro_torch.core.bounds.channel_bounds` output) seeds floors and
    enables the shortcut probe — the certified vector is identical to
    the unseeded one, typically at a fraction of the probes.

    Raises ``ValueError`` when the start vector itself deadlocks (it
    cannot, unless ``upper`` is below the design's occupancy needs).
    """
    return _coordinate_descent(g, _CachedProbe(evaluator, cache),
                               upper, lower, bounds=bounds)


def certify_min_depths_oracle(design: Design,
                              upper: Optional[np.ndarray] = None,
                              lower: Optional[np.ndarray] = None,
                              bounds=None) -> CertificationResult:
    """The same coordinate descent, but every probe is a full
    discrete-event simulation (:func:`repro_torch.core.oracle.simulate`).

    This is the independent arbiter for the fast path — tests assert both
    return identical vectors — and the cost model the incremental path is
    benchmarked against ("co-simulation bisection").
    """
    from repro_torch.core.bram import design_bram_np
    from repro_torch.core.simgraph import build_simgraph
    g = build_simgraph(design)
    widths = np.asarray(g.widths)

    def probe(row: np.ndarray, base):
        r = simulate(design, row)
        bram = int(design_bram_np(row[None, :], widths)[0])
        return r.deadlocked, int(r.latency), bram, False

    return _coordinate_descent(g, probe, upper, lower, bounds=bounds)
