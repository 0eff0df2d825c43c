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
task segments per probe instead of a full oracle simulation); on the
tensor backends each probe is a one-row batched evaluation.
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


def _probe_factory(evaluator, cache: Optional[ConfigCache]):
    """Returns ``probe(row, base) -> (deadlocked, latency, bram, cached)``
    routed through the cache and, when the evaluator prefers it, the
    incremental re-simulation path (single-FIFO deltas of a solved
    base).  ``cached`` is True when the cache answered — the driver
    counts those separately so ``n_probes`` reports real evaluator work."""
    def probe(row: np.ndarray, base: Optional[np.ndarray]):
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
    return probe


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
    (cache misses), ``cache_hits`` and ``pinned`` (FIFOs certified above
    depth 1).
    """
    with obs.span("certify") as span:
        res = _descend(g, probe, upper, lower, bounds)
        if span:
            span.set(probes=res.n_probes, cache_hits=res.n_cache_hits,
                     pinned=int(np.sum(res.depths > 1)))
    return res


def _descend(g: SimGraph, probe, upper: Optional[np.ndarray],
             lower: Optional[np.ndarray], bounds=None) -> CertificationResult:
    t0 = time.perf_counter()
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

    def run(row, base):
        dead, lat, bram, cached = probe(row, base)
        stats["hit" if cached else "miss"] += 1
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
            mid = (lo + hi) // 2
            row = cur.copy()
            row[f] = mid
            d, _, _ = run(row, cur)
            if d:
                lo = mid + 1
            else:
                hi = mid
        cur[f] = hi

    # final vector: re-resolve its objectives (cached when already probed)
    dead, lat, bram = run(cur, None)
    assert not dead, "certified vector must be feasible (invariant)"
    return CertificationResult(depths=cur, start=start, latency=lat,
                               bram=bram, n_probes=stats["miss"],
                               n_cache_hits=stats["hit"],
                               wall_s=time.perf_counter() - t0)


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
    return _coordinate_descent(g, _probe_factory(evaluator, cache),
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
