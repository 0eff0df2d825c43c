"""Shared request-routing round for the campaign engine AND the service.

One scheduler/service round produces a list of outstanding
:class:`~repro_torch.core.optimizers.EvalRequest`'s, one per active task or
client session, each already screened against its design's
:class:`~repro_torch.core.backends.ConfigCache`.  :class:`RoundRouter` owns
everything that happens between that screening and ``observe()``:

* incremental-eligible rows (``req.base`` set, evaluator prefers the
  worklist) run on their sticky lane — inline or on a pool worker —
  preserving the LightningSim incremental fast path;
* full-solve rows are merged **per design** and deduplicated across
  requesters (two sessions proposing the same corner in the same round
  cost ONE solve), then either split across worker lanes balanced by row
  cost or, in hetero mode, packed across designs into a single
  fixpoint dispatch (:class:`~repro_torch.core.backends
  .HeteroDispatcher`);
* wall time is attributed back to each requester proportionally to its
  share of the evaluated rows.

The router is deliberately ignorant of *who* is asking: the campaign
scheduler routes :class:`~repro_torch.core.campaign.scheduler.CampaignTask`
batches, and the reference's advisory service routes client-session
batches through the same code (its port is ROADMAP P12), so both inherit
the same exactness guarantee — every path is bit-identical to evaluating each
request alone.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core.optimizers import EvalRequest

__all__ = ["RoundRouter", "RoutedRequest"]


@dataclasses.dataclass
class RoutedRequest:
    """One requester's outstanding batch plus its result buffers.

    ``lat/bram/dead`` arrive pre-filled with cache hits;
    :meth:`RoundRouter.route` fills the ``miss_rows`` in place and
    accumulates the attributed evaluation seconds into ``eval_s``.
    ``tag`` is an opaque requester handle (a campaign task, a service
    session) the router never inspects.
    """

    key: str                  # design key into the router's mapping
    req: EvalRequest
    lat: np.ndarray
    bram: np.ndarray
    dead: np.ndarray
    miss_rows: np.ndarray     # row indices still unresolved after cache
    lane: int = 0             # sticky evaluation lane (0 = this process)
    tag: object = None
    eval_s: float = 0.0       # attributed evaluation wall seconds


class RoundRouter:
    """Routes one round of pending requests into evaluation engines.

    ``designs`` maps a design key to any object exposing ``.evaluator``
    (a :class:`~repro_torch.core.simulate.BatchedEvaluator`) and ``.graph``
    (its :class:`~repro_torch.core.simgraph.SimGraph`) — the campaign's
    ``DesignContext`` (and a service's ``FifoAdvisor`` registry entries)
    qualify.  ``pool`` (a
    :class:`~repro_torch.core.campaign.pool.WorkerPool`) and ``hetero`` (a
    :class:`~repro_torch.core.backends.HeteroDispatcher`) are optional engines
    the owner wires in and may swap at any time between rounds.
    """

    def __init__(self, designs: Mapping[str, object], pool=None,
                 hetero=None):
        self.designs = designs
        self.pool = pool
        self.hetero = hetero
        #: design keys whose rows must evaluate on lane 0 (this process)
        #: even when a pool is attached — used for designs the pool's
        #: worker processes cannot rebuild (custom Design objects that
        #: ``make_design`` does not know)
        self.inline_only: set = set()

    @property
    def n_lanes(self) -> int:
        """Evaluation lanes: lane 0 is the calling process; lanes
        ``1..n_workers`` are pool workers."""
        return self.pool.n_workers + 1 if self.pool is not None else 1

    # ----------------------------------------------------------- routing
    def route(self, pending: List[RoutedRequest]) -> None:
        """Resolve every pending request's cache-miss rows in place."""
        incr: List[RoutedRequest] = []
        full: List[RoutedRequest] = []
        for p in pending:
            if p.miss_rows.size == 0:
                continue
            ev = self.designs[p.key].evaluator
            if p.req.base is not None and ev.prefer_incremental:
                incr.append(p)
            else:
                full.append(p)

        def fill(p: RoutedRequest, rows: np.ndarray, lat, bram, dead):
            p.lat[rows], p.bram[rows], p.dead[rows] = lat, bram, dead

        # full-solve rows: merge per design and dedup across requesters —
        # one round turns into at most one unique-row batch per design
        # (e.g. every SA variant proposing the Baseline-Max corner in the
        # same round costs ONE solve)
        merged = []
        by_design: Dict[str, List[RoutedRequest]] = {}
        for p in full:
            by_design.setdefault(p.key, []).append(p)
        for name, plist in by_design.items():
            big = np.concatenate(
                [p.req.depths[p.miss_rows] for p in plist], axis=0)
            uniq, inverse = np.unique(big, axis=0, return_inverse=True)
            merged.append((name, plist, uniq, inverse))

        def scatter(name, plist, inverse, ulat, ubram, udead, wall):
            total = len(inverse)
            off = 0
            for p in plist:
                n = p.miss_rows.size
                sel = inverse[off:off + n]
                off += n
                fill(p, p.miss_rows, ulat[sel], ubram[sel], udead[sel])
                p.eval_s += wall * n / max(total, 1)

        def incr_inline(p: RoutedRequest):
            rows = p.miss_rows
            t0 = time.perf_counter()
            l, b, dd = self.designs[p.key].evaluator.evaluate_incremental(
                p.req.base[rows], p.req.depths[rows])
            p.eval_s += time.perf_counter() - t0
            fill(p, rows, l, b, dd)

        if self.hetero is not None and merged:
            for p in incr:
                incr_inline(p)
            t0 = time.perf_counter()
            results = self.hetero.dispatch(
                [(name, uniq) for name, _, uniq, _ in merged])
            dt = time.perf_counter() - t0
            total = sum(u.shape[0] for _, _, u, _ in merged)
            for (name, plist, uniq, inverse), (l, b, dd) in zip(
                    merged, results):
                share = dt * uniq.shape[0] / max(total, 1)
                scatter(name, plist, inverse, l, b, dd, share)
            return

        if self.pool is None:
            for p in incr:
                incr_inline(p)
            for name, plist, uniq, inverse in merged:
                ev = self.designs[name].evaluator
                t0 = time.perf_counter()
                l, b, dd = ev.evaluate(uniq)
                dt = time.perf_counter() - t0
                scatter(name, plist, inverse, l, b, dd, dt)
            return

        # ------- pooled: lane 0 is this process, overlapped with the
        # pool between submit() and collect()
        n_lanes = self.n_lanes
        load = [0.0] * n_lanes
        jobs: List[Tuple[int, str, np.ndarray, Optional[np.ndarray]]] = []
        job_sinks: List[Tuple[RoutedRequest, np.ndarray]] = []
        main_incr: List[RoutedRequest] = []
        for p in incr:
            rows = p.miss_rows
            lane = 0 if p.key in self.inline_only else p.lane
            load[lane] += rows.size * self.designs[p.key].graph.n_events
            if lane == 0:
                main_incr.append(p)
            else:
                jobs.append((lane - 1, p.key,
                             p.req.depths[rows], p.req.base[rows]))
                job_sinks.append((p, rows))
        # split each design's unique rows into per-lane chunks, balanced
        # by row cost (~ event count of the owning design)
        main_full: List[Tuple[int, np.ndarray]] = []
        pool_full: List[Tuple[int, np.ndarray]] = []  # (merged_idx, sel)
        for mi, (name, _plist, uniq, _inv) in enumerate(merged):
            cost = self.designs[name].graph.n_events
            sel: Dict[int, List[int]] = {}
            if name in self.inline_only:
                load[0] += cost * uniq.shape[0]
                sel[0] = list(range(uniq.shape[0]))
            else:
                for r in range(uniq.shape[0]):
                    lane = int(np.argmin(load))
                    load[lane] += cost
                    sel.setdefault(lane, []).append(r)
            for lane, rsel in sel.items():
                rsel = np.asarray(rsel)
                if lane == 0:
                    main_full.append((mi, rsel))
                else:
                    pool_full.append((mi, rsel))
                    jobs.append((lane - 1, name, uniq[rsel], None))
        handle = self.pool.submit(jobs) if jobs else None

        acc: Dict[int, Tuple] = {}

        def acc_for(mi):
            uniq = merged[mi][2]
            return acc.setdefault(mi, (
                np.zeros(uniq.shape[0], dtype=np.int64),
                np.zeros(uniq.shape[0], dtype=np.int64),
                np.zeros(uniq.shape[0], dtype=bool), [0.0]))

        # main-lane work runs while the pool workers chew on theirs
        for p in main_incr:
            incr_inline(p)
        for mi, rsel in main_full:
            name, _plist, uniq, _inv = merged[mi]
            ev = self.designs[name].evaluator
            t0 = time.perf_counter()
            l, b, dd = ev.evaluate(uniq[rsel])
            st = acc_for(mi)
            st[0][rsel], st[1][rsel], st[2][rsel] = l, b, dd
            st[3][0] += time.perf_counter() - t0

        if handle is not None:
            results = self.pool.collect(handle)
            n_incr_jobs = len(job_sinks)
            for (p, rows), (l, b, dd, dt) in zip(
                    job_sinks, results[:n_incr_jobs]):
                fill(p, rows, l, b, dd)
                p.eval_s += dt
            for (mi, rsel), (l, b, dd, dt) in zip(
                    pool_full, results[n_incr_jobs:]):
                st = acc_for(mi)
                st[0][rsel], st[1][rsel], st[2][rsel] = l, b, dd
                st[3][0] += dt
        for mi, (ulat, ubram, udead, wall) in acc.items():
            name, plist, uniq, inverse = merged[mi]
            scatter(name, plist, inverse, ulat, ubram, udead, wall[0])
