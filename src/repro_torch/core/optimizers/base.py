"""Shared optimizer infrastructure: evaluation context, history, results.

All optimizers operate on *index vectors* into per-FIFO (or per-group)
pruned candidate grids (§III-C breakpoints), never on raw depths — this is
the paper's search-space pruning, applied uniformly.

Optimizers are *stepwise*: each subclass implements the ``_steps``
generator, which yields :class:`EvalRequest` batches and receives the
evaluated ``(latency, bram, deadlock)`` arrays back at the yield point.
Two drivers consume the generator:

* :meth:`Optimizer.run` — the legacy blocking API; fulfills every request
  against the optimizer's own :class:`EvalContext` and returns the final
  :class:`OptResult`.
* :meth:`Optimizer.propose` / :meth:`Optimizer.observe` — the stepwise
  API; a scheduler interleaves many optimizers and routes their requests
  into shared dispatches (the campaigns of
  :mod:`repro_torch.core.campaign` do so across designs, and the
  advisory service of :mod:`repro_torch.core.service` across client
  sessions).

Both drivers see identical request/result sequences, so they produce
identical histories and frontiers for the same seed.

Spans (:mod:`repro_torch.obs`): ``optimizer.step`` (``rows``: the rows of
the request it yields) around each step of the generator, and
``fulfill`` (``rows``, ``misses``) around :meth:`EvalContext.fulfill`.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core.backends import ConfigCache
from repro_torch.core.bram import breakpoints
from repro_torch.core.pareto import pareto_front
from repro_torch.core.simgraph import SimGraph
from repro_torch.core.simulate import BatchedEvaluator


@dataclasses.dataclass
class EvalRequest:
    """One batch of depth configurations an optimizer wants evaluated.

    ``base`` marks the rows as single-/few-FIFO deltas of already-solved
    configurations (one shared (F,) row or a per-row (C, F) matrix),
    making them eligible for the incremental re-simulation fast path.
    """

    depths: np.ndarray
    base: Optional[np.ndarray] = None

    def __post_init__(self):
        self.depths = np.atleast_2d(np.asarray(self.depths, dtype=np.int64))
        if self.base is not None:
            base = np.atleast_2d(np.asarray(self.base, dtype=np.int64))
            if base.shape[0] == 1 and self.depths.shape[0] > 1:
                base = np.broadcast_to(base, self.depths.shape)
            self.base = base

    @property
    def n_rows(self) -> int:
        return self.depths.shape[0]


@dataclasses.dataclass
class OptResult:
    name: str
    configs: np.ndarray        # (N, F) evaluated depth vectors
    latency: np.ndarray        # (N,)  -1 where deadlocked
    bram: np.ndarray           # (N,)
    deadlock: np.ndarray       # (N,) bool
    runtime_s: float
    n_evals: int

    def feasible_points(self) -> Tuple[np.ndarray, np.ndarray]:
        ok = ~self.deadlock
        pts = np.stack([self.latency[ok], self.bram[ok]], axis=1)
        return pts.astype(np.float64), np.flatnonzero(ok)

    def frontier(self) -> Tuple[np.ndarray, np.ndarray]:
        """(points (M,2), config rows (M,F)) of the Pareto-optimal set,
        deduplicated on (latency, bram)."""
        pts, idx = self.feasible_points()
        if pts.shape[0] == 0:
            return np.zeros((0, 2)), np.zeros((0, self.configs.shape[1]))
        sel = pareto_front(pts)
        _, first = np.unique(pts[sel], axis=0, return_index=True)
        sel = sel[np.sort(first)]
        return pts[sel], self.configs[idx[sel]]


class EvalContext:
    """Everything one optimizer run searches *with* and records *into*.

    Owns the pruned per-FIFO/per-group candidate grids (paper §III-C),
    the seeded RNG, the (possibly shared) :class:`ConfigCache`, the
    evaluation history, and the miss-counting budget.  Optimizers hold
    exactly one; `FifoAdvisor.make_context` builds them sharing the
    advisor's evaluator and cache (how campaign tasks and service
    sessions ride one trace).
    """

    def __init__(self, g: SimGraph, evaluator: Optional[BatchedEvaluator] = None,
                 upper_bounds: Optional[np.ndarray] = None,
                 occupancy_cap: bool = False, local_bounds: bool = False,
                 lower_bounds: Optional[np.ndarray] = None,
                 feasible_floor: Optional[np.ndarray] = None,
                 seed: int = 0, cache: Optional[ConfigCache] = None):
        self.g = g
        self.ev = evaluator or BatchedEvaluator(g)
        self.cache = cache if cache is not None else ConfigCache(g.n_fifos)
        self.rng = np.random.default_rng(seed)
        self.u = (np.asarray(upper_bounds, dtype=np.int64)
                  if upper_bounds is not None else g.upper_bounds.copy())
        self.u = np.maximum(self.u, 2)

        # Pruned per-FIFO candidate grids (paper §III-C).  With
        # ``occupancy_cap`` (beyond-paper), depths above the observed
        # no-back-pressure occupancy are collapsed to the first breakpoint
        # covering it — larger depths cannot change behaviour.
        self.candidates: List[np.ndarray] = []
        for f in range(g.n_fifos):
            cand = breakpoints(int(g.widths[f]), int(self.u[f]))
            if occupancy_cap:
                occ = int(g.max_occupancy[f])
                covering = cand[cand >= min(occ, int(self.u[f]))]
                cap = int(covering[0]) if covering.size else int(self.u[f])
                cand = cand[cand <= cap]
            self.candidates.append(cand)
        # Two kinds of per-FIFO floors prune the candidate grids:
        # ``lower_bounds`` — SOUND bounds from task-pair subgraph
        # feasibility (core/prune.py: below them every config
        # deadlocks); ``feasible_floor`` — a certified deadlock-free
        # vector (core/deadlock: above it everywhere, none does).  Only
        # the latter clamps the Baseline-Min probe: with a sound bound
        # alone, all-depth-2 remains the paper's deadlock probe.
        self.feasible_floor = (
            np.asarray(feasible_floor, dtype=np.int64)
            if feasible_floor is not None else None)
        if local_bounds or lower_bounds is not None \
                or feasible_floor is not None:
            if local_bounds and lower_bounds is None:
                from repro_torch.core.prune import local_lower_bounds
                lower_bounds = local_lower_bounds(g, self.candidates)
            lb = np.zeros(g.n_fifos, dtype=np.int64)
            if lower_bounds is not None:
                lb = np.maximum(lb, np.asarray(lower_bounds,
                                               dtype=np.int64))
            if self.feasible_floor is not None:
                lb = np.maximum(lb, self.feasible_floor)
            self.candidates = [
                c[c >= lb[f]] if (c >= lb[f]).any() else c[-1:]
                for f, c in enumerate(self.candidates)]
        self.grid_sizes = np.asarray([len(c) for c in self.candidates])

        # Groups (stream arrays) for the grouped optimizers.  Grouped moves
        # pick ONE index applied to every member; member grids can differ in
        # length, so indices are clipped per member.
        self.groups: List[np.ndarray] = [
            np.asarray(v, dtype=np.int64) for v in g.groups().values()]
        self.group_grid_sizes = np.asarray(
            [max(self.grid_sizes[m].max(), 1) for m in self.groups])

        # Per-fifo depth used for columns a grouped move does not set.
        self._default_depths = np.asarray(
            [c[-1] for c in self.candidates], dtype=np.int64)

        # History.
        self._configs: List[np.ndarray] = []
        self._lat: List[np.ndarray] = []
        self._bram: List[np.ndarray] = []
        self._dead: List[np.ndarray] = []
        self.n_evals = 0

    # ------------------------------------------------------------- depths
    def depths_from_indices(self, idx: np.ndarray) -> np.ndarray:
        """(C, F) grid indices -> (C, F) depths (per-FIFO grids)."""
        idx = np.atleast_2d(idx)
        out = np.empty_like(idx, dtype=np.int64)
        for f in range(self.g.n_fifos):
            cand = self.candidates[f]
            out[:, f] = cand[np.clip(idx[:, f], 0, len(cand) - 1)]
        return out

    def depths_from_group_indices(self, gidx: np.ndarray) -> np.ndarray:
        """(C, n_groups) indices -> (C, F) depths (index shared per group).

        Columns for FIFOs not covered by any group fall back to their
        largest candidate depth (behaviourally unconstrained) instead of
        uninitialized memory.
        """
        gidx = np.atleast_2d(gidx)
        C = gidx.shape[0]
        out = np.tile(self._default_depths, (C, 1))
        for gi, members in enumerate(self.groups):
            for f in members:
                cand = self.candidates[f]
                out[:, f] = cand[np.clip(gidx[:, gi], 0, len(cand) - 1)]
        return out

    def baseline_max(self) -> np.ndarray:
        return self.u.copy()

    def baseline_min(self) -> np.ndarray:
        """The paper's deadlock probe: all-depth-2 — clamped to the
        certified ``feasible_floor`` when one is in force, so
        Baseline-Min stays the minimal configuration *of the searched
        space* (and is then feasible by depth monotonicity)."""
        floor = np.full(self.g.n_fifos, 2, dtype=np.int64)
        if self.feasible_floor is not None:
            floor = np.maximum(floor, self.feasible_floor)
        return floor

    # ---------------------------------------------------------- evaluation
    def record(self, depth_matrix: np.ndarray, lat: np.ndarray,
               bram: np.ndarray, dead: np.ndarray, n_new_evals: int):
        """Append one evaluated batch to the history and count budget.

        Used by :meth:`_finish` and by external schedulers
        (campaign schedulers) that resolve cache misses themselves;
        ``n_new_evals`` is the number of rows that were actually simulated
        (cache misses) — only those count against the budget.

        The config matrix is COPIED into the history: optimizers may (and
        greedy does) keep mutating their working arrays after a request
        resolves, and ``np.asarray``/``atleast_2d`` alias rather than
        copy.
        """
        self.n_evals += int(n_new_evals)
        self._configs.append(np.array(depth_matrix, dtype=np.int64))
        self._lat.append(lat)
        self._bram.append(bram)
        self._dead.append(dead)
        return lat, bram, dead

    def _finish(self, depth_matrix, lat, bram, dead, miss, base=None):
        """Resolve cache misses, record history, count budget.

        Only cache *misses* count against the simulator budget; hits are
        recorded in the shared :class:`ConfigCache` stats.  When ``base``
        is given and the evaluator prefers it, misses go through the
        incremental re-simulation fast path (single-FIFO-move searches)."""
        rows = np.flatnonzero(miss)
        if rows.size:
            sub = depth_matrix[rows]
            if base is not None and self.ev.prefer_incremental:
                l, b, dd = self.ev.evaluate_incremental(base[rows], sub)
            else:
                l, b, dd = self.ev.evaluate(sub)
            lat[rows], bram[rows], dead[rows] = l, b, dd
            self.cache.insert(sub, l, b, dd)
        return self.record(depth_matrix, lat, bram, dead, rows.size)

    def evaluate(self, depth_matrix: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Evaluate configs (cached), record history, count budget."""
        depth_matrix = np.atleast_2d(np.asarray(depth_matrix, dtype=np.int64))
        lat, bram, dead, miss = self.cache.lookup(depth_matrix)
        return self._finish(depth_matrix, lat, bram, dead, miss)

    def evaluate_delta(self, base: np.ndarray, depth_matrix: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Like :meth:`evaluate`, but rows are deltas of known base configs
        (one shared (F,) base or a per-row (C, F) matrix): misses use the
        evaluator's incremental re-simulation when it prefers it."""
        depth_matrix = np.atleast_2d(np.asarray(depth_matrix, dtype=np.int64))
        base = np.atleast_2d(np.asarray(base, dtype=np.int64))
        if base.shape[0] == 1 and depth_matrix.shape[0] > 1:
            base = np.broadcast_to(base, depth_matrix.shape)
        lat, bram, dead, miss = self.cache.lookup(depth_matrix)
        return self._finish(depth_matrix, lat, bram, dead, miss, base=base)

    def evaluate_one(self, depths: np.ndarray) -> Tuple[int, int, bool]:
        lat, bram, dead = self.evaluate(np.asarray(depths)[None, :])
        return int(lat[0]), int(bram[0]), bool(dead[0])

    def evaluate_one_delta(self, base: np.ndarray, depths: np.ndarray
                           ) -> Tuple[int, int, bool]:
        lat, bram, dead = self.evaluate_delta(
            np.asarray(base)[None, :], np.asarray(depths)[None, :])
        return int(lat[0]), int(bram[0]), bool(dead[0])

    def fulfill(self, req: EvalRequest
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Evaluate one :class:`EvalRequest` (cache + history + budget)."""
        with obs.span("fulfill", rows=req.depths.shape[0]) as span:
            n0 = self.n_evals
            if req.base is not None:
                out = self.evaluate_delta(req.base, req.depths)
            else:
                out = self.evaluate(req.depths)
            if span:
                span.set(misses=self.n_evals - n0)
        return out

    def history(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                               np.ndarray, np.ndarray]:
        """Concatenated evaluation history and per-call batch lengths:
        ``(configs (N, F), lat (N,), bram (N,), dead (N,), steps (S,))``.
        The campaign checkpoint serializes exactly this."""
        steps = np.asarray([c.shape[0] for c in self._configs],
                           dtype=np.int64)
        if self._configs:
            cfgs = np.concatenate(self._configs, axis=0)
            lat = np.concatenate(self._lat)
            bram = np.concatenate(self._bram)
            dead = np.concatenate(self._dead)
        else:
            F = self.g.n_fifos
            cfgs = np.zeros((0, F), dtype=np.int64)
            lat = bram = np.zeros(0, dtype=np.int64)
            dead = np.zeros(0, dtype=bool)
        return cfgs, lat, bram, dead, steps

    def result(self, name: str, runtime_s: float) -> OptResult:
        cfgs, lat, bram, dead, _ = self.history()
        return OptResult(name=name, configs=cfgs, latency=lat, bram=bram,
                         deadlock=dead, runtime_s=runtime_s,
                         n_evals=self.n_evals)


class Optimizer:
    """Base class: subclasses implement the ``_steps`` generator.

    The generator yields :class:`EvalRequest` batches and receives the
    evaluated ``(latency, bram, deadlock)`` arrays at the yield point.
    """

    name = "base"

    def __init__(self, ctx: EvalContext, budget: int = 1000):
        self.ctx = ctx
        self.budget = int(budget)
        self._gen = None
        self._pending: Optional[EvalRequest] = None
        self._done = False
        #: wall time spent inside the generator (proposal/acceptance logic,
        #: excluding evaluation) — schedulers add their attributed eval time
        self.step_s = 0.0

    def _steps(self):  # pragma: no cover - interface
        """Yield :class:`EvalRequest`; receive ``(lat, bram, dead)``."""
        raise NotImplementedError
        yield

    # ------------------------------------------------------- stepwise API
    def start(self) -> None:
        """Prime the generator up to its first proposal (idempotent)."""
        if self._gen is None and not self._done:
            self._gen = self._steps()
            self._advance(None)

    def _advance(self, results) -> None:
        with obs.span("optimizer.step") as span:
            t0 = time.perf_counter()
            try:
                if results is None:
                    self._pending = next(self._gen)
                else:
                    self._pending = self._gen.send(results)
            except StopIteration:
                self._pending = None
                self._done = True
            finally:
                self.step_s += time.perf_counter() - t0
            if span and self._pending is not None:
                span.set(rows=self._pending.depths.shape[0])

    def propose(self) -> Optional[EvalRequest]:
        """The outstanding batch to evaluate; None once the search ended."""
        self.start()
        return self._pending

    def observe(self, lat: np.ndarray, bram: np.ndarray,
                dead: np.ndarray) -> None:
        """Deliver results for the outstanding proposal and step once."""
        if self._pending is None:
            raise RuntimeError(
                f"{self.name}: observe() without a pending proposal")
        self._advance((np.asarray(lat), np.asarray(bram), np.asarray(dead)))

    @property
    def done(self) -> bool:
        return self._done

    def close(self) -> None:
        """Terminate the search now (generator cleanup runs); further
        :meth:`propose` calls return None.  The history evaluated so
        far remains valid — this is how the advisory service cancels a
        session mid-run."""
        if self._gen is not None:
            self._gen.close()
        self._pending = None
        self._done = True

    # ------------------------------------------------------- blocking API
    def run(self) -> OptResult:
        """Drive ``_steps`` to completion against this optimizer's ctx."""
        t0 = time.perf_counter()
        while True:
            req = self.propose()
            if req is None:
                break
            lat, bram, dead = self.ctx.fulfill(req)
            self.observe(lat, bram, dead)
        return self.ctx.result(self.name, time.perf_counter() - t0)
