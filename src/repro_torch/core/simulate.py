"""Trace-based batched FIFO-latency evaluation (the LightningSim core).

The stable façade over :mod:`repro_torch.core.backends`:

``evaluate_np``
    Kahn-worklist longest-path solve, one config at a time; the arbiter
    for the rows the batched path cannot classify within its cap.

``BatchedEvaluator``
    Thin façade over the backend registry.  ``EvalConfig.backend``:

    ``"cuda"`` (alias ``"pallas"``, default) — the hand-written CUDA
        kernels (their plain torch versions on ``device="cpu"``).
    ``"fixpoint"`` (alias ``"jax"``) — the plain torch fixpoint.
    ``"numpy"`` (alias ``"worklist"``) — the event-driven worklist, with
        the incremental fast path ``evaluate_incremental``.
    ``"auto"`` — one-shot per-design calibration: the fastest of the
        numpy worklist and the device's tensor backend on a probe batch.

    The tensor backends take ``device=None`` (CUDA, raising without a
    card) or an explicit device.  Batch bucketing and UNRESOLVED-row
    escalation live in :class:`repro_torch.core.backends.DispatchPolicy`,
    the condensation ladder in :class:`~repro_torch.core.backends
    .RungCascade`.

Each :meth:`BatchedEvaluator.evaluate` call is one :mod:`repro_torch.obs`
span, ``evaluate`` (``rows``; ``unique``: the rows left after
deduplication), and so is each of the certifier's speculative calls
(``_launch_unsettled``), whose UNRESOLVED rows the certifier escalates
one at a time, as its walk visits them (``_settle``).

Numeric domain: times are exact in float32 while below 2**24; the design's
schedule upper bound must stay below 1.5e7 cycles.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core.backends import (BIG, CONVERGED, DEADLOCK,
                                       F32_EXACT_LIMIT, UNRESOLVED,
                                       DispatchPolicy, RungCascade,
                                       WorklistBackend, evaluate_np,
                                       get_backend, resolve_device)
from repro_torch.core.backends.worklist import WorklistState
from repro_torch.core.bram import design_bram_np
from repro_torch.core.config import EvalConfig
from repro_torch.core.simgraph import SimGraph

__all__ = [
    "BIG", "CONVERGED", "DEADLOCK", "F32_EXACT_LIMIT", "UNRESOLVED",
    "BatchStats", "BatchedEvaluator", "evaluate_np",
]


@dataclasses.dataclass
class BatchStats:
    n_calls: int = 0
    n_configs: int = 0
    n_fallbacks: int = 0
    n_incremental: int = 0
    n_dedup: int = 0          # duplicate in-batch rows solved once
    n_condensed: int = 0      # rows resolved on a condensed rung
    n_cond_fail: int = 0      # rung attempts whose certificate failed


#: the reference's BatchedEvaluator default (the advisor default is 256)
_EVALUATOR_DEFAULT = EvalConfig(max_iters=64)


class BatchedEvaluator:
    """Exact evaluation of candidate depth matrices on one graph.

    ``config`` is the shared :class:`~repro_torch.core.config.EvalConfig`.
    Runtime objects stay explicit keywords: ``rungs`` is a prebuilt
    :class:`~repro_torch.core.condense.CondensedGraph` (or list) to use
    verbatim, ``device`` the torch device of the tensor backends
    (``None`` = CUDA), and ``mesh`` an explicit
    :class:`repro_torch.launch.mesh.Mesh`.  A mesh or ``config.shards``
    selects the sharded ``"mesh"`` backend, as in the reference.
    """

    #: how many solved worklist states to keep for incremental re-solves
    STATE_CACHE_CAP = 128

    def __init__(self, g: SimGraph, config: Optional[EvalConfig] = None,
                 *, rungs=None, device=None, mesh=None):
        config = config if config is not None else _EVALUATOR_DEFAULT
        if g.latency_upper_bound() > F32_EXACT_LIMIT:
            raise ValueError(
                "design schedule bound exceeds float32-exact domain; "
                "split the design or reduce trip counts")
        self.g = g
        self.max_iters = config.max_iters
        self.stats = BatchStats()
        self.device = device
        self.calibration = None
        backend = config.backend
        if (mesh is not None or config.shards is not None) \
                and backend not in ("mesh", "sharded"):
            backend = "mesh"
        if backend == "auto":
            backend = self._calibrate()
        self.config = config.replace(backend=backend)
        self.backend = backend
        if backend in ("mesh", "sharded"):
            from repro_torch.core.backends.mesh import MeshBackend
            self._impl = MeshBackend(max_iters=self.max_iters, mesh=mesh,
                                     shards=config.shards, device=device)
        else:
            self._impl = get_backend(backend)(max_iters=self.max_iters,
                                              device=device)
        self._impl.prepare(g)
        if isinstance(self._impl, WorklistBackend):
            self._worklist = self._impl
        else:
            self._worklist = WorklistBackend(max_iters=self.max_iters)
            self._worklist.prepare(g)
        self.dispatch = DispatchPolicy(
            self._worklist,
            shard_multiple=getattr(self._impl, "shard_multiple", 1))
        self._states: "OrderedDict[bytes, WorklistState]" = OrderedDict()
        self.condensation = self._build_cascade(
            config.condense if rungs is None else rungs)
        self._cascade = RungCascade(self.condensation, self.dispatch,
                                    self._impl) if self.condensation \
            else None

    # ------------------------------------------------------- condensation
    def _build_cascade(self, condense):
        """Condense once per evaluator: ``"auto"`` builds (and caches on
        the graph) the default rung cascade for the batched backends; an
        explicit CondensedGraph or list (``rungs=``) is used verbatim;
        None disables condensation.  The per-row worklist's cost is bound
        by wake-wave count rather than event count, so ``"auto"`` skips
        it there."""
        if condense is None:
            return []
        if condense == "auto":
            if isinstance(self._impl, WorklistBackend):
                return []
            cgs = getattr(self.g, "_cascade_cache", None)
            if cgs is None:
                from repro_torch.core.condense import condense_auto
                cgs = condense_auto(self.g)
                self.g._cascade_cache = cgs
            # aggressive first: per-iteration cost is proportional to
            # E_pad, and folding the back-pressure anchors away also
            # slashes the Jacobi iteration count
            by_tag = {cg.tag: cg for cg in cgs}
            cgs = [by_tag[t] for t in ("aggressive", "safe") if t in by_tag]
        else:
            cgs = list(condense) if isinstance(condense, (list, tuple)) \
                else [condense]
        rungs = []
        for cg in cgs:
            impl = self._impl.spawn()   # keeps the primary's device
            impl.prepare(cg)
            rungs.append((cg, impl))
        return rungs

    def _calibrate(self) -> str:
        """One-shot per-design backend calibration (``backend="auto"``).

        Times each candidate through the same evaluation path production
        uses — a full ``BatchedEvaluator`` with its condensation cascade,
        on a DSE-representative 16-row batch — and picks the fastest.
        The candidates are the numpy worklist and the tensor backend of
        this evaluator's device: the CUDA kernels on a CUDA device, the
        plain torch fixpoint on the CPU (the kernels' plain versions are
        their CPU oracle, not a contender there), plus the row-sharded
        mesh over every card when ``device`` is ``"cuda"`` and the host
        has more than one.  The probe timings are kept in
        ``self.calibration``.
        """
        import torch
        dev = resolve_device(self.device)
        candidates = ["numpy", "cuda" if dev.type == "cuda" else "fixpoint"]
        if dev.type == "cuda" and dev.index is None \
                and torch.cuda.device_count() > 1:
            candidates.append("mesh")
        u = np.asarray(self.g.upper_bounds, dtype=np.int64)
        rng = np.random.default_rng(0)
        probe = np.stack([np.maximum(
            2, (u * rng.uniform(0.5, 1.0, u.size)).astype(np.int64))
            for _ in range(16)])
        timings = {}
        for name in candidates:
            ev = BatchedEvaluator(self.g, EvalConfig(
                backend=name, max_iters=self.max_iters), device=dev)
            ev.evaluate(probe)                # warm (kernel build)
            t0 = time.perf_counter()
            ev.evaluate(probe)
            timings[name] = time.perf_counter() - t0
        chosen = min(timings, key=timings.get)
        self.calibration = {"chosen": chosen, "probe_s": timings}
        return chosen

    # ------------------------------------------------------------------
    def evaluate(self, depth_matrix: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(C, F) int depths -> (latency int64, bram int64, deadlock bool).

        Duplicate rows within the batch are solved once and scattered
        back; the rest goes through the rung cascade (when condensation
        is on) and the dispatch policy; -1 latency on deadlocked rows.
        """
        depth_matrix = np.atleast_2d(np.asarray(depth_matrix))
        C = depth_matrix.shape[0]
        with obs.span("evaluate", rows=C) as span:
            uniq, inverse = np.unique(depth_matrix, axis=0,
                                      return_inverse=True)
            if span:
                span.set(unique=uniq.shape[0])
            if uniq.shape[0] < C:
                lat, bram, dead = self._eval_rows(uniq)
                inverse = inverse.reshape(-1)
                lat, bram, dead = lat[inverse], bram[inverse], dead[inverse]
                self.stats.n_dedup += C - uniq.shape[0]
            else:
                lat, bram, dead = self._eval_rows(depth_matrix)
        self.stats.n_calls += 1
        self.stats.n_configs += C
        return lat, bram, dead

    def _eval_rows(self, m: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if self._cascade is None:
            return self.dispatch.dispatch(self._impl, m, self.stats)
        m = np.asarray(m, dtype=np.int64)
        lat, dead = self._cascade.evaluate(m, self.stats)
        bram = design_bram_np(m, np.asarray(self.g.widths))
        return lat, bram, dead

    # ------------------------------------ the certifier's speculative calls
    @property
    def _pays_per_launch(self) -> bool:
        """Whether a call of a few rows costs about what a call of one
        does: a tensor backend on a CUDA device, where a probe's time is
        the launch's host work and one K2 launch.  The certifier then
        bisects several levels a call."""
        dev = getattr(self._impl, "device", None)
        return (not self.prefer_incremental
                and getattr(dev, "type", None) == "cuda")

    def _launch_unsettled(self, m: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One evaluator call over distinct (C, F) rows, counted as
        :meth:`evaluate` counts one: ``(latency, bram, status)`` through
        the rung cascade and the raw backend at its first cap, the
        UNRESOLVED rows left for :meth:`_settle`."""
        m = np.asarray(m, dtype=np.int64)
        C = m.shape[0]
        with obs.span("evaluate", rows=C, unique=C):
            if self._cascade is None:
                out = self.dispatch.launch(self._impl, m)
            else:
                lat, status = self._cascade.launch(m, self.stats)
                out = (lat, design_bram_np(m, np.asarray(self.g.widths)),
                       status)
        self.stats.n_calls += 1
        self.stats.n_configs += C
        return out

    def _settle(self, row: np.ndarray, lat: int, status: int
                ) -> Tuple[int, bool]:
        """``(latency, deadlock)`` of one row of :meth:`_launch_unsettled`,
        escalated as :meth:`evaluate` escalates it where UNRESOLVED; -1
        latency on a deadlock."""
        lat, dead = self.dispatch.settle(
            self._impl, np.asarray(row, dtype=np.int64)[None, :],
            np.array([lat], dtype=np.int64), np.array([status]), self.stats)
        return int(lat[0]), bool(dead[0])

    # ------------------------------------------------ incremental fast path
    @property
    def prefer_incremental(self) -> bool:
        """Whether single-FIFO-move searches should use the delta path
        (only when the primary backend is the worklist itself)."""
        return self._impl is self._worklist

    def _state_for(self, depths: np.ndarray) -> WorklistState:
        key = depths.tobytes()
        st = self._states.get(key)
        if st is None:
            st = self._worklist.solve(depths)
            self._remember(key, st)
        else:
            self._states.move_to_end(key)
        return st

    def _remember(self, key: bytes, st: WorklistState):
        self._states[key] = st
        self._states.move_to_end(key)
        while len(self._states) > self.STATE_CACHE_CAP:
            self._states.popitem(last=False)

    def evaluate_incremental(self, base_depths: Optional[np.ndarray],
                             depth_matrix: np.ndarray
                             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Incremental (latency, bram, deadlock) against base config(s):
        ``base_depths`` is one (F,) row, a (C, F) matrix, or None (full
        solves, states cached for future deltas)."""
        m = np.atleast_2d(np.asarray(depth_matrix, dtype=np.int64))
        C = m.shape[0]
        base = None
        if base_depths is not None:
            base = np.atleast_2d(np.asarray(base_depths, dtype=np.int64))
            if base.shape[0] == 1 and C > 1:
                base = np.broadcast_to(base, m.shape)
        lat = np.zeros(C, dtype=np.int64)
        dead = np.zeros(C, dtype=bool)
        for i in range(C):
            if base is None:
                st = self._state_for(m[i])
            else:
                base_st = self._state_for(base[i])
                st = self._worklist.solve_delta(base_st, m[i])
                self._remember(m[i].tobytes(), st)
            lat[i] = st.latency
            dead[i] = st.deadlocked
        bram = design_bram_np(m, np.asarray(self.g.widths))
        self.stats.n_calls += 1
        self.stats.n_configs += C
        self.stats.n_incremental += C
        return lat, bram, dead

    @property
    def incr_stats(self):
        return self._worklist.incr_stats

    def condensation_info(self) -> list:
        """Per-rung condensation summary: tag, raw/condensed event counts,
        and the compression ratio."""
        return [{"tag": cg.tag,
                 "events_raw": cg.n_raw_events,
                 "events_condensed": cg.n_events,
                 "compression": round(cg.compression, 2)}
                for cg, _ in self.condensation]

    # convenience -------------------------------------------------------
    def evaluate_one(self, depths: np.ndarray) -> Tuple[int, int, bool]:
        lat, bram, dead = self.evaluate(np.asarray(depths)[None, :])
        return int(lat[0]), int(bram[0]), bool(dead[0])

    def bram_only(self, depth_matrix: np.ndarray) -> np.ndarray:
        return design_bram_np(np.asarray(depth_matrix, dtype=np.int64),
                              np.asarray(self.g.widths))
