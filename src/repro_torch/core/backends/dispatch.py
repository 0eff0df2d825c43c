"""Tiered dispatch policy: bucketing and escalation, and the rung cascade.

1. **Bucketing** — backends that want it (``wants_bucketing``) receive
   batches padded up to a small fixed set of sizes (:data:`BUCKETS`, kept
   from the reference so dispatch counts compare).  Padding repeats the
   final row; pad results are sliced off.
2. **Status resolution** — DEADLOCK rows become infeasible (-1 latency);
   CONVERGED rows pass through.
3. **Escalation** — UNRESOLVED rows (the iteration cap fired before the
   fixpoint converged) are re-solved exactly, counted in
   ``stats.n_fallbacks``.  This is the algorithm, not a fallback: the
   reference escalates the same rows.  Where the backend runs K2 on a
   CUDA device (``device_escalation``), one K2 launch at
   :data:`~repro_torch.core.backends.base.ESCALATION_ITERS` settles them
   first: its CONVERGED rows are exact and its DEADLOCK rows deadlocked,
   as at the first cap (iterates from zero are lower bounds of the least
   fixpoint, so over the bound is a deadlock).  The worklist arbiter
   solves the rows still UNRESOLVED.

:class:`RungCascade` owns the condensation escalation ladder: route each
row through the most aggressive admissible rung, accept rows whose
exactness certificate passes (or whose relaxed solve already proves
deadlock), and fall through rung by rung to the raw dispatch backstop.
Kernel-backed rung evaluators certify on the device
(``fused_certificate``); the rest return event times for the host-side
``condense.verify_rows``.

:class:`HeteroDispatcher` extends the same concerns across *designs*: one
K2 launch in its per-design-table mode over a shared ``E*/F*/R*``
envelope, the same padding (:func:`pad_rows` to :func:`target_rows`, as
in the backends) and the same escalation routine.  torch is imported
lazily, so this module stays importable in the numpy-only worker
processes.

Spans (:mod:`repro_torch.obs`): ``escalation``, one a dispatch with
UNRESOLVED rows, around the tier's launch and every worklist call
(``rows``; ``device``: the rows K2 settled, only where the tier runs);
``cascade.rung`` (``rows``, ``accepted``) for each rung tried;
``hetero.stack`` around packing a cross-design batch.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core.backends.base import (CONVERGED, DEADLOCK,
                                            ESCALATION_ITERS,
                                            F32_EXACT_LIMIT, EvalBackend,
                                            UNRESOLVED, resolve_device)
from repro_torch.core.backends.worklist import WorklistBackend

BUCKETS = (1, 8, 32, 128, 512, 2048)


def target_rows(c: int, buckets: Sequence[int], shard_multiple: int
                ) -> int:
    """The rows a batch of ``c`` is padded to: the smallest of ``buckets``
    that covers it (``c`` itself above the last), rounded up to a
    multiple of ``shard_multiple``."""
    target = next((b for b in buckets if b >= c), c)
    return -(-target // shard_multiple) * shard_multiple


def pad_rows(target: int, *row_arrays: np.ndarray) -> Tuple[np.ndarray, ...]:
    """Each of ``row_arrays`` padded to ``target`` rows by repeating its
    last row (as it is where it has them already)."""
    return tuple(a if a.shape[0] >= target else np.concatenate(
        [a, np.repeat(a[-1:], target - a.shape[0], axis=0)])
        for a in row_arrays)


def _settle(rows: np.ndarray, answer: tuple, lat: np.ndarray,
            dead: np.ndarray) -> np.ndarray:
    """Write the ``rows`` that ``answer``, ``(latency, ..., status)`` of
    each row, resolves into ``lat`` and ``dead``; returns the rows still
    UNRESOLVED."""
    r_lat, r_status = answer[0], answer[-1]
    done = r_status != UNRESOLVED
    lat[rows[done]] = r_lat[done]
    dead[rows[done]] = r_status[done] == DEADLOCK
    return rows[~done]


def _escalate(rows: np.ndarray, tier: Optional[Callable], solve: Callable,
              lat: np.ndarray, dead: np.ndarray) -> None:
    """Settle the UNRESOLVED ``rows`` (indices into ``lat`` and ``dead``)
    in one ``escalation`` span: ``tier(rows)`` first where there is one
    (the span's ``device``: the rows it settled), then ``solve(rest)``,
    the worklist, on the rest; each answers ``(latency, ..., status)``."""
    with obs.span("escalation", rows=int(rows.size)) as span:
        if tier is not None:
            rest = _settle(rows, tier(rows), lat, dead)
            span.set(device=int(rows.size - rest.size))
            rows = rest
        if rows.size:
            _settle(rows, solve(rows), lat, dead)


class DispatchPolicy:
    """Routes depth batches through a backend and resolves every row.

    ``shard_multiple`` (the backend's mesh size; 1 = unsharded) rounds
    every padded batch up to a shard multiple, so the sharded evaluators
    split rows evenly across devices.
    """

    def __init__(self, worklist: WorklistBackend,
                 buckets: Tuple[int, ...] = BUCKETS,
                 shard_multiple: int = 1):
        self.worklist = worklist
        self.buckets = tuple(buckets)
        self.shard_multiple = max(1, int(shard_multiple))

    def pad_batch(self, m: np.ndarray) -> np.ndarray:
        """Pad C up to the covering bucket (rounded to a shard multiple)
        by repeating the last row."""
        return pad_rows(target_rows(m.shape[0], self.buckets,
                                    self.shard_multiple), m)[0]

    def dispatch(self, backend: EvalBackend, depth_matrix: np.ndarray,
                 stats=None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(C, F) depths -> (latency int64, bram int64, deadlock bool)."""
        m = np.atleast_2d(np.asarray(depth_matrix))
        lat, bram, status = self.launch(backend, m)
        lat, dead = self.settle(backend, m, lat, status, stats)
        return lat, bram, dead

    def launch(self, backend: EvalBackend, m: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(C, F) depths -> (latency, bram, status) at the backend's first
        cap, UNRESOLVED rows left as they are."""
        C = m.shape[0]
        batch = self.pad_batch(m) if backend.wants_bucketing else m
        lat, bram, status = backend.evaluate(batch)
        return lat[:C], bram[:C], status[:C]

    def settle(self, backend: EvalBackend, m: np.ndarray, lat: np.ndarray,
               status: np.ndarray, stats=None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Escalates the UNRESOLVED rows of a :meth:`launch` of ``m``:
        ``(latency, deadlock)``, -1 latency on deadlocked rows."""
        dead = status == DEADLOCK
        unresolved = np.flatnonzero(status == UNRESOLVED)
        if unresolved.size:
            _escalate(unresolved, (lambda r: backend.escalate(m[r]))
                      if backend.device_escalation else None,
                      lambda r: self.worklist.evaluate(m[r]), lat, dead)
            if stats is not None:
                stats.n_fallbacks += int(unresolved.size)
        return np.where(dead, -1, lat), dead


class RungCascade:
    """The condensation escalation ladder over certified rungs.

    ``rungs`` is the ordered ``[(CondensedGraph, prepared backend), ...]``
    list (most aggressive first); ``policy`` the shared
    :class:`DispatchPolicy`; ``primary`` the raw-graph backend used as
    the unconditional backstop.  Per rung, rows inside the rung's
    routing box are evaluated on the condensed stream and accepted when

    * the relaxed solve proves DEADLOCK (sound: the condensed fixpoint
      is a lower bound of the raw one), or
    * the row CONVERGED and its exactness certificate passes.

    Certification runs one of two ways:

    * **fused** — kernel-backed rung evaluators
      (``backend.fused_certificate``) evaluate and certify in ONE device
      program via ``evaluate_certified``; the event-time matrix never
      reaches the host, so a fully-certifying batch costs exactly one
      dispatch (asserted by the device-residency regression tests);
    * **host** — scan/worklist evaluators return per-anchor times
      (``evaluate_with_times``) and ``condense.verify_rows`` checks the
      folded cross constraints on the host.

    Everything still pending after the last rung goes to the raw
    dispatch backstop (bucketing + UNRESOLVED worklist escalation).
    """

    def __init__(self, rungs, policy: DispatchPolicy,
                 primary: EvalBackend):
        self.rungs = list(rungs)
        self.policy = policy
        self.primary = primary

    def evaluate(self, m: np.ndarray, stats=None
                 ) -> Tuple[np.ndarray, np.ndarray]:
        """Unique (C, F) rows -> exact ``(latency i64, deadlock bool)``
        with -1 latency on deadlocked rows."""
        m = np.asarray(m, dtype=np.int64)
        lat, status = self.launch(m, stats)
        return self.policy.settle(self.primary, m, lat, status, stats)

    def launch(self, m: np.ndarray, stats=None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Unique (C, F) int64 rows -> ``(latency i64, status)``: the rungs,
        then the raw backstop at its first cap, whose UNRESOLVED rows are
        left for :meth:`DispatchPolicy.settle`."""
        C = m.shape[0]
        lat = np.zeros(C, dtype=np.int64)
        status = np.full(C, CONVERGED, dtype=np.int8)
        pending = np.ones(C, dtype=bool)
        for cg, impl in self.rungs:
            sel = np.flatnonzero(pending & cg.in_box(m))
            if not sel.size:
                continue
            with obs.span("cascade.rung", rows=int(sel.size)) as span:
                rlat, dl, ok = self._rung(cg, impl, m[sel])
                acc = dl | ok
                if span:
                    span.set(accepted=int(acc.sum()))
            if stats is not None:
                stats.n_cond_fail += int(sel.size - acc.sum())
            if acc.any():
                idx = sel[acc]
                lat[idx] = rlat[acc]
                status[idx] = np.where(dl[acc], DEADLOCK, CONVERGED)
                pending[idx] = False
                if stats is not None:
                    stats.n_condensed += int(acc.sum())
            if not pending.any():
                break
        rem = np.flatnonzero(pending)
        if rem.size:
            lat[rem], _, status[rem] = self.policy.launch(self.primary,
                                                          m[rem])
        return lat, status

    def _rung(self, cg, impl, rows: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One rung over its routed ``rows``: ``(latency, deadlock, the
        certificate passed)`` per row."""
        n = rows.shape[0]
        fused = impl.fused_certificate
        # the fused kernel path buckets too, as the reference's does
        # (routing kept so dispatch counts compare)
        batch = self.policy.pad_batch(rows) \
            if impl.wants_bucketing or fused else rows
        if fused:       # a DEADLOCK is sound: the relaxed system stalls
            rlat, _, rstatus, ok = impl.evaluate_certified(batch)
            return rlat[:n], rstatus[:n] == DEADLOCK, ok[:n]
        from repro_torch.core.condense import verify_rows
        rlat, _, rstatus, times = impl.evaluate_with_times(batch)
        rlat, rstatus = rlat[:n], rstatus[:n]
        times = times[:n, : cg.n_events]
        ok = np.zeros(n, dtype=bool)
        conv = rstatus == CONVERGED
        if conv.any():
            ci = np.flatnonzero(conv)
            ok[ci] = verify_rows(cg, rows[ci], times[ci])
        return rlat, rstatus == DEADLOCK, ok


@dataclasses.dataclass
class HeteroStats:
    n_dispatches: int = 0
    n_rows: int = 0          # real rows evaluated
    n_pad_rows: int = 0      # bucket-padding overhead rows
    n_fallbacks: int = 0     # UNRESOLVED rows escalated to a worklist
    wall_s: float = 0.0


class HeteroDispatcher:
    """One vectorized dispatch for rows spanning MANY designs.

    Built once per campaign from every participating graph: computes the
    shared ``(E*, F*, R*)`` envelope, re-pads each design's operands to
    it, and keeps every design's tables ONCE on the device
    (:class:`~repro_torch.core.backends.operands.HeteroTables`).  A
    dispatch sends each row's table index and depths, padded to a bucket
    of :attr:`BUCKETS` (the reference's sizes), through one launch.
    UNRESOLVED rows are escalated as by :class:`DispatchPolicy`: on a
    CUDA device (:attr:`device_escalation`) those of every design in one
    K2 launch at :attr:`escalation_iters` over the same tables, then what
    is left to the owning design's worklist, one call an item.
    ``device=None`` means ``cuda``.

    ``mesh`` (or ``shards``, a 1-D eval mesh over that many devices of
    ``device``'s kind) partitions the packed batch over the mesh's
    devices: rows are stacked design-major, so a 2-D ``("design",
    "eval")`` mesh puts contiguous design blocks on contiguous device
    groups.  Batches are padded to a shard multiple, and every shard
    launches its own kernel; the tables are copied once to each device.
    """

    #: finer-grained than BUCKETS: cross-design batches vary more in size
    BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096)
    #: the cap of the escalation launch
    escalation_iters = ESCALATION_ITERS

    def __init__(self, graphs: Dict[str, object],
                 worklists: Optional[Dict[str, WorklistBackend]] = None,
                 max_iters: int = 64,
                 buckets: Sequence[int] = BUCKETS,
                 mesh=None, shards: Optional[int] = None, device=None):
        from repro_torch.core.backends.operands import get_operands
        from repro_torch.kernels.fifo_eval.ops import \
            make_hetero_batched_eval
        self.max_iters = int(max_iters)
        if mesh is None and shards is not None:
            from repro_torch.launch.mesh import make_eval_mesh
            mesh = make_eval_mesh(shards, device=device)
        self.mesh = mesh
        self.shard_multiple = mesh.size if mesh is not None else 1
        self.device = resolve_device(
            mesh.devices[0] if device is None and mesh is not None
            else device)
        self.e_pad = 0
        self.f_max = 0
        self.r_max = 0
        self._base: Dict[str, object] = {}   # per-design host operands
        self._ext: Dict[str, object] = {}    # envelope-padded operands
        self._slot: Dict[str, int] = {}      # design -> table row
        self._tables = None                  # HeteroTables on the device
        self.worklists: Dict[str, WorklistBackend] = {}
        self._call = make_hetero_batched_eval(max_iters, device=self.device,
                                              mesh=mesh)
        # unpadded, on the first device of a mesh
        self._escalate = make_hetero_batched_eval(
            self.escalation_iters, device=self.device) \
            if self.device_escalation else None
        self.buckets = tuple(buckets)
        self.stats = HeteroStats()
        worklists = worklists or {}
        if graphs:
            # pre-compute the shared envelope so registering N designs
            # pads each exactly once (growth re-pads would be O(N^2))
            opses = [get_operands(g, "cpu") for g in graphs.values()]
            self.e_pad = max(o.e_pad for o in opses)
            self.f_max = max(o.n_fifos for o in opses)
            self.r_max = max(o.n_flat_reads for o in opses)
        for k, g in graphs.items():
            self.add_design(k, g, worklists.get(k))

    @property
    def device_escalation(self) -> bool:
        """Whether UNRESOLVED rows go through K2 at
        :attr:`escalation_iters` before the worklists: on a CUDA device."""
        return self.device.type == "cuda"

    def add_design(self, key: str, graph,
                   worklist: Optional[WorklistBackend] = None) -> None:
        """Register a design after construction (idempotent per key).

        If the new design fits the current ``(E*, F*, R*)`` envelope,
        only its own operands are padded; if it exceeds it, every
        registered design is re-padded from its host operands.  Either
        way the device tables are stacked anew.
        """
        if key in self._ext:
            return
        from repro_torch.core.backends.operands import (extend_operands,
                                                        get_operands,
                                                        stack_tables)
        # the f32 fixpoint is only exact while times stay below 2**24
        if graph.latency_upper_bound() > F32_EXACT_LIMIT:
            raise ValueError(
                f"design {key!r}: schedule bound exceeds the "
                "float32-exact domain; split the design or reduce "
                "trip counts")
        ops = get_operands(graph, "cpu")
        self._base[key] = ops
        grew = (ops.e_pad > self.e_pad or ops.n_fifos > self.f_max
                or ops.n_flat_reads > self.r_max)
        self.e_pad = max(self.e_pad, ops.e_pad)
        self.f_max = max(self.f_max, ops.n_fifos)
        self.r_max = max(self.r_max, ops.n_flat_reads)
        if grew:
            self._ext = {k: extend_operands(o, self.e_pad, self.f_max,
                                            self.r_max)
                         for k, o in self._base.items()}
        else:
            self._ext[key] = extend_operands(ops, self.e_pad, self.f_max,
                                             self.r_max)
        self._slot = {k: i for i, k in enumerate(self._ext)}
        self._tables = stack_tables(list(self._ext.values()), self.device)
        if worklist is None:
            worklist = WorklistBackend(max_iters=self.max_iters)
            worklist.prepare(graph)
        self.worklists[key] = worklist

    def dispatch(self, items: List[Tuple[str, np.ndarray]]
                 ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """``[(design_key, (c_i, F_i) depths), ...]`` -> per-item results.

        Every returned triple is exact ``(latency i64, bram i64,
        deadlock bool)`` with -1 latency on deadlocked rows.
        """
        from repro_torch.core.backends.operands import stack_rows
        t_start = time.perf_counter()
        mats = [np.atleast_2d(np.asarray(m, dtype=np.int64))
                for _, m in items]
        with obs.span("hetero.stack"):
            table_of_row, depths = stack_rows(
                [(self._slot[k], m) for (k, _), m in zip(items, mats)],
                self.f_max)
            C = depths.shape[0]
            table_of_row, depths = pad_rows(
                target_rows(C, self.buckets, self.shard_multiple),
                table_of_row, depths)
        lat, bram, status = self._call(self._tables, table_of_row, depths)
        lat, bram, status = lat[:C], bram[:C], status[:C]
        dead = status == DEADLOCK
        unresolved = np.flatnonzero(status == UNRESOLVED)
        row0 = np.cumsum([0] + [m.shape[0] for m in mats])
        if unresolved.size:
            _escalate(unresolved, (lambda r: self._escalate(
                self._tables, table_of_row[r], depths[r]))
                if self._escalate is not None else None,
                lambda r: self._worklists(items, mats, row0, r), lat, dead)
        self.stats.n_fallbacks += int(unresolved.size)
        lat = np.where(dead, -1, lat)
        out = [(lat[a:b], bram[a:b], dead[a:b])
               for a, b in zip(row0[:-1], row0[1:])]
        self.stats.n_dispatches += 1
        self.stats.n_rows += C
        self.stats.n_pad_rows += depths.shape[0] - C
        self.stats.wall_s += time.perf_counter() - t_start
        return out

    def _worklists(self, items, mats, row0: np.ndarray, rows: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """``(latency, status)`` of the ``rows`` (indices into the stacked
        batch) from each item's worklist, one call an item."""
        owner = np.searchsorted(row0, rows, side="right") - 1
        lat = np.empty(rows.size, dtype=np.int64)
        status = np.empty(rows.size, dtype=np.int8)
        for i in np.unique(owner):
            mine = owner == i
            lat[mine], _, status[mine] = self.worklists[items[i][0]].evaluate(
                mats[i][rows[mine] - row0[i]])
        return lat, status
