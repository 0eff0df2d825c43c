"""Tiered dispatch policy: bucketing and escalation, and the rung cascade.

1. **Bucketing** — backends that want it (``wants_bucketing``) receive
   batches padded up to a small fixed set of sizes (:data:`BUCKETS`, kept
   from the reference so dispatch counts compare).  Padding repeats the
   final row; pad results are sliced off.
2. **Status resolution** — DEADLOCK rows become infeasible (-1 latency);
   CONVERGED rows pass through.
3. **Escalation** — UNRESOLVED rows (the iteration cap fired before the
   fixpoint converged) are re-solved exactly by the worklist arbiter,
   counted in ``stats.n_fallbacks``.  This is the algorithm, not a
   fallback: the reference escalates the same rows.

:class:`RungCascade` owns the condensation escalation ladder: route each
row through the most aggressive admissible rung, accept rows whose
exactness certificate passes (or whose relaxed solve already proves
deadlock), and fall through rung by rung to the raw dispatch backstop.
Kernel-backed rung evaluators certify on the device
(``fused_certificate``); the rest return event times for the host-side
``condense.verify_rows``.

The reference's cross-design ``HeteroDispatcher`` waits for ROADMAP P10.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.core.backends.base import (CONVERGED, DEADLOCK, EvalBackend,
                                            UNRESOLVED)
from repro_torch.core.backends.worklist import WorklistBackend

BUCKETS = (1, 8, 32, 128, 512, 2048)


class DispatchPolicy:
    """Routes depth batches through a backend and resolves every row."""

    def __init__(self, worklist: WorklistBackend,
                 buckets: Tuple[int, ...] = BUCKETS):
        self.worklist = worklist
        self.buckets = tuple(buckets)

    def bucket_size(self, c: int) -> Optional[int]:
        return next((b for b in self.buckets if b >= c), None)

    def pad_batch(self, m: np.ndarray) -> np.ndarray:
        """Pad C up to the covering bucket by repeating the last row."""
        c = m.shape[0]
        bucket = self.bucket_size(c)
        target = c if bucket is None else bucket
        if target == c:
            return m
        pad = np.repeat(m[-1:], target - c, axis=0)
        return np.concatenate([m, pad], axis=0)

    def dispatch(self, backend: EvalBackend, depth_matrix: np.ndarray,
                 stats=None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(C, F) depths -> (latency int64, bram int64, deadlock bool)."""
        m = np.atleast_2d(np.asarray(depth_matrix))
        C = m.shape[0]
        batch = self.pad_batch(m) if backend.wants_bucketing else m
        lat, bram, status = backend.evaluate(batch)
        lat, bram, status = lat[:C], bram[:C], status[:C]

        dead = status == DEADLOCK
        unresolved = np.flatnonzero(status == UNRESOLVED)
        if unresolved.size:
            wl_lat, _, wl_status = self.worklist.evaluate(m[unresolved])
            lat[unresolved] = wl_lat
            dead[unresolved] = wl_status == DEADLOCK
            if stats is not None:
                stats.n_fallbacks += int(unresolved.size)
        lat = np.where(dead, -1, lat)
        return lat, bram, dead


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
        from repro_torch.core.condense import verify_rows
        m = np.asarray(m, dtype=np.int64)
        C = m.shape[0]
        lat = np.zeros(C, dtype=np.int64)
        dead = np.zeros(C, dtype=bool)
        pending = np.ones(C, dtype=bool)
        for cg, impl in self.rungs:
            sel = np.flatnonzero(pending & cg.in_box(m))
            if not sel.size:
                continue
            rows = m[sel]
            fused = impl.fused_certificate
            if impl.wants_bucketing or fused:
                # the fused kernel path buckets too, as the reference's
                # does (routing kept so dispatch counts compare)
                batch = self.policy.pad_batch(rows)
            else:
                batch = rows
            if fused:
                rlat, _, rstatus, ok = impl.evaluate_certified(batch)
                rlat = rlat[: sel.size]
                rstatus = rstatus[: sel.size]
                ok = ok[: sel.size]
                dl = rstatus == DEADLOCK   # sound: relaxed system stalls
            else:
                rlat, _, rstatus, times = impl.evaluate_with_times(batch)
                rlat = rlat[: sel.size]
                rstatus = rstatus[: sel.size]
                times = times[: sel.size, : cg.n_events]
                dl = rstatus == DEADLOCK
                ok = np.zeros(sel.size, dtype=bool)
                conv = rstatus == CONVERGED
                if conv.any():
                    ci = np.flatnonzero(conv)
                    ok[ci] = verify_rows(cg, rows[ci], times[ci])
            acc = dl | ok
            if stats is not None:
                stats.n_cond_fail += int(sel.size - acc.sum())
            if acc.any():
                idx = sel[acc]
                lat[idx] = np.where(dl[acc], -1, rlat[acc])
                dead[idx] = dl[acc]
                pending[idx] = False
                if stats is not None:
                    stats.n_condensed += int(acc.sum())
            if not pending.any():
                break
        rem = np.flatnonzero(pending)
        if rem.size:
            rlat, _, rdead = self.policy.dispatch(
                self.primary, m[rem], stats)
            lat[rem] = rlat
            dead[rem] = rdead
        return lat, dead
