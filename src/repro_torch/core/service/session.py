"""Client sessions: one stepwise optimizer run per connected client.

A :class:`Session` wraps the campaign engine's stepwise
``propose()/observe()`` optimizer protocol
(:mod:`repro_torch.core.optimizers.base`) for service use: it owns a fresh
:class:`~repro_torch.core.optimizers.EvalContext` bound to the registry's
shared advisor (shared evaluator + shared design-wide cache), exposes
the outstanding :class:`~repro_torch.core.optimizers.EvalRequest` to the
cross-session batcher, and turns every completed round into streaming
progress events — frontier/hypervolume *deltas*, so an interactive
client sees the Pareto front sharpen round by round instead of polling
a final blob.

Lifecycle::

    running --(generator exhausts)--> done
    running --(cancel())-----------> cancelled   (partial result kept)
    running --(deadline exceeded)--> failed      (partial result kept,
                                                  error code E_TIMEOUT)

Every queued event carries a monotonically increasing ``seq`` number,
and a bounded replay log retains the most recent events even after they
are drained — so a client that loses its connection can re-attach and
replay the exact suffix of its event stream from the last ``seq`` it
saw (``events_after``).

Because evaluation is exact and the optimizer is a deterministic
function of ``(seed, observed results)``, a session's history — and
therefore its frontier and hypervolume — is bit-identical to a solo
``FifoAdvisor.run()`` with the same seed, no matter how many other
sessions were batched alongside it (asserted in
``tests/test_torch_service.py`` and by ``chip_smoke.py`` on the card).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, Optional

import numpy as np

from repro_torch.core.advisor import DseResult, FifoAdvisor
from repro_torch.core.campaign.router import RoutedRequest
from repro_torch.core.optimizers import OPTIMIZERS, EvalRequest
from repro_torch.core.pareto import hypervolume_2d

__all__ = ["Session"]

RUNNING = "running"
DONE = "done"
CANCELLED = "cancelled"
FAILED = "failed"

#: per-session event-queue bound.  A client that never drains its
#: progress stream must not grow server memory without limit; beyond
#: this the oldest events are dropped (counted in ``events_dropped``
#: and surfaced via ``status()``).  The terminal done/cancelled event
#: is always the newest append, so completion is never the one lost.
MAX_QUEUED_EVENTS = 1024


class Session:
    """One client's DSE run, drivable one batched round at a time.

    Args:
        sid: service-unique session id (``"s0"``, ``"s1"``, ...).
        design: registry key of the design being sized.
        advisor: the registry's shared :class:`FifoAdvisor` for it.
        optimizer: registered optimizer name (see ``OPTIMIZERS``).
        budget: evaluation budget (simulated rows, i.e. cache misses).
        seed: RNG seed; determines the whole trajectory.
        opt_kwargs: extra optimizer constructor keywords.
        lane: sticky evaluation-lane affinity (pool routing).
        progress_events: emit per-round frontier/hypervolume deltas
            (costs one frontier recomputation per round — cheap, but
            off-switchable for throughput benchmarking).
        deadline_s: per-round evaluation deadline.  A round whose
            attributed evaluation time exceeds this fails the session
            with the stable ``E_TIMEOUT`` error code (the evaluated
            history up to that round is kept as a partial result).
            None — the default — disables the deadline.
    """

    def __init__(self, sid: str, design: str, advisor: FifoAdvisor,
                 optimizer: str = "grouped_sa", budget: int = 300,
                 seed: int = 0, opt_kwargs: Optional[dict] = None,
                 lane: int = 0, progress_events: bool = True,
                 deadline_s: Optional[float] = None):
        if optimizer not in OPTIMIZERS:
            raise KeyError(
                f"unknown optimizer {optimizer!r}; registered: "
                f"{sorted(OPTIMIZERS)}")
        self.id = sid
        self.design = design
        self.advisor = advisor
        self.optimizer = optimizer
        self.budget = int(budget)
        self.seed = int(seed)
        self.lane = int(lane)
        self.progress_events = bool(progress_events)
        self.ctx = advisor.make_context(seed=seed)
        self.opt = OPTIMIZERS[optimizer](self.ctx, budget=budget,
                                         **dict(opt_kwargs or {}))
        self.state = RUNNING
        self.rounds = 0
        self.eval_s = 0.0
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        self.error_code: Optional[str] = None
        self.error: Optional[str] = None
        self.opened_at = time.perf_counter()
        self.last_event_at = self.opened_at   # heartbeat for liveness
        self.events: Deque[dict] = deque(maxlen=MAX_QUEUED_EVENTS)
        #: drained events are retained here (same bound) so a
        #: reconnecting client can replay its exact stream suffix
        self.event_log: Deque[dict] = deque(maxlen=MAX_QUEUED_EVENTS)
        self.events_dropped = 0
        self._next_seq = 0
        self._last_hv = 0.0
        self._last_frontier = 0
        self._result: Optional[DseResult] = None

    # ------------------------------------------------------ round driving
    def propose(self) -> Optional[EvalRequest]:
        """The outstanding batch, or None (finalizing if exhausted)."""
        if self.state != RUNNING:
            return None
        req = self.opt.propose()
        if req is None:
            self._finish(DONE)
        return req

    def complete_round(self, routed: RoutedRequest) -> None:
        """Absorb one routed round: cache-insert the simulated rows,
        record history/budget, step the optimizer, emit progress."""
        rows = routed.miss_rows
        if rows.size:
            self.advisor.cache.insert(
                routed.req.depths[rows], routed.lat[rows],
                routed.bram[rows], routed.dead[rows])
        self.eval_s += routed.eval_s
        self.ctx.record(routed.req.depths, routed.lat, routed.bram,
                        routed.dead, rows.size)
        self.opt.observe(routed.lat, routed.bram, routed.dead)
        self.rounds += 1
        if self.progress_events:
            self._emit_progress(int(rows.size))
        # deadline AFTER absorbing the round: the evaluation did finish,
        # so the history prefix stays identical to the solo run — the
        # session just refuses to keep paying for a wedged backend
        if (self.state == RUNNING and self.deadline_s is not None
                and routed.eval_s > self.deadline_s):
            self.fail("E_TIMEOUT",
                      f"evaluation round {self.rounds} took "
                      f"{routed.eval_s:.3f}s > deadline "
                      f"{self.deadline_s:g}s")

    def cancel(self) -> None:
        """Stop the session now; evaluated history becomes the result."""
        if self.state != RUNNING:
            return
        self.opt.close()
        self._finish(CANCELLED)

    def fail(self, code: str, message: str) -> None:
        """Fail the session with a stable error code; the evaluated
        history up to the failure is kept as a partial result."""
        if self.state != RUNNING:
            return
        self.opt.close()
        self.error_code = code
        self.error = message
        self._finish(FAILED)

    # ---------------------------------------------------------- results
    @property
    def done(self) -> bool:
        return self.state != RUNNING

    def dse_result(self) -> DseResult:
        """The session's :class:`DseResult` (partial when cancelled)."""
        if self._result is None:
            # an in-flight snapshot (status queries on a running session)
            return self._make_result()
        return self._result

    def _make_result(self) -> DseResult:
        res = self.ctx.result(self.opt.name, self.opt.step_s + self.eval_s)
        return DseResult(design_name=self.design,
                         optimizer=self.optimizer, result=res,
                         baseline_max=self.advisor.baseline_max,
                         baseline_min=self.advisor.baseline_min,
                         trace_time_s=self.advisor.trace_time_s)

    def _finish(self, state: str) -> None:
        self.state = state
        self._result = self._make_result()
        event = {
            "event": state, "session": self.id,
            "n_evals": int(self.ctx.n_evals),
            "rounds": self.rounds,
            "frontier_size": int(
                self._result.frontier_points.shape[0]),
            "hypervolume": float(self._result.hypervolume()),
        }
        if state == FAILED:
            event["code"] = self.error_code
            event["error"] = self.error
        self._queue_event(event)

    # ----------------------------------------------------------- events
    def _queue_event(self, event: dict) -> None:
        if len(self.events) == MAX_QUEUED_EVENTS:
            self.events_dropped += 1     # deque(maxlen) evicts the oldest
        event = dict(event, seq=self._next_seq)
        self._next_seq += 1
        self.last_event_at = time.perf_counter()
        self.events.append(event)
        self.event_log.append(event)

    def _hypervolume(self, pts: np.ndarray) -> float:
        return hypervolume_2d(pts,
                              self.advisor.baseline_max.hv_reference())

    def _emit_progress(self, n_simulated: int) -> None:
        """Queue a progress event when the frontier moved this round."""
        pts, _ = self.ctx.result(self.opt.name, 0.0).frontier()
        hv = self._hypervolume(pts)
        if (pts.shape[0] == self._last_frontier
                and hv == self._last_hv and self.rounds > 1):
            return
        self._queue_event({
            "event": "progress", "session": self.id,
            "round": self.rounds,
            "n_evals": int(self.ctx.n_evals),
            "n_simulated": n_simulated,
            "frontier_size": int(pts.shape[0]),
            "frontier_delta": int(pts.shape[0] - self._last_frontier),
            "hypervolume": float(hv),
            "hv_delta": float(hv - self._last_hv),
        })
        self._last_frontier = int(pts.shape[0])
        self._last_hv = float(hv)

    def drain_events(self):
        """Pop and return every queued event (oldest first)."""
        out = list(self.events)
        self.events.clear()
        return out

    def events_after(self, seq: int):
        """Replay the retained event-stream suffix after ``seq`` (the
        reconnect path: a client re-attaches with the last seq it saw
        and receives exactly what it missed).  The undelivered queue is
        cleared — every undelivered event is in the replayed suffix, so
        leaving it would deliver duplicates."""
        out = [e for e in self.event_log if e["seq"] > seq]
        self.events.clear()
        return out

    @property
    def replay_floor(self) -> int:
        """Smallest seq still replayable (events before it aged out of
        the bounded log)."""
        return self.event_log[0]["seq"] if self.event_log else 0

    def status(self) -> dict:
        """JSON-ready snapshot of the session."""
        out = {
            "session": self.id, "design": self.design,
            "optimizer": self.optimizer, "state": self.state,
            "seed": self.seed, "budget": self.budget,
            "rounds": self.rounds, "n_evals": int(self.ctx.n_evals),
            "eval_s": round(self.eval_s, 4),
            "events_dropped": self.events_dropped,
            "next_seq": self._next_seq,
        }
        if self.deadline_s is not None:
            out["deadline_s"] = self.deadline_s
        if self.error_code is not None:
            out["code"] = self.error_code
            out["error"] = self.error
        return out
