"""Cross-session hetero batching: many clients, one evaluation round.

:class:`AdvisoryService` is the always-on counterpart of the batch
campaign engine.  Where a :class:`~repro_torch.core.campaign.Campaign` is
handed its full task list up front, the service accepts sessions at any
time, on any design — tracing new designs lazily through the
:class:`~repro_torch.core.service.registry.DesignRegistry` — and still packs
every outstanding :class:`~repro_torch.core.optimizers.EvalRequest` from
*different* clients and *different* designs into single routed
dispatches via the shared
:class:`~repro_torch.core.campaign.router.RoundRouter`:

* same-design rows from different sessions are merged and deduplicated
  (two clients probing the same corner cost ONE solve, and both hit the
  design's shared cache forever after);
* incremental-eligible rows keep the LightningSim fast path;
* with ``hetero=True``, full-solve rows across designs are packed into
  one fixpoint dispatch
  (:class:`~repro_torch.core.backends.HeteroDispatcher`) — one K2 launch
  in its per-design-table mode on a CUDA device — whose envelope grows
  as new designs register (each design is added before the first round
  that routes it).

The batching is *routing only*: every path is exact, so each session's
history is bit-identical to a solo ``FifoAdvisor.run()`` with the same
seed — batching changes wall-clock, never results.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.advisor import DseResult
from repro_torch.core.campaign.router import RoundRouter, RoutedRequest
from repro_torch.core.config import EvalConfig, resolve_config
from repro_torch.core.faults import FaultPlan, resolve_plan
from repro_torch.core.service.registry import DesignRegistry
from repro_torch.core.service.session import Session

__all__ = ["AdvisoryService", "CrossSessionBatcher", "ServiceOverloaded"]


class ServiceOverloaded(RuntimeError):
    """Admission refused: the service is at its concurrent-session cap.

    ``retry_after_s`` is the service's live estimate of when capacity
    frees up (a few batched rounds at the current measured round time);
    the wire protocol surfaces it verbatim in the ``E_OVERLOADED``
    error frame so clients can back off instead of hammering.
    """

    def __init__(self, max_sessions: int, retry_after_s: float):
        self.max_sessions = int(max_sessions)
        self.retry_after_s = float(retry_after_s)
        super().__init__(
            f"service at capacity ({max_sessions} running sessions); "
            f"retry in {retry_after_s:.3f}s")


class CrossSessionBatcher:
    """Routes one round of session proposals through shared engines.

    Owns the :class:`RoundRouter` plus the optional cross-design
    :class:`HeteroDispatcher` and :class:`WorkerPool`, keeping both in
    sync with the registry as designs appear.  The hetero dispatch runs
    on the registry's device.
    """

    def __init__(self, registry: DesignRegistry, hetero: bool = False,
                 workers: int = 0, shards: Optional[int] = None,
                 faults: Optional[FaultPlan] = None):
        self.registry = registry
        #: installed fault plan (chaos testing; None = no injection)
        self.faults = faults
        self.want_hetero = bool(hetero)
        # hetero owns every full-solve row in this process (same rule as
        # CampaignSpec.hetero): a pool would only idle, so the two are
        # mutually exclusive — normalized here, surfaced by the CLI
        self.workers = 0 if hetero else int(workers)
        #: shard the hetero dispatch over this many devices; only
        #: meaningful with hetero=True
        self.shards = shards
        self.router = RoundRouter(registry)
        self.rounds = 0
        #: EWMA of the wall time of one batched round, feeding the
        #: overload replies' retry-after estimate
        self.round_ewma_s = 0.0
        self._pool_designs: set = set()   # designs the pool was built with

    @property
    def n_lanes(self) -> int:
        return self.router.n_lanes

    def add_design(self, name: str) -> None:
        """Keep the hetero envelope / worker pool aware of ``name``.

        Hetero mode extends the dispatcher's operand envelope in place.
        Pool mode must keep every worker able to evaluate the design:
        custom ``Design`` objects are pinned to lane 0 (a fresh worker
        process cannot rebuild them by name), and a *named* design that
        arrives after the pool exists rebuilds the pool so the workers
        pick up its graph — sessions are rare next to rounds, so the
        respawn cost is noise.  (Once CUDA is up the pool spawns, and
        its workers re-trace named designs by name.)
        """
        adv = self.registry[name]
        if self.want_hetero:
            if self.router.hetero is None:
                from repro_torch.core.backends.dispatch import HeteroDispatcher
                self.router.hetero = HeteroDispatcher(
                    {}, max_iters=self.registry.max_iters,
                    shards=self.shards, device=self.registry.device)
            self.router.hetero.add_design(
                name, adv.graph, getattr(adv.evaluator, "_worklist", None))
        elif self.workers > 0:
            if name in self.registry.custom_names:
                self.router.inline_only.add(name)
            elif (self.router.pool is None
                  or name not in self._pool_designs):
                from repro_torch.core.campaign.pool import WorkerPool
                if self.router.pool is not None:
                    self.router.pool.close()
                self._pool_designs = {
                    k for k in self.registry
                    if k not in self.registry.custom_names}
                self.router.pool = WorkerPool(
                    self.workers, max_iters=self.registry.max_iters,
                    graphs={k: self.registry[k].graph
                            for k in self._pool_designs},
                    faults=self.faults)

    def step(self, sessions: List[Session]) -> int:
        """One cross-session round over the given *running* sessions.

        Collects each session's outstanding proposal, screens it against
        the design's shared cache, routes every miss in one
        :meth:`RoundRouter.route` call, and hands the results back to
        each session (history, budget, optimizer step, progress events).
        Returns the number of sessions that advanced.
        """
        t0 = time.perf_counter()
        pending: List[RoutedRequest] = []
        for sess in sessions:
            req = sess.propose()
            if req is None:
                continue
            lat, bram, dead, miss = sess.advisor.cache.lookup(req.depths)
            pending.append(RoutedRequest(
                key=sess.design, req=req, lat=lat, bram=bram, dead=dead,
                miss_rows=np.flatnonzero(miss), lane=sess.lane, tag=sess))
        self.router.route(pending)
        if self.faults is not None:
            for p in pending:
                sess = p.tag
                f = self.faults.take("hang_eval", at=sess.rounds,
                                     targets=(sess.id, sess.design))
                if f is not None:
                    # a wedged evaluation: real wall-clock stall, real
                    # attributed eval time — the session's deadline (if
                    # any) fails it with E_TIMEOUT in complete_round
                    time.sleep(f.value)
                    p.eval_s += f.value
        for p in pending:
            p.tag.complete_round(p)
        self.rounds += 1
        dt = time.perf_counter() - t0
        self.round_ewma_s = (dt if self.round_ewma_s == 0.0
                             else 0.8 * self.round_ewma_s + 0.2 * dt)
        return len(pending)

    def stats(self) -> dict:
        out = {"rounds": self.rounds, "lanes": self.n_lanes,
               "hetero": self.want_hetero}
        if self.router.hetero is not None:
            hs = self.router.hetero.stats
            out["hetero_stats"] = {
                "n_dispatches": hs.n_dispatches, "n_rows": hs.n_rows,
                "n_pad_rows": hs.n_pad_rows,
                "n_fallbacks": hs.n_fallbacks,
                "wall_s": round(hs.wall_s, 4)}
        return out

    def close(self) -> None:
        if self.router.pool is not None:
            self.router.pool.close()
            self.router.pool = None


class AdvisoryService:
    """The FIFO-sizing advisory service core (synchronous, deterministic).

    Holds the design registry, the open sessions, and the cross-session
    batcher; :meth:`step` advances every running session by one batched
    round.  The asyncio server (``repro_torch.launch.serve``) and the
    in-process :class:`~repro_torch.core.service.protocol.AdvisorClient` are
    both thin front-ends over this class, so everything observable —
    histories, frontiers, events — is independent of the transport.

    Args:
        registry: a shared :class:`DesignRegistry` (one is built when
            omitted).
        config: :class:`EvalConfig` for the registry when building it
            (the deprecated ``backend=``/``max_iters=`` keywords still
            map onto it).
        hetero: pack cross-design full-solve rows into one fixpoint
            dispatch (one K2 launch on the card; on CPU the worklist is
            faster).
        workers: worklist worker processes for parallel lanes (0 =
            evaluate inline).
        shards: shard the hetero dispatch over this many devices of the
            registry's kind; requires ``hetero=True`` to matter.
        progress_events: default per-session progress streaming flag.
        max_sessions: admission-control cap on concurrently *running*
            sessions; :meth:`open_session` raises
            :class:`ServiceOverloaded` (with a live retry-after
            estimate) above it.  None = unbounded.
        faults: a :class:`~repro_torch.core.faults.FaultPlan` to install
            (chaos testing); defaults to whatever the registry config /
            ``REPRO_FAULTS`` env resolves to — i.e. None.
        device: the torch device of the registry built here (None =
            CUDA, raising without a card; ``"cpu"`` runs the kernels'
            plain versions).  A given ``registry`` brings its own.
    """

    def __init__(self, registry: Optional[DesignRegistry] = None,
                 config: Optional[EvalConfig] = None,
                 hetero: bool = False, workers: int = 0,
                 shards: Optional[int] = None,
                 progress_events: bool = True,
                 max_sessions: Optional[int] = None,
                 faults: Optional[FaultPlan] = None, device=None,
                 **legacy):
        if registry is None:
            registry = DesignRegistry(
                resolve_config(config, legacy, "AdvisoryService"),
                device=device)
        elif legacy:
            resolve_config(config, legacy, "AdvisoryService")
        self.registry = registry
        self.faults = faults if faults is not None \
            else resolve_plan(self.registry.config)
        self.batcher = CrossSessionBatcher(self.registry, hetero=hetero,
                                           workers=workers, shards=shards,
                                           faults=self.faults)
        self.progress_events = bool(progress_events)
        self.max_sessions = None if max_sessions is None else int(max_sessions)
        self.rejected = 0              # admissions refused while at capacity
        self.sessions: Dict[str, Session] = {}
        self._next_sid = 0
        #: idempotent open: request id -> session id, so a client that
        #: lost the open reply can safely re-send the same open
        self._open_requests: Dict[str, str] = {}

    @property
    def config(self) -> EvalConfig:
        return self.registry.config

    def retry_after_s(self) -> float:
        """How long an overloaded client should wait before retrying:
        a few batched rounds at the current measured round time, floored
        so cold services never advertise a zero backoff."""
        return max(0.01, 4.0 * self.batcher.round_ewma_s)

    # ---------------------------------------------------------- sessions
    def open_session(self, design: str, optimizer: str = "grouped_sa",
                     budget: int = 300, seed: int = 0,
                     design_obj=None, progress_events: Optional[bool] = None,
                     deadline_s: Optional[float] = None,
                     request_id: Optional[str] = None,
                     **opt_kwargs) -> Session:
        """Open a DSE session (tracing the design on first use).

        Raises :class:`ServiceOverloaded` when ``max_sessions`` running
        sessions already exist — admission is checked *before* the
        (potentially expensive) first-use trace, so overload replies
        stay cheap even under a thundering herd of new designs.

        ``request_id`` makes the open idempotent: re-sending an open
        with an id the service has already honoured returns the session
        it created then, instead of opening a duplicate — the reconnect
        path for a client whose connection died before the open reply
        arrived.  ``deadline_s`` is the per-round evaluation deadline
        (see :class:`Session`).
        """
        if request_id is not None:
            sid = self._open_requests.get(request_id)
            if sid is not None and sid in self.sessions:
                return self.sessions[sid]
        if (self.max_sessions is not None
                and len(self.running) >= self.max_sessions):
            self.rejected += 1
            raise ServiceOverloaded(self.max_sessions, self.retry_after_s())
        advisor = self.registry.register(design, design_obj)
        self.batcher.add_design(design)
        sid = f"s{self._next_sid}"
        self._next_sid += 1
        lane = len(self.sessions) % max(self.batcher.n_lanes, 1)
        sess = Session(sid, design, advisor, optimizer=optimizer,
                       budget=budget, seed=seed, opt_kwargs=opt_kwargs,
                       lane=lane,
                       progress_events=(self.progress_events
                                        if progress_events is None
                                        else progress_events),
                       deadline_s=deadline_s)
        self.sessions[sid] = sess
        if request_id is not None:
            self._open_requests[request_id] = sid
        return sess

    def session(self, sid: str) -> Session:
        try:
            return self.sessions[sid]
        except KeyError:
            raise KeyError(f"unknown session {sid!r}") from None

    def cancel(self, sid: str) -> Session:
        """Cancel a session; its evaluated history becomes the result."""
        sess = self.session(sid)
        sess.cancel()
        return sess

    def release(self, sid: str) -> Session:
        """Drop a session from the service (cancelling it first if it
        is still running).  An always-on server must be able to forget
        finished sessions, or memory grows with every client ever
        served; the session object itself stays valid for the caller."""
        sess = self.session(sid)
        sess.cancel()
        del self.sessions[sid]
        # drop the idempotent-open entries that resolve to this session,
        # or the map grows with every open a long-lived server ever saw
        # (a re-sent open for a released session should open fresh anyway)
        self._open_requests = {rid: s for rid, s
                               in self._open_requests.items() if s != sid}
        return sess

    def result(self, sid: str) -> DseResult:
        """The session's :class:`DseResult` (snapshot if still running)."""
        return self.session(sid).dse_result()

    @property
    def running(self) -> List[Session]:
        return [s for s in self.sessions.values() if not s.done]

    # ------------------------------------------------------------ driving
    def step(self) -> int:
        """Advance every running session one batched round; returns the
        number of sessions that advanced (0 = service idle)."""
        active = self.running
        if not active:
            return 0
        return self.batcher.step(active)

    def run_until_idle(self, max_rounds: Optional[int] = None) -> int:
        """Drive :meth:`step` until no session is running (or the round
        cap); returns the number of rounds executed."""
        rounds = 0
        while self.step():
            rounds += 1
            if max_rounds is not None and rounds >= max_rounds:
                break
        return rounds

    # ------------------------------------------------------------- admin
    def drain_events(self, sid: Optional[str] = None) -> List[dict]:
        """Pop queued events — one session's, or every session's in
        session order."""
        if sid is not None:
            return self.session(sid).drain_events()
        out: List[dict] = []
        for sess in self.sessions.values():
            out.extend(sess.drain_events())
        return out

    def stats(self) -> dict:
        """JSON-ready service snapshot: sessions, batcher, registry."""
        states: Dict[str, int] = {}
        for s in self.sessions.values():
            states[s.state] = states.get(s.state, 0) + 1
        return {"n_sessions": len(self.sessions),
                "session_states": states,
                "max_sessions": self.max_sessions,
                "rejected": self.rejected,
                "round_ewma_s": round(self.batcher.round_ewma_s, 6),
                "batcher": self.batcher.stats(),
                "designs": self.registry.stats()}

    def close(self) -> None:
        self.batcher.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
