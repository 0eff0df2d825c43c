"""Worklist worker pool for campaign evaluation.

Workers are persistent processes running ONLY the numpy evaluation chain
(designs -> trace -> SimGraph -> worklist).  Each worker keeps, per
design, a :class:`~repro_torch.core.backends.worklist.WorklistBackend` plus an
LRU of solved :class:`WorklistState`'s so the incremental re-simulation
fast path works inside the worker exactly as it does in
:class:`~repro_torch.core.simulate.BatchedEvaluator` (the scheduler keeps each
task sticky to one worker for state locality).

Start method: ``fork`` when available and CUDA has not been initialised
in this process — children then inherit the campaign's already-built
graphs and worklist tables for free (the whole evaluation chain is
numpy).  A CUDA context does not survive a fork, so once
``torch.cuda.is_initialized()`` (an advisor on the cuda backend, a hetero
campaign on the card) the pool uses ``spawn``: a clean numpy-only
interpreter per worker that re-traces its designs by name on first use.
Workers never touch the card.

Supervision: a lane that crashes or stops answering within
``recv_timeout_s`` is detected (EOF on its pipe, or the recv deadline
expiring), killed, and respawned; its in-flight jobs are re-dispatched
to the fresh process, and a job that has already burned
``max_retries`` lanes is executed inline in the parent instead — so a
round always completes and never hangs on a dead worker.  All results
are exact and every retry re-evaluates the same pure function, so
parallel evaluation — crashes included — is bit-identical to the
sequential path: campaign frontiers do not depend on worker count or on
worker failures.  Fault schedules for chaos testing are injected via
:class:`~repro_torch.core.faults.FaultPlan`.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import sys
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.faults import FaultPlan, check_worker_faults

#: cap on queued-but-undrained jobs per worker: bounds the result-pipe
#: backlog so neither side of the pipe pair can fill and deadlock (see
#: WorkerPool.submit) — and bounds how many jobs a lane death can put
#: back in flight
MAX_OUTSTANDING = 8

#: a lane that answers nothing for this long is declared dead (the
#: numpy worklist evaluates a full batch in milliseconds; minutes of
#: silence means the process is gone or wedged)
DEFAULT_RECV_TIMEOUT_S = 60.0


class LaneFailure(RuntimeError):
    """Internal: lane ``lane`` died or went silent; callers of
    ``_recv`` recover by respawning the lane and requeueing."""

    def __init__(self, lane: int, reason: str):
        super().__init__(f"worker lane {lane}: {reason}")
        self.lane = lane
        self.reason = reason


class _WorkerDesign:
    """One design's evaluation engine inside a worker process — a plain
    :class:`~repro_torch.core.simulate.BatchedEvaluator` on the numpy worklist
    (same dispatch policy, in-batch dedup, incremental state LRU as the
    scheduler's own evaluators; the whole chain is numpy)."""

    def __init__(self, name: str, max_iters: int, graph=None):
        from repro_torch.core.simulate import BatchedEvaluator

        if graph is None:
            from repro_torch.core.simgraph import build_simgraph
            from repro_torch.core.tracer import collect_trace
            from repro_torch.designs import make_design
            design = make_design(name)
            graph = build_simgraph(design, collect_trace(design))
        from repro_torch.core.config import EvalConfig
        self.ev = BatchedEvaluator(
            graph, EvalConfig(backend="numpy", max_iters=max_iters))

    def evaluate(self, depths: np.ndarray, base: Optional[np.ndarray]
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if base is None:
            return self.ev.evaluate(depths)
        return self.ev.evaluate_incremental(base, depths)


def _worker_main(conn, max_iters: int, graphs: Optional[Dict] = None,
                 faults: Optional[List[dict]] = None):
    designs: Dict[str, _WorkerDesign] = {}
    graphs = graphs or {}
    faults = list(faults or [])
    n_jobs = 0
    try:
        while True:
            msg = conn.recv()
            if msg is None:
                break
            name, depths, base = msg
            if faults:
                check_worker_faults(faults, n_jobs)
            n_jobs += 1
            try:
                wd = designs.get(name)
                if wd is None:
                    wd = designs[name] = _WorkerDesign(
                        name, max_iters, graphs.get(name))
                t0 = time.perf_counter()
                lat, bram, dead = wd.evaluate(depths, base)
                conn.send(
                    ("ok", lat, bram, dead, time.perf_counter() - t0))
            except BrokenPipeError:  # lane already written off
                break
            except Exception as exc:  # surfaced in the parent
                conn.send(("err", f"{type(exc).__name__}: {exc}"))
    except (EOFError, KeyboardInterrupt, BrokenPipeError, OSError):
        pass  # parent died / interrupt / lane already written off
    finally:
        conn.close()


def pick_start_method() -> str:
    """fork while no CUDA context exists in this process, else spawn."""
    torch = sys.modules.get("torch")
    cuda_up = torch is not None and torch.cuda.is_initialized()
    if "fork" in mp.get_all_start_methods() and not cuda_up:
        return "fork"
    return "spawn"


class WorkerPool:
    """A fixed set of persistent worklist workers fed round by round,
    supervised against crashes and hangs.

    Args:
        n_workers: lane count.
        max_iters: fixpoint cap forwarded to each worker's evaluator.
        start_method: force ``fork``/``spawn``; default picks.
        graphs: prebuilt ``{name: SimGraph}`` — rides to fork children
            via copy-on-write, and backs the parent's inline-escalation
            evaluators under either start method.
        faults: a :class:`FaultPlan` to exercise recovery paths
            (chaos testing only; None = no injection).
        recv_timeout_s: silence window after which a lane is declared
            dead (``REPRO_POOL_TIMEOUT_S`` overrides the default).
        max_retries: worker attempts per job before the parent runs it
            inline.
    """

    def __init__(self, n_workers: int, max_iters: int = 64,
                 start_method: Optional[str] = None,
                 graphs: Optional[Dict] = None,
                 faults: Optional[FaultPlan] = None,
                 recv_timeout_s: Optional[float] = None,
                 max_retries: int = 2):
        self.n_workers = int(n_workers)
        self.max_iters = int(max_iters)
        self.start_method = start_method or pick_start_method()
        self.faults = faults
        if recv_timeout_s is None:
            recv_timeout_s = float(os.environ.get(
                "REPRO_POOL_TIMEOUT_S", DEFAULT_RECV_TIMEOUT_S))
        self.recv_timeout_s = float(recv_timeout_s)
        self.max_retries = int(max_retries)
        #: how long close() waits for a clean exit before escalating
        self.join_timeout_s = 5.0
        self._graphs = graphs or {}
        # graphs can only ride along through fork's copy-on-write pages;
        # spawn workers rebuild their designs by name on first use
        self._payload = self._graphs if self.start_method == "fork" \
            else None
        self._ctx = mp.get_context(self.start_method)
        self._local: Dict[str, _WorkerDesign] = {}  # inline escalation
        self.stats = {"respawns": 0, "requeued": 0, "escalated": 0,
                      "recovery_s": 0.0}
        self._pipes: List = [None] * self.n_workers
        self._procs: List = [None] * self.n_workers
        for w in range(self.n_workers):
            self._spawn_lane(w)

    # ----------------------------------------------------- lane lifecycle
    def _spawn_lane(self, w: int):
        wf = self.faults.worker_payload(w) if self.faults else None
        parent_conn, child_conn = self._ctx.Pipe()
        proc = self._ctx.Process(
            target=_worker_main,
            args=(child_conn, self.max_iters, self._payload, wf),
            daemon=True)
        proc.start()
        child_conn.close()
        self._pipes[w] = parent_conn
        self._procs[w] = proc

    def _revive(self, w: int):
        """Kill whatever is left of lane ``w`` and spawn a replacement."""
        t0 = time.perf_counter()
        proc = self._procs[w]
        if proc.is_alive():
            proc.terminate()
            proc.join(timeout=2)
            if proc.is_alive():  # pragma: no cover - stuck in syscall
                proc.kill()
        proc.join(timeout=2)
        try:
            self._pipes[w].close()
        except OSError:  # pragma: no cover - already closed
            pass
        if self.faults is not None:
            # the fault that felled this incarnation is spent: the
            # replacement is shipped only the remaining schedule
            self.faults.consume_worker_fault(w)
        self._spawn_lane(w)
        self.stats["respawns"] += 1
        self.stats["recovery_s"] += time.perf_counter() - t0

    def _recv(self, w: int):
        pipe = self._pipes[w]
        if not pipe.poll(self.recv_timeout_s):
            raise LaneFailure(
                w, f"no result within {self.recv_timeout_s:g}s")
        try:
            msg = pipe.recv()
        except (EOFError, OSError):
            raise LaneFailure(w, "process died") from None
        if msg[0] == "err":
            raise RuntimeError(f"campaign worker {w} failed: {msg[1]}")
        return msg[1:]

    # ------------------------------------------------------ job movement
    def _eval_inline(self, job) -> Tuple:
        """Last resort for a job that keeps killing workers: evaluate in
        the parent on a cached worklist evaluator (exact same engine, so
        results stay bit-identical)."""
        _, name, depths, base = job
        wd = self._local.get(name)
        if wd is None:
            wd = self._local[name] = _WorkerDesign(
                name, self.max_iters, self._graphs.get(name))
        t0 = time.perf_counter()
        lat, bram, dead = wd.evaluate(depths, base)
        return (lat, bram, dead, time.perf_counter() - t0)

    def _dispatch(self, handle: Dict, w: int, j: int):
        """Ship job ``j`` to lane ``w``, recovering the lane if the send
        itself hits a dead process."""
        _, name, depths, base = handle["jobs"][j]
        if self.faults is not None:
            f = self.faults.take("delay_dispatch", lane=w, at=j)
            if f is not None:
                time.sleep(f.value)
        try:
            self._pipes[w].send((name, depths, base))
        except (BrokenPipeError, OSError):
            self._recover(handle, w)
            self._pipes[w].send((name, depths, base))
        handle["per_worker"].setdefault(w, deque()).append(j)

    def _recover(self, handle: Dict, w: int):
        """Lane ``w`` failed: respawn it and re-dispatch its in-flight
        jobs (inline once a job exceeds ``max_retries``)."""
        # clear in place, never replace: submit()'s backpressure loop
        # holds a reference to this deque while it drains, and swapping
        # in a fresh object would leave that loop watching a queue no
        # _collect_one will ever shrink again
        queue = handle["per_worker"].setdefault(w, deque())
        outstanding = list(queue)
        queue.clear()
        self._revive(w)
        retries = handle["retries"]
        requeue, inline = [], []
        for j in outstanding:
            retries[j] = retries.get(j, 0) + 1
            (inline if retries[j] > self.max_retries
             else requeue).append(j)
        self.stats["requeued"] += len(requeue)
        for j in requeue:
            self._dispatch(handle, w, j)
        for j in inline:
            self.stats["escalated"] += 1
            handle["results"][j] = self._eval_inline(handle["jobs"][j])

    def _collect_one(self, handle: Dict, w: int):
        """Blocking-receive the oldest outstanding result from lane
        ``w``; a dead/silent lane is recovered instead (its results then
        arrive from the re-dispatch or inline escalation)."""
        queue = handle["per_worker"][w]
        try:
            res = self._recv(w)
        except LaneFailure:
            self._recover(handle, w)
            return
        handle["results"][queue.popleft()] = res

    def _drain_ready(self, handle: Dict):
        """Collect any results already sitting in the pipes (non-blocking)
        so a worker's result-send can never back up against our job-send
        — the classic pipe-pair deadlock."""
        for w in list(handle["per_worker"]):
            while (handle["per_worker"][w]
                   and self._pipes[w].poll()):
                self._collect_one(handle, w)

    def submit(self, jobs: List[Tuple[int, str, np.ndarray,
                                      Optional[np.ndarray]]]) -> Dict:
        """Ship ``(worker, design, depths, base)`` jobs to their workers
        and return a collection handle; the caller may do its own work
        before :meth:`collect` blocks on the results.

        Flow control: before each send, ready results are drained, and a
        worker with :data:`MAX_OUTSTANDING` queued jobs is blocking-drained
        first — so the per-worker result backlog stays far below the pipe
        buffer and neither side can block on a full pipe simultaneously.
        """
        handle = {"jobs": list(jobs), "per_worker": {}, "results": {},
                  "retries": {}, "n": len(jobs)}
        for j, (w, name, depths, base) in enumerate(jobs):
            self._drain_ready(handle)
            handle["per_worker"].setdefault(w, deque())
            # re-read the deque each pass: _collect_one may recover a
            # dead lane, which rewrites the lane's outstanding queue
            while len(handle["per_worker"][w]) >= MAX_OUTSTANDING:
                self._collect_one(handle, w)
            self._dispatch(handle, w, j)
        return handle

    def collect(self, handle: Dict) -> List[Tuple[np.ndarray, np.ndarray,
                                                  np.ndarray, float]]:
        """Results in the submission order of the ``submit`` jobs; each
        is ``(lat, bram, dead, worker_eval_seconds)``."""
        per_worker = handle["per_worker"]
        # drain in round-robin so no single worker's pipe backs up
        while any(per_worker.values()):
            for w in list(per_worker):
                if per_worker[w]:
                    self._collect_one(handle, w)
        out: List = [None] * handle["n"]
        for j, res in handle["results"].items():
            out[j] = res
        return out

    def run_jobs(self, jobs) -> List:
        """submit + collect in one blocking call."""
        return self.collect(self.submit(jobs))

    def close(self):
        """Shut every lane down, escalating join -> terminate -> kill so
        a wedged worker can never outlive the pool as a zombie."""
        for pipe in self._pipes:
            try:
                pipe.send(None)
                pipe.close()
            except (BrokenPipeError, OSError):  # already gone
                pass
        for proc in self._procs:
            if proc is None:
                continue
            proc.join(timeout=self.join_timeout_s)
            if proc.is_alive():
                proc.terminate()
                proc.join(timeout=2)
            if proc.is_alive():  # pragma: no cover - stuck in syscall
                proc.kill()
            proc.join(timeout=2)
        self._pipes, self._procs = [], []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
