"""Cross-design DSE campaign scheduler.

A *campaign* runs many ``(design, optimizer, seed)`` tasks as one
scheduled workload.  Every optimizer is driven through the stepwise
``propose()/observe()`` API (``repro_torch.core.optimizers.base``), so one
scheduler round interleaves every active task:

1. collect each task's outstanding :class:`EvalRequest`;
2. resolve cache hits against the task's design-wide
   :class:`~repro_torch.core.backends.ConfigCache`;
3. route the misses through the shared
   :class:`~repro_torch.core.campaign.router.RoundRouter` —
   * incremental-eligible rows (single-FIFO deltas) to the task's sticky
     worklist worker (or inline), preserving the LightningSim fast path,
   * full-solve rows either to the worker pool (rows are split across
     workers for load balance) or, in hetero mode, packed across designs
     into ONE fixpoint dispatch — one K2 launch on the card
     (:class:`~repro_torch.core.backends.HeteroDispatcher`);
4. record results into each task's history/budget and ``observe()`` them.

All evaluation paths are exact, so the per-task histories — and therefore
frontiers and hypervolumes — are bit-identical to running each task alone
through ``FifoAdvisor.run()`` with the same seed.  Campaign state
checkpoints to a single ``.npz`` (see ``repro_torch.core.campaign.state``) and
resumes deterministically by replaying the recorded histories through the
generators.

Spans (:mod:`repro_torch.obs`): ``campaign.construct`` around the
constructor (every design's ``construct`` nests in it) and
``campaign.round`` around each round.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core.advisor import FifoAdvisor
from repro_torch.core.campaign.router import RoundRouter, RoutedRequest
from repro_torch.core.config import EvalConfig
from repro_torch.core.optimizers import OPTIMIZERS, OptResult
from repro_torch.core.pareto import hypervolume_2d
from repro_torch.designs import QUICK_DESIGNS, make_design

__all__ = ["Campaign", "CampaignSpec", "CampaignTask", "DesignContext",
           "QUICK_DESIGNS", "TaskSpec", "default_workers"]


@dataclasses.dataclass(frozen=True)
class TaskSpec:
    """One DSE task: an optimizer run on a design with a seed/budget."""

    design: str
    optimizer: str
    seed: int = 0
    budget: int = 300
    kwargs: Tuple[Tuple[str, object], ...] = ()

    @property
    def key(self) -> str:
        return f"{self.design}:{self.optimizer}:s{self.seed}"


@dataclasses.dataclass(frozen=True)
class CampaignSpec:
    """What to run and how to evaluate it.

    How to *evaluate* lives in ``eval`` (an
    :class:`~repro_torch.core.config.EvalConfig` — the same object advisors
    and checkpoints carry); the remaining fields are
    scheduling concerns.  The pre-``EvalConfig`` spellings
    (``backend=``/``max_iters=``/``shards=`` directly on the spec) still
    construct and read correctly — they emit a
    :class:`DeprecationWarning` and are folded into ``eval``; the
    attributes remain readable as views of it.
    """

    designs: Tuple[str, ...]
    optimizers: Tuple[str, ...]
    budget: int = 300
    seed: int = 0
    #: deprecated spelling of ``eval.backend``
    backend: Optional[str] = None
    #: deprecated spelling of ``eval.max_iters``
    max_iters: Optional[int] = None
    #: worklist worker processes; 0 = evaluate inline in this process
    workers: int = 0
    #: pack cross-design full-solve batches into one fixpoint dispatch
    #: (the device path; on CPU the pooled worklist is faster).
    #: Hetero dispatch runs in the scheduler process, so ``workers`` is
    #: ignored in this mode (no pool is spawned)
    hetero: bool = False
    #: deprecated spelling of ``eval.shards``.  Hetero campaigns shard
    #: the packed cross-design batch (design-parallel); per-design
    #: campaigns force ``backend="mesh"``.  None = unsharded.
    shards: Optional[int] = None
    #: rounds between automatic checkpoints (when a path is configured)
    checkpoint_every: int = 8
    #: seconds between automatic checkpoints (when a path is
    #: configured) — complements the round cadence for long rounds;
    #: None disables the timer
    checkpoint_every_s: Optional[float] = None
    #: record per-round (n_evals, hypervolume) trajectories per task —
    #: costs a full frontier recomputation per task per round, so it is
    #: off by default and meant for convergence studies
    track_hypervolume: bool = False
    #: how to evaluate candidate configurations
    eval: Optional[EvalConfig] = None

    def __post_init__(self):
        object.__setattr__(self, "designs", tuple(self.designs))
        object.__setattr__(self, "optimizers", tuple(self.optimizers))
        legacy = {k: getattr(self, k)
                  for k in ("backend", "max_iters", "shards")
                  if getattr(self, k) is not None}
        if self.eval is None:
            if legacy:
                import warnings
                warnings.warn(
                    f"CampaignSpec({', '.join(sorted(legacy))}=...) is "
                    f"deprecated; pass eval=EvalConfig(...) instead",
                    DeprecationWarning, stacklevel=3)
            object.__setattr__(self, "eval", EvalConfig(**legacy))
        elif legacy:
            raise TypeError(
                f"CampaignSpec: pass either eval=EvalConfig(...) or the "
                f"deprecated field(s) {sorted(legacy)}, not both")
        # keep the deprecated fields readable as views of ``eval`` (the
        # whole codebase reads spec.backend / spec.max_iters / spec.shards)
        object.__setattr__(self, "backend", self.eval.backend)
        object.__setattr__(self, "max_iters", self.eval.max_iters)
        object.__setattr__(self, "shards", self.eval.shards)

    def tasks(self) -> List[TaskSpec]:
        return [TaskSpec(design=d, optimizer=o, seed=self.seed,
                         budget=self.budget)
                for d in self.designs for o in self.optimizers]


class DesignContext:
    """Shared per-design state: trace, evaluator, cache, baselines.
    ``device`` is the torch device of the advisor's tensor backends
    (None = CUDA)."""

    def __init__(self, name: str, spec: CampaignSpec, device=None):
        self.name = name
        # hetero campaigns shard the packed cross-design dispatch instead
        # of each per-design evaluator (which only serves incremental and
        # escalation rows there)
        cfg = spec.eval
        if spec.hetero and cfg.shards is not None:
            cfg = cfg.replace(shards=None)
        self.advisor = FifoAdvisor(make_design(name), cfg, device=device)

    @property
    def graph(self):
        return self.advisor.graph

    @property
    def cache(self):
        return self.advisor.cache

    @property
    def evaluator(self):
        return self.advisor.evaluator


class CampaignTask:
    """One stepwise optimizer bound to its design context."""

    def __init__(self, spec: TaskSpec, dctx: DesignContext):
        self.spec = spec
        self.dctx = dctx
        self.ctx = dctx.advisor.make_context(seed=spec.seed)
        cls = OPTIMIZERS[spec.optimizer]
        self.opt = cls(self.ctx, budget=spec.budget, **dict(spec.kwargs))
        self.step_miss: List[int] = []   # per-step simulated-row counts
        self.eval_s = 0.0                # attributed evaluation seconds
        self.result: Optional[OptResult] = None
        self.worker: Optional[int] = None    # sticky pool affinity
        self.hv_trace: List[Tuple[int, float]] = []  # (n_evals, hv)

    @property
    def key(self) -> str:
        return self.spec.key

    @property
    def done(self) -> bool:
        return self.result is not None

    def finalize(self):
        self.result = self.ctx.result(
            self.opt.name, self.opt.step_s + self.eval_s)

    def running_hypervolume(self) -> float:
        res = self.ctx.result(self.opt.name, 0.0)
        pts, _ = res.frontier()
        return hypervolume_2d(
            pts, self.dctx.advisor.baseline_max.hv_reference())


class Campaign:
    """Round-robin scheduler over many stepwise DSE tasks.

    Owns task construction, lane assignment, checkpoint cadence, and the
    worker-pool/hetero lifecycle; the per-round evaluation routing itself
    lives in the shared :class:`~repro_torch.core.campaign.router
    .RoundRouter`.  ``device`` is the torch device of the advisors and of
    the hetero dispatch (None = CUDA), and ``mesh`` an explicit
    :class:`repro_torch.launch.mesh.Mesh` for the hetero dispatch (in
    place of ``spec.shards``; hetero campaigns only).  Both are runtime
    choices, not part of the checkpointed spec.
    """

    def __init__(self, spec: CampaignSpec,
                 tasks: Optional[Sequence[TaskSpec]] = None,
                 checkpoint_path: Optional[str] = None, device=None,
                 mesh=None):
        with obs.span("campaign.construct"):
            if mesh is not None and not spec.hetero:
                raise ValueError("Campaign(mesh=...) shards the hetero "
                                 "dispatch only; per-design campaigns shard "
                                 "through spec.eval.shards")
            self.spec = spec
            self.device = device
            self.checkpoint_path = checkpoint_path
            self.round = 0
            task_specs = list(tasks) if tasks is not None else spec.tasks()
            self.designs: Dict[str, DesignContext] = {}
            for ts in task_specs:
                if ts.design not in self.designs:
                    self.designs[ts.design] = DesignContext(ts.design, spec,
                                                            device)
            self.tasks = [CampaignTask(ts, self.designs[ts.design])
                          for ts in task_specs]
            self.pool = None
            #: pool recovery counters from the last closed pool (chaos gate)
            self.pool_stats: Optional[Dict] = None
            from repro_torch.core.faults import resolve_plan
            self.faults = resolve_plan(spec.eval)
            if spec.workers > 0 and not spec.hetero:
                # after the design contexts so forked workers inherit the
                # built graphs + worklist tables (an advisor that initialised
                # CUDA makes the pool spawn instead).  Hetero mode owns
                # every full-solve row in the main process, so a pool would
                # only ever idle — it is not created (incremental rows run
                # inline there).
                from repro_torch.core.campaign.pool import WorkerPool
                self.pool = WorkerPool(
                    spec.workers, max_iters=spec.max_iters,
                    graphs={k: d.graph for k, d in self.designs.items()},
                    faults=self.faults)
            # evaluation lanes: lane 0 is THIS process (overlapped with the
            # pool via submit/collect), lanes 1..workers are pool workers.
            # Stagger the per-design assignment so the same optimizer on
            # different designs lands on different lanes (otherwise every
            # incremental-heavy task can alias onto one lane).
            n_lanes = spec.workers + 1 if self.pool is not None else 1
            design_index = {k: i for i, k in enumerate(self.designs)}
            per_design_count: Dict[str, int] = {}
            for task in self.tasks:
                k = task.spec.design
                c = per_design_count.get(k, 0)
                per_design_count[k] = c + 1
                task.worker = (c + design_index[k]) % n_lanes
            hetero = None
            if spec.hetero:
                from repro_torch.core.backends.dispatch import HeteroDispatcher
                graphs = {k: d.graph for k, d in self.designs.items()}
                worklists = {k: d.evaluator._worklist
                             for k, d in self.designs.items()}
                hetero = HeteroDispatcher(graphs, worklists,
                                          max_iters=spec.max_iters,
                                          mesh=mesh, shards=spec.shards,
                                          device=device)
            self.router = RoundRouter(self.designs, pool=self.pool,
                                      hetero=hetero)

    @property
    def hetero(self):
        return self.router.hetero

    # ------------------------------------------------------------- rounds
    def _round(self) -> int:
        """Advance every active task one step; returns #active tasks."""
        with obs.span("campaign.round"):
            pending: List[RoutedRequest] = []
            for task in self.tasks:
                if task.done:
                    continue
                req = task.opt.propose()
                if req is None:
                    task.finalize()
                    continue
                lat, bram, dead, miss = task.dctx.cache.lookup(req.depths)
                pending.append(RoutedRequest(
                    key=task.spec.design, req=req, lat=lat, bram=bram,
                    dead=dead, miss_rows=np.flatnonzero(miss),
                    lane=task.worker, tag=task))
            self.router.route(pending)
            for p in pending:
                task = p.tag
                rows = p.miss_rows
                if rows.size:
                    task.dctx.cache.insert(
                        p.req.depths[rows], p.lat[rows], p.bram[rows],
                        p.dead[rows])
                task.eval_s += p.eval_s
                task.ctx.record(p.req.depths, p.lat, p.bram, p.dead,
                                rows.size)
                task.step_miss.append(int(rows.size))
                task.opt.observe(p.lat, p.bram, p.dead)
                if self.spec.track_hypervolume:
                    task.hv_trace.append(
                        (task.ctx.n_evals, task.running_hypervolume()))
            self.round += 1
            return len(pending)

    # -------------------------------------------------------------- runs
    def run(self, max_rounds: Optional[int] = None):
        """Run rounds until every task finishes (or ``max_rounds``).

        Returns the :class:`~repro_torch.core.campaign.store.ResultStore` over
        the finished tasks.  When a checkpoint path is configured, state
        is saved every ``spec.checkpoint_every`` rounds and at exit.
        """
        import time as _time

        from repro_torch.core.campaign.state import save_checkpoint
        self._ensure_pool()
        rounds_done = 0
        last_save = _time.perf_counter()
        try:
            while True:
                active = self._round()
                rounds_done += 1
                due = (self.checkpoint_path is not None
                       and self.spec.checkpoint_every > 0
                       and self.round % self.spec.checkpoint_every == 0)
                every_s = self.spec.checkpoint_every_s
                if (self.checkpoint_path is not None and every_s
                        and _time.perf_counter() - last_save >= every_s):
                    due = True
                if active == 0:
                    break
                if due:
                    save_checkpoint(self, self.checkpoint_path)
                    last_save = _time.perf_counter()
                if max_rounds is not None and rounds_done >= max_rounds:
                    break
            if self.checkpoint_path is not None:
                save_checkpoint(self, self.checkpoint_path)
        finally:
            self.close()
        return self.result_store()

    def result_store(self):
        from repro_torch.core.campaign.store import ResultStore
        store = ResultStore()
        for task in self.tasks:
            if task.done:
                store.add(task)
        return store

    @property
    def finished(self) -> bool:
        return all(t.done for t in self.tasks)

    def _ensure_pool(self):
        """Recreate the worker pool if a previous ``run()`` closed it
        (e.g. a ``max_rounds`` pause) and work remains."""
        if (self.pool is None and self.spec.workers > 0
                and not self.spec.hetero and not self.finished):
            from repro_torch.core.campaign.pool import WorkerPool
            self.pool = WorkerPool(
                self.spec.workers, max_iters=self.spec.max_iters,
                graphs={k: d.graph for k, d in self.designs.items()},
                faults=self.faults)
        self.router.pool = self.pool

    def close(self):
        if self.pool is not None:
            self.pool_stats = dict(self.pool.stats)
            self.pool.close()
            self.pool = None
            self.router.pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ------------------------------------------------------------ resume
    @classmethod
    def resume(cls, path: str, workers: Optional[int] = None,
               checkpoint_path: Optional[str] = None,
               device=None) -> "Campaign":
        """Rebuild a campaign from a checkpoint and replay it to the
        recorded position (see ``repro_torch.core.campaign.state``).

        ``workers`` optionally overrides the worker count (a runtime
        concern, not part of the deterministic state); the checkpoint
        keeps being written to ``checkpoint_path`` (default: ``path``);
        ``device`` as in :class:`Campaign`.
        """
        from repro_torch.core.campaign.state import load_checkpoint, replay
        data = load_checkpoint(path)
        spec_dict = dict(data["spec"])
        if workers is not None:
            spec_dict["workers"] = workers
        ev = spec_dict.pop("eval", None)
        if ev is not None:
            spec_dict["eval"] = EvalConfig.from_dict(ev)
        else:
            # version-1 checkpoint: the eval knobs were spec fields;
            # fold them into an EvalConfig without a deprecation warning
            # (resuming old state is supported, not deprecated)
            spec_dict["eval"] = EvalConfig(**{
                k: spec_dict.pop(k)
                for k in ("backend", "max_iters", "shards")
                if spec_dict.get(k) is not None})
        spec = CampaignSpec(**spec_dict)
        tasks = [TaskSpec(design=t["design"], optimizer=t["optimizer"],
                          seed=t["seed"], budget=t["budget"],
                          kwargs=tuple(map(tuple, t["kwargs"])))
                 for t in data["tasks"]]
        camp = cls(spec, tasks=tasks,
                   checkpoint_path=checkpoint_path or path, device=device)
        replay(camp, data)
        return camp


def default_workers() -> int:
    """Worker count for ``--workers auto``.

    The scheduler's own process is evaluation lane 0, so ``cpu - 1``
    pool workers saturate the machine without oversubscribing (capped —
    campaign rounds rarely keep more than a few lanes busy)."""
    return max(1, min(4, (os.cpu_count() or 2) - 1))
