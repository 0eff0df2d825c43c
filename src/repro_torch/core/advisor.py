"""FIFOAdvisor: the top-level push-button DSE API (paper Fig. 1).

    advisor = FifoAdvisor(design)                  # trace once; on cuda
    dse = advisor.run("grouped_sa", budget=1000)   # search
    dse.frontier_points                            # Pareto (latency, BRAM)
    dse.selected(alpha=0.7)                        # the paper's ★ point
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.backends import ConfigCache
from repro_torch.core.config import EvalConfig
from repro_torch.core.design import Design
from repro_torch.core.optimizers import OPTIMIZERS, EvalContext, OptResult
from repro_torch.core.pareto import hypervolume_2d, select_alpha_point
from repro_torch.core.simgraph import SimGraph, build_simgraph
from repro_torch.core.simulate import BatchedEvaluator
from repro_torch.core.tracer import Trace, collect_trace


@dataclasses.dataclass
class Baseline:
    """One reference configuration: its depths and evaluated objectives.

    ``baseline_max`` (declared/observed upper bounds — always feasible)
    and ``baseline_min`` (all-depth-2 — the paper's deadlock probe) are
    the two the advisor evaluates up front.
    """

    depths: np.ndarray
    latency: int
    bram: int
    deadlocked: bool

    def hv_reference(self) -> Tuple[float, float]:
        """Hypervolume reference point anchored at this baseline (2x
        both objectives, nudged off the axes so boundary points count).
        The single definition used by results, campaign traces, and
        service progress events — they must never disagree."""
        return (self.latency * 2.0 + 1.0, self.bram * 2.0 + 2.0)


@dataclasses.dataclass
class DseResult:
    """The outcome of one DSE search: history, frontier, selection.

    Wraps the optimizer's raw :class:`OptResult` with the design's
    baselines so frontier queries, the paper's alpha-point selection,
    and hypervolume all resolve without re-touching the advisor.  The
    single-run API, the campaign store, and the advisory service all
    return this same type.
    """

    design_name: str
    optimizer: str
    result: OptResult
    baseline_max: Baseline
    baseline_min: Baseline
    trace_time_s: float

    @property
    def frontier_points(self) -> np.ndarray:
        """(M, 2) Pareto-optimal (latency, BRAM) points, deduplicated."""
        return self.result.frontier()[0]

    @property
    def frontier_configs(self) -> np.ndarray:
        """(M, F) depth vectors realizing :attr:`frontier_points`."""
        return self.result.frontier()[1]

    def selected(self, alpha: float = 0.7
                 ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """The paper's ★: frontier point minimizing the alpha score vs
        Baseline-Max.  Returns ((latency, bram), depths) or None."""
        pts, idx = self.result.feasible_points()
        if pts.shape[0] == 0:
            return None
        sel = select_alpha_point(
            pts, (self.baseline_max.latency, self.baseline_max.bram), alpha)
        if sel is None:
            return None
        return pts[sel], self.result.configs[idx[sel]]

    def hypervolume(self) -> float:
        """2-D dominated hypervolume of the frontier vs the fixed
        reference point derived from Baseline-Max (larger = better)."""
        return hypervolume_2d(self.frontier_points,
                              self.baseline_max.hv_reference())

    def summary(self, alpha: float = 0.7) -> Dict:
        """JSON-ready digest: budgets, baselines, frontier size, and the
        alpha-selected point with its vs-Baseline-Max ratios."""
        sel = self.selected(alpha)
        out = {
            "design": self.design_name,
            "optimizer": self.optimizer,
            "n_evals": self.result.n_evals,
            "runtime_s": round(self.result.runtime_s, 3),
            "trace_time_s": round(self.trace_time_s, 3),
            "frontier_size": int(self.frontier_points.shape[0]),
            "baseline_max": (self.baseline_max.latency,
                             self.baseline_max.bram),
            "baseline_min": (self.baseline_min.latency,
                             self.baseline_min.bram,
                             self.baseline_min.deadlocked),
            "n_deadlocked_samples": int(self.result.deadlock.sum()),
        }
        if sel is not None:
            (lat, bram), _ = sel
            out["selected"] = (int(lat), int(bram))
            out["lat_vs_max"] = round(
                lat / max(self.baseline_max.latency, 1), 4)
            out["bram_reduction_vs_max"] = round(
                1.0 - bram / max(self.baseline_max.bram, 1), 4)
        return out


class FifoAdvisor:
    """Traces the design once; runs any number of DSE searches on it.

    Construction is the expensive part (trace + simgraph build + the two
    baseline evaluations); afterwards every :meth:`run`, stepwise
    context (:meth:`make_context`), and incremental probe shares the
    trace, the pruned candidate grids, and one advisor-wide
    :class:`ConfigCache`.

    Args:
        design: the dataflow design to size.
        config: an :class:`~repro_torch.core.config.EvalConfig` — backend
            (default ``"cuda"``), iteration cap, condensation, pruning.
        upper_bounds: per-FIFO depth caps (default: declared/observed).
        device: the torch device of the tensor backends; ``None`` means
            CUDA and raises without a card (pass ``"cpu"`` to run the
            plain torch versions on the CPU).
    """

    def __init__(self, design: Design, config: Optional[EvalConfig] = None,
                 *, upper_bounds: Optional[np.ndarray] = None,
                 device=None):
        self.config = config if config is not None else EvalConfig()
        t0 = time.perf_counter()
        self.design = design
        self.trace: Trace = collect_trace(design)
        self.graph: SimGraph = build_simgraph(design, self.trace)
        self.evaluator = BatchedEvaluator(self.graph, self.config,
                                          device=device)
        # One evaluation cache for the whole advisor session: every
        # optimizer run (and the baselines) shares hits.
        self.cache = ConfigCache(self.graph.n_fifos)
        self.trace_time_s = time.perf_counter() - t0
        self._upper_bounds = upper_bounds
        self._certification = None   # cached CertificationResult
        self._lb_cache: Optional[np.ndarray] = None
        self._channel_bounds = None  # cached ChannelBounds
        self._incr_base: Optional[np.ndarray] = None
        # Shared baselines (evaluated outside any optimizer's budget).
        ctx = self._fresh_ctx(seed=0)
        self.baseline_max = self._baseline(ctx.baseline_max())
        self.baseline_min = self._baseline(ctx.baseline_min())

    @classmethod
    def restore(cls, design: Design, *, trace: Trace, graph: SimGraph,
                config: EvalConfig, upper_bounds=None, rungs=None,
                baseline_max: "Baseline", baseline_min: "Baseline",
                certification=None, lb_cache=None,
                cache_data=None, device=None) -> "FifoAdvisor":
        """Rebuild an advisor from previously computed parts.

        The warm-restart constructor: the expensive artifacts — trace,
        simgraph, condensation ``rungs``, deadlock ``certification``,
        and the evaluation-cache contents (``cache_data`` = ``(rows,
        lat, bram, dead)`` in insertion order) — are handed in instead
        of recomputed, so construction is milliseconds.  A restored
        advisor is bit-identical to a freshly traced one in everything
        observable but wall-clock (``trace_time_s`` records the restore
        time) and ``n_evals`` (cache hits are not re-simulated).
        """
        t0 = time.perf_counter()
        self = cls.__new__(cls)
        self.config = config
        self.design = design
        self.trace = trace
        self.graph = graph
        self.evaluator = BatchedEvaluator(graph, config, rungs=rungs,
                                          device=device)
        self.cache = ConfigCache(graph.n_fifos)
        if cache_data is not None:
            self.cache.load_rows(*cache_data)
        self._upper_bounds = upper_bounds
        self._certification = certification
        self._lb_cache = lb_cache
        self._channel_bounds = None
        self._incr_base = None
        self.baseline_max = baseline_max
        self.baseline_min = baseline_min
        self.trace_time_s = time.perf_counter() - t0
        return self

    def make_context(self, seed: int = 0) -> EvalContext:
        """A fresh :class:`EvalContext` sharing this advisor's evaluator,
        candidate pruning, and design-wide evaluation cache (the hook for
        driving optimizers stepwise outside :meth:`run`)."""
        return self._fresh_ctx(seed)

    def _fresh_ctx(self, seed: int) -> EvalContext:
        cfg = self.config
        if cfg.local_bounds and self._lb_cache is None:
            from repro_torch.core.prune import local_lower_bounds
            base = EvalContext(self.graph, self.evaluator,
                               upper_bounds=self._upper_bounds,
                               occupancy_cap=cfg.occupancy_cap, seed=0)
            self._lb_cache = local_lower_bounds(self.graph, base.candidates)
        lb = self._lb_cache
        if cfg.channel_bounds:
            # Analytical lower bounds are sound the same way local
            # bounds are: below them every configuration deadlocks, so
            # pruning those candidates never loses a feasible point.
            analytical = self.channel_bounds().lower
            lb = analytical if lb is None else np.maximum(lb, analytical)
        floor = self.min_safe_depths() if cfg.certified_floor else None
        return EvalContext(self.graph, self.evaluator,
                           upper_bounds=self._upper_bounds,
                           occupancy_cap=cfg.occupancy_cap,
                           lower_bounds=lb,
                           feasible_floor=floor, seed=seed,
                           cache=self.cache)

    def _baseline(self, depths: np.ndarray) -> Baseline:
        m = np.asarray(depths, dtype=np.int64)[None, :]
        lat, bram, dead, miss = self.cache.lookup(m)
        if miss.any():
            lat, bram, dead = self.evaluator.evaluate(m)
            self.cache.insert(m, lat, bram, dead)
        return Baseline(depths=depths, latency=int(lat[0]),
                        bram=int(bram[0]), deadlocked=bool(dead[0]))

    def incremental_latency(self, depths: np.ndarray,
                            base: Optional[np.ndarray] = None
                            ) -> Tuple[int, bool]:
        """One incremental re-simulation (the LightningSim primitive).

        Re-solves only the task segments coupled to the FIFOs that changed
        vs ``base`` (default: the previous ``incremental_latency`` config;
        the first call is a full solve whose state seeds the cache).
        """
        depths = np.asarray(depths, dtype=np.int64).reshape(-1)
        if base is None:
            base = self._incr_base
        lat, _, dead = self.evaluator.evaluate_incremental(
            base, depths[None, :])
        self._incr_base = depths.copy()
        return int(lat[0]), bool(dead[0])

    def channel_bounds(self):
        """Analytical per-channel depth bounds + taxonomy for this design.

        One O(E·F) static pass over the packed trace
        (:func:`repro_torch.core.bounds.channel_bounds`): classifies every
        FIFO (in-order rate-matched / rate-mismatched / reorder /
        data-dependent) and derives sound closed-form ``(lower, upper)``
        bounds that bracket the certified minimal depths.  Computed once
        per advisor; :meth:`min_safe_depths` seeds certification with it
        (same certified vector, a fraction of the probes), and
        ``EvalConfig(channel_bounds=True)`` clamps every optimizer's
        candidate grids with the lower bounds.
        """
        if self._channel_bounds is None:
            from repro_torch.core.bounds import channel_bounds
            self._channel_bounds = channel_bounds(self.graph)
        return self._channel_bounds

    def min_safe_depths(self) -> np.ndarray:
        """Certified minimal deadlock-free depths (coordinate-wise).

        The returned vector is verified deadlock-free and no single FIFO
        can be lowered below it without deadlocking; any configuration at
        or above it *everywhere* is deadlock-free by depth monotonicity,
        so optimizers can clamp their candidate grids with it
        (``certified_floor=True``).

        Computed once per advisor by monotone binary search through this
        advisor's evaluator and cache
        (:func:`repro_torch.core.deadlock.certify_min_depths`), seeded by
        the analytical :meth:`channel_bounds` (identical vector, typically
        a fraction of the probes); subsequent calls return the cached
        vector.  When the advisor was built with explicit
        ``upper_bounds``, certification descends from them (so the
        certificate respects the caps) — and raises ``ValueError`` when
        no deadlock-free configuration exists under those caps.
        """
        if self._certification is None:
            from repro_torch.core.deadlock import certify_min_depths
            self._certification = certify_min_depths(
                self.graph, self.evaluator, cache=self.cache,
                upper=self._upper_bounds, bounds=self.channel_bounds())
        return self._certification.depths.copy()

    @property
    def certification(self):
        """The full :class:`~repro_torch.core.deadlock.CertificationResult`
        behind :meth:`min_safe_depths` (None until first computed)."""
        return self._certification

    def explain_deadlock(self, depths: np.ndarray):
        """Diagnose one configuration: run the DES oracle at ``depths``
        and return its :class:`~repro_torch.core.deadlock.WaitForGraph`
        (``.blame()`` names the FIFOs on the blocking cycle; the graph
        is empty when the configuration is deadlock-free)."""
        from repro_torch.core.deadlock import extract_wait_graph
        from repro_torch.core.oracle import simulate
        result = simulate(self.design, np.asarray(depths, dtype=np.int64))
        return extract_wait_graph(self.design, result, trace=self.trace)

    def cache_stats(self):
        """Shared evaluation-cache statistics for this advisor session."""
        return self.cache.stats

    def run(self, optimizer: str = "grouped_sa", budget: int = 1000,
            seed: int = 0, **kwargs) -> DseResult:
        """One blocking DSE search; returns its :class:`DseResult`.

        ``optimizer`` is a registry name (:data:`~repro_torch.core
        .optimizers.OPTIMIZERS`), ``budget`` is in simulated rows,
        ``kwargs`` go to the optimizer constructor.  Repeated runs share
        this advisor's cache.
        """
        cls = OPTIMIZERS[optimizer]
        ctx = self._fresh_ctx(seed)
        opt = cls(ctx, budget=budget, **kwargs)
        res = opt.run()
        return DseResult(design_name=self.design.name, optimizer=optimizer,
                         result=res, baseline_max=self.baseline_max,
                         baseline_min=self.baseline_min,
                         trace_time_s=self.trace_time_s)

    def run_all(self, optimizers=None, budget: int = 1000,
                seed: int = 0) -> Dict[str, DseResult]:
        """Run several optimizers back to back (default: the paper's
        five) and return ``{name: DseResult}``."""
        from repro_torch.core.optimizers import PAPER_OPTIMIZERS
        names = optimizers or PAPER_OPTIMIZERS
        return {n: self.run(n, budget=budget, seed=seed) for n in names}
