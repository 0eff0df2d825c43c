"""Design registry: trace each design once, advise on it forever.

The registry is the service's only stateful view of a design.  The first
session that names a design pays the trace + simgraph build + baseline
evaluation (one-time, ~100 ms-scale); every later session on the same
design reuses the built :class:`~repro_torch.core.advisor.FifoAdvisor` —
its evaluator, pruned candidate grids, baselines, and the advisor-wide
:class:`~repro_torch.core.backends.ConfigCache`, so sessions share
evaluation hits with each other exactly as campaign tasks do.

Registry entries expose ``.evaluator`` and ``.graph`` (they ARE
``FifoAdvisor`` instances), so the registry mapping plugs directly into
:class:`~repro_torch.core.campaign.router.RoundRouter` as its design
table.

Every advisor is built on the registry's ``device`` (the torch device of
the tensor backends).  ``device=None`` means CUDA, and the registry
raises at construction when no card exists; ``device="cpu"`` runs the
kernels' plain torch versions on the CPU.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

from repro_torch.core.advisor import FifoAdvisor
from repro_torch.core.backends.base import resolve_device
from repro_torch.core.config import EvalConfig, resolve_config
from repro_torch.core.design import Design

__all__ = ["DesignRegistry"]


class DesignRegistry:
    """Mapping of design name -> cached :class:`FifoAdvisor`.

    Args:
        config: the :class:`EvalConfig` every advisor is built with
            (defaults to ``EvalConfig()``, the ``cuda`` backend).  The
            deprecated ``backend=``/``max_iters=`` keywords still map
            onto it.
        advisor_kwargs: extra *runtime-only* keyword arguments forwarded
            to every :class:`FifoAdvisor` (e.g. ``upper_bounds=...``).
        device: the torch device of every advisor's tensor backends and
            of the service's hetero dispatch; None = CUDA (raises
            without a card), ``"cpu"`` = the kernels' plain versions.
    """

    def __init__(self, config: Optional[EvalConfig] = None,
                 advisor_kwargs: Optional[dict] = None, device=None,
                 **legacy):
        self.config = resolve_config(config, legacy, "DesignRegistry")
        self.device = resolve_device(device)
        self.advisor_kwargs = dict(advisor_kwargs or {})
        self._advisors: Dict[str, FifoAdvisor] = {}
        #: names registered with an explicit Design object — these are
        #: NOT rebuildable via ``make_design`` in a fresh process, which
        #: matters to engines that re-trace by name (the worker pool)
        self.custom_names: set = set()
        #: set by the snapshot loader: {"restored": [...],
        #: "quarantined": {name: reason}} — None until a restore ran
        self.restore_report: Optional[dict] = None

    @property
    def backend(self) -> str:
        return self.config.backend

    @property
    def max_iters(self) -> int:
        return self.config.max_iters

    def register(self, name: str,
                 design: Optional[Design] = None) -> FifoAdvisor:
        """Return the advisor for ``name``, building it on first use.

        ``design`` optionally supplies an explicit :class:`Design` object
        (for custom, non-benchmark designs); otherwise the name is
        resolved through ``repro_torch.designs.make_design``.
        Re-registering an existing name returns the cached advisor
        untouched.
        """
        adv = self._advisors.get(name)
        if adv is not None:
            return adv
        if design is None:
            from repro_torch.designs import make_design
            design = make_design(name)
        else:
            self.custom_names.add(name)
        adv = FifoAdvisor(design, self.config, device=self.device,
                          **self.advisor_kwargs)
        self._advisors[name] = adv
        return adv

    def adopt(self, name: str, advisor: FifoAdvisor,
              custom: bool = False) -> FifoAdvisor:
        """Install a prebuilt advisor (the snapshot warm-restart path).

        Re-adopting an existing name replaces the cached advisor; the
        snapshot loader uses this to hand the registry fully restored
        advisors without re-tracing.
        """
        self._advisors[name] = advisor
        if custom:
            self.custom_names.add(name)
        return advisor

    # --------------------------------------------------- mapping protocol
    def __getitem__(self, name: str) -> FifoAdvisor:
        return self._advisors[name]

    def __contains__(self, name: str) -> bool:
        return name in self._advisors

    def __len__(self) -> int:
        return len(self._advisors)

    def __iter__(self) -> Iterator[str]:
        return iter(self._advisors)

    def names(self):
        """Registered design names, in registration order."""
        return list(self._advisors)

    def stats(self) -> Dict[str, dict]:
        """Per-design registry statistics (JSON-ready): trace time,
        graph size, baselines, and shared-cache hit counters."""
        out = {}
        for name, adv in self._advisors.items():
            cs = adv.cache_stats()
            out[name] = {
                "n_fifos": int(adv.graph.n_fifos),
                "n_events": int(adv.graph.n_events),
                "trace_time_s": round(adv.trace_time_s, 4),
                "baseline_max": (adv.baseline_max.latency,
                                 adv.baseline_max.bram),
                "cache": {"hits": cs.hits, "misses": cs.misses,
                          "hit_rate": round(cs.hit_rate, 4)},
            }
        return out
