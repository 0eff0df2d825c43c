"""Campaign result store: per-task frontiers, hypervolumes, summaries.

Wraps each finished :class:`~repro_torch.core.campaign.scheduler.CampaignTask`
in the same :class:`~repro_torch.core.advisor.DseResult` the single-run API
returns, so everything downstream (alpha-point selection, summaries,
benchmark plotting) works identically for campaign output.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.advisor import DseResult


class ResultStore:
    """Ordered map of task key -> :class:`DseResult` (+ campaign extras)."""

    def __init__(self):
        self.results: Dict[str, DseResult] = {}
        self.hv_traces: Dict[str, List] = {}

    def add(self, task) -> DseResult:
        """Wrap one finished campaign task as a :class:`DseResult`."""
        adv = task.dctx.advisor
        dse = DseResult(design_name=task.spec.design,
                        optimizer=task.spec.optimizer,
                        result=task.result,
                        baseline_max=adv.baseline_max,
                        baseline_min=adv.baseline_min,
                        trace_time_s=adv.trace_time_s)
        return self.add_result(task.key, dse, task.hv_trace)

    def add_result(self, key: str, dse: DseResult,
                   hv_trace=None) -> DseResult:
        """Store an already-built :class:`DseResult` under ``key`` —
        the hook for non-campaign producers (a service, ad
        hoc scripts) to reuse the summary/JSON machinery."""
        self.results[key] = dse
        self.hv_traces[key] = list(hv_trace or [])
        return dse

    def __len__(self) -> int:
        return len(self.results)

    def __getitem__(self, key: str) -> DseResult:
        return self.results[key]

    def keys(self):
        return self.results.keys()

    def frontiers(self) -> Dict[str, np.ndarray]:
        """Per-task Pareto frontier points (latency, BRAM)."""
        return {k: r.frontier_points for k, r in self.results.items()}

    def hypervolumes(self) -> Dict[str, float]:
        return {k: r.hypervolume() for k, r in self.results.items()}

    def total_evals(self) -> int:
        return sum(r.result.n_evals for r in self.results.values())

    def summary(self, alpha: float = 0.7) -> Dict:
        """JSON-ready per-task summaries + campaign totals."""
        tasks = {}
        for key, dse in self.results.items():
            entry = dse.summary(alpha)
            entry["hypervolume"] = dse.hypervolume()
            entry["frontier"] = dse.frontier_points.tolist()
            entry["hv_trace"] = self.hv_traces.get(key, [])
            tasks[key] = entry
        return {
            "n_tasks": len(self.results),
            "total_evals": self.total_evals(),
            "total_runtime_s": round(sum(
                r.result.runtime_s for r in self.results.values()), 3),
            "tasks": tasks,
        }

    def save_json(self, path: str, alpha: float = 0.7,
                  extra: Optional[Dict] = None) -> str:
        payload = self.summary(alpha)
        if extra:
            payload.update(extra)
        with open(path, "w") as f:
            json.dump(payload, f, indent=1, default=_np_default)
        return path


def _np_default(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(type(o))
