"""Greedy heuristic (INR-Arch), paper §III-D.

Starting from Baseline-Max, visit FIFOs ranked by observed max occupancy
(largest first); set each to depth 2 and keep the reduction unless it
deadlocks or inflates latency beyond (1 + epsilon) x baseline.  An optional
refinement pass (on by default; it explains the paper's 10–2200 adaptive
sample counts) binary-searches the breakpoint grid of each *rejected* FIFO
for the smallest still-acceptable depth.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.optimizers.base import (EvalContext, EvalRequest,
                                              Optimizer)


class GreedySearch(Optimizer):
    name = "greedy"

    def __init__(self, ctx: EvalContext, budget: int = 10**9,
                 epsilon: float = 0.01, refine: bool = True):
        super().__init__(ctx, budget)   # budget is a cap, not a target
        self.epsilon = float(epsilon)
        self.refine = refine

    def _steps(self):
        ctx = self.ctx
        cur = ctx.baseline_max()
        lat, _, dead = yield EvalRequest(cur)
        if dead[0]:  # pragma: no cover - Baseline-Max is deadlock-free
            raise RuntimeError("Baseline-Max deadlocked")
        limit = int(lat[0]) * (1.0 + self.epsilon)

        order = np.argsort(-ctx.g.max_occupancy, kind="stable")
        rejected = []
        for f in order:
            if ctx.n_evals >= self.budget:
                break
            # the paper's "set to 2" = the smallest candidate depth; the
            # grid floor is 2 unless the context clamps it higher (e.g. a
            # certified deadlock-free floor)
            floor = int(ctx.candidates[f][0])
            if cur[f] <= floor:
                continue
            trial = cur.copy()
            trial[f] = floor
            # single-FIFO move vs the accepted config: the incremental
            # re-simulation fast path re-solves only coupled segments
            lat, _, dead = yield EvalRequest(trial, base=cur)
            if not dead[0] and lat[0] <= limit:
                cur = trial
            else:
                rejected.append(int(f))

        if self.refine:
            for f in rejected:
                if ctx.n_evals >= self.budget:
                    break
                cand = ctx.candidates[f]
                lo, hi = 0, len(cand) - 1   # cand[hi] ~ current (accepted)
                # invariant: cand[hi] acceptable, cand[lo] == 2 rejected
                while hi - lo > 1 and ctx.n_evals < self.budget:
                    mid = (lo + hi) // 2
                    trial = cur.copy()
                    trial[f] = cand[mid]
                    lat, _, dead = yield EvalRequest(trial, base=cur)
                    if not dead[0] and lat[0] <= limit:
                        hi = mid
                    else:
                        lo = mid
                if cand[hi] < cur[f]:
                    cur[f] = cand[hi]
            # re-evaluate final config so it is part of the history
            yield EvalRequest(cur)
