"""Batched frontier descent (beyond-paper optimizer).

Feeds the batched evaluator whole batches instead of single moves:
alternate

  1. a large grouped-random exploration batch, and
  2. a local-mutation batch around every current frontier point
     (one-coordinate moves toward smaller depths, plus pairwise blends),

each phase being ONE batched simulator call (256 rows by default).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.optimizers.base import (EvalContext, EvalRequest,
                                              Optimizer)


class VmapSearch(Optimizer):
    name = "vmap_search"

    def __init__(self, ctx: EvalContext, budget: int = 1000,
                 explore_batch: int = 256, descend_batch: int = 256):
        super().__init__(ctx, budget)
        self.explore_batch = int(explore_batch)
        self.descend_batch = int(descend_batch)

    def _steps(self):
        ctx, rng = self.ctx, self.ctx.rng
        G = len(ctx.groups)
        remaining = self.budget

        # seed with the two baselines
        yield EvalRequest(
            np.stack([ctx.baseline_max(), ctx.baseline_min()]))
        remaining -= 2

        explore = True
        while remaining > 0:
            if explore:
                C = min(self.explore_batch, remaining)
                gidx = np.stack(
                    [rng.integers(0, ctx.group_grid_sizes[gi], size=C)
                     for gi in range(G)], axis=1)
                yield EvalRequest(ctx.depths_from_group_indices(gidx))
                remaining -= C
            else:
                res = ctx.result("tmp", 0.0)
                pts, front_cfg = res.frontier()
                if front_cfg.shape[0] == 0:
                    explore = True
                    continue
                C = min(self.descend_batch, remaining)
                base = front_cfg[rng.integers(0, front_cfg.shape[0], size=C)]
                trial = base.astype(np.int64).copy()
                F = ctx.g.n_fifos
                which = rng.integers(0, F, size=C)
                rows = np.arange(C)
                # move the chosen fifo down one breakpoint
                for i in range(C):
                    f = which[i]
                    cand = ctx.candidates[f]
                    pos = int(np.searchsorted(cand, trial[i, f]))
                    pos = max(0, min(pos, len(cand) - 1) - 1)
                    trial[i, f] = cand[pos]
                # blend a third of the batch with another frontier point
                nb = C // 3
                if nb and front_cfg.shape[0] > 1:
                    other = front_cfg[
                        rng.integers(0, front_cfg.shape[0], size=nb)]
                    mask = rng.random((nb, F)) < 0.5
                    trial[:nb] = np.where(mask, trial[:nb],
                                          other.astype(np.int64))
                yield EvalRequest(trial)
                remaining -= C
            explore = not explore
