"""Random sampling optimizers (paper §III-D, first two entries).

Both samplers draw depths ONLY from the pruned per-FIFO breakpoint grids —
"we use our BRAM usage model to suggest optimal sizes for each FIFO, from
which the sampler uniformly selects."  The grouped variant draws one index
per stream-array group (Stream-HLS arrays behave alike).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.optimizers.base import EvalRequest, Optimizer


class RandomSearch(Optimizer):
    name = "random"
    batch = 128

    def _steps(self):
        ctx = self.ctx
        remaining = self.budget
        F = ctx.g.n_fifos
        while remaining > 0:
            C = min(self.batch, remaining)
            idx = np.stack(
                [ctx.rng.integers(0, ctx.grid_sizes[f], size=C)
                 for f in range(F)], axis=1)
            yield EvalRequest(ctx.depths_from_indices(idx))
            remaining -= C


class GroupedRandomSearch(Optimizer):
    name = "grouped_random"
    batch = 128

    def _steps(self):
        ctx = self.ctx
        remaining = self.budget
        G = len(ctx.groups)
        while remaining > 0:
            C = min(self.batch, remaining)
            gidx = np.stack(
                [ctx.rng.integers(0, ctx.group_grid_sizes[gi], size=C)
                 for gi in range(G)], axis=1)
            yield EvalRequest(ctx.depths_from_group_indices(gidx))
            remaining -= C
