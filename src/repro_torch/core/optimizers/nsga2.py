"""NSGA-II evolutionary multi-objective search (beyond-paper optimizer).

Non-dominated sorting + crowding-distance selection over grid-index
genomes.  Each generation evaluates the whole offspring population in one
batched simulator call, so this optimizer is nearly free on top of the
vectorized evaluator — the paper's single-config evaluation model would
make it budget-hungry.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.optimizers.base import (EvalContext, EvalRequest,
                                              Optimizer)


def _non_dominated_sort(obj: np.ndarray) -> np.ndarray:
    """(N,2) objectives (minimize) -> integer front rank per row."""
    n = obj.shape[0]
    rank = np.full(n, -1, dtype=np.int64)
    remaining = np.arange(n)
    r = 0
    while remaining.size:
        pts = obj[remaining]
        # non-dominated within remaining
        order = np.lexsort((pts[:, 1], pts[:, 0]))
        best = np.inf
        keep = np.zeros(len(remaining), dtype=bool)
        for oi in order:
            if pts[oi, 1] < best:
                keep[oi] = True
                best = pts[oi, 1]
            elif pts[oi, 1] == best and not np.any(
                    (pts[:, 0] < pts[oi, 0]) & (pts[:, 1] <= pts[oi, 1])):
                keep[oi] = True
        rank[remaining[keep]] = r
        remaining = remaining[~keep]
        r += 1
    return rank


def _crowding(obj: np.ndarray) -> np.ndarray:
    n = obj.shape[0]
    dist = np.zeros(n)
    for k in range(2):
        order = np.argsort(obj[:, k], kind="stable")
        span = obj[order[-1], k] - obj[order[0], k]
        dist[order[0]] = dist[order[-1]] = np.inf
        if span > 0 and n > 2:
            dist[order[1:-1]] += (obj[order[2:], k] -
                                  obj[order[:-2], k]) / span
    return dist


class NSGA2(Optimizer):
    name = "nsga2"

    def __init__(self, ctx: EvalContext, budget: int = 1000,
                 pop_size: int = 64, grouped: bool = True,
                 mut_rate: float = 0.15):
        super().__init__(ctx, budget)
        self.pop = int(pop_size)
        self.grouped = grouped
        self.mut_rate = float(mut_rate)

    def _dims(self) -> np.ndarray:
        return (self.ctx.group_grid_sizes if self.grouped
                else self.ctx.grid_sizes)

    def _depths(self, idx: np.ndarray) -> np.ndarray:
        return (self.ctx.depths_from_group_indices(idx) if self.grouped
                else self.ctx.depths_from_indices(idx))

    # Large finite penalty keeps crowding-distance arithmetic well-defined.
    _PENALTY = 1e12

    def _objectives(self, lat: np.ndarray, bram: np.ndarray,
                    dead: np.ndarray) -> np.ndarray:
        penal = np.where(dead, self._PENALTY, 0.0)
        return np.stack([lat + penal, bram + penal],
                        axis=1).astype(np.float64)

    def _steps(self):
        rng = self.ctx.rng
        dims = self._dims()
        D = len(dims)
        P = min(self.pop, max(8, self.budget // 4))

        # init: corners + random
        pop = np.stack(
            [rng.integers(0, dims[d], size=P) for d in range(D)], axis=1)
        pop[0] = dims - 1      # Baseline-Max corner
        pop[1] = 0             # Baseline-Min corner
        lat, bram, dead = yield EvalRequest(self._depths(pop))
        obj = self._objectives(lat, bram, dead)
        remaining = self.budget - P

        while remaining >= P:
            rank = _non_dominated_sort(obj)
            crowd = _crowding(obj)
            # binary tournament on (rank asc, crowding desc)
            a = rng.integers(0, P, size=P)
            b = rng.integers(0, P, size=P)
            better = (rank[a] < rank[b]) | (
                (rank[a] == rank[b]) & (crowd[a] >= crowd[b]))
            parents = np.where(better, a, b)
            # uniform crossover + per-gene mutation
            pa = pop[parents]
            pb = pop[parents[rng.permutation(P)]]
            xmask = rng.random((P, D)) < 0.5
            child = np.where(xmask, pa, pb)
            mmask = rng.random((P, D)) < self.mut_rate
            if mmask.any():
                noise = rng.integers(0, dims[None, :].repeat(P, 0))
                child = np.where(mmask, noise, child)
            lat, bram, dead = yield EvalRequest(self._depths(child))
            cobj = self._objectives(lat, bram, dead)
            remaining -= P
            # environmental selection from parents + children
            allpop = np.concatenate([pop, child], axis=0)
            allobj = np.concatenate([obj, cobj], axis=0)
            r = _non_dominated_sort(allobj)
            c = _crowding(allobj)
            order = np.lexsort((-c, r))
            keep = order[:P]
            pop, obj = allpop[keep], allobj[keep]
