"""Simulated annealing over the β-swept weighted objective (paper §III-D).

The multi-objective problem is scalarized as

    f(x) = (1 - β) · f_lat(x)/L0  +  β · f_bram(x)/B0

for β in linspace(0, 1, N); one annealing chain per β.  All N chains step in
lockstep so each optimizer step evaluates N candidate configs in ONE batched
simulator call — the vectorized evaluator makes the β sweep essentially free.
The frontier is extracted from the union of all evaluated points.

Deadlocked candidates get infinite energy (always rejected) but still count
against the sample budget, mirroring the paper's accounting.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.optimizers.base import EvalContext, EvalRequest, Optimizer


class SimulatedAnnealing(Optimizer):
    name = "sa"
    grouped = False

    def __init__(self, ctx: EvalContext, budget: int = 1000,
                 n_beta: int = 8, t0: float = 0.30, t_end: float = 0.002,
                 reset_prob: float = 0.10):
        super().__init__(ctx, budget)
        self.n_beta = int(n_beta)
        self.t0 = float(t0)
        self.t_end = float(t_end)
        self.reset_prob = float(reset_prob)

    # ------------------------------------------------------------------
    def _dims(self) -> np.ndarray:
        ctx = self.ctx
        return (ctx.group_grid_sizes if self.grouped else ctx.grid_sizes)

    def _depths(self, idx: np.ndarray) -> np.ndarray:
        ctx = self.ctx
        return (ctx.depths_from_group_indices(idx) if self.grouped
                else ctx.depths_from_indices(idx))

    def _steps(self):
        ctx = self.ctx
        rng = ctx.rng
        dims = self._dims()
        D = len(dims)
        N = self.n_beta
        betas = np.linspace(0.0, 1.0, N)

        # Normalizers from the two baselines (evaluated first, on budget).
        lat0, bram0, _ = yield EvalRequest(
            np.stack([ctx.baseline_max(), ctx.baseline_min()]))
        L0 = max(float(lat0[0]), 1.0)
        B0 = max(float(bram0[0]), 1.0)
        budget = self.budget - 2

        def energy(lat, bram, dead):
            e = ((1.0 - betas) * lat / L0 + betas * bram / B0)
            return np.where(dead, np.inf, e)

        # init chains at the max-index corner (Baseline-Max-like: feasible)
        state = np.tile((dims - 1)[None, :], (N, 1)).astype(np.int64)
        lat, bram, dead = yield EvalRequest(self._depths(state))
        budget -= N
        e_cur = energy(lat, bram, dead)

        steps = max(1, budget // N)
        cool = (self.t_end / self.t0) ** (1.0 / max(steps - 1, 1))
        temp = self.t0
        for _ in range(steps):
            # propose: single-coordinate move of +-1..2 (or random reset)
            prop = state.copy()
            pos = rng.integers(0, D, size=N)
            jump = rng.choice([-2, -1, 1, 2], size=N)
            rows = np.arange(N)
            prop[rows, pos] = np.clip(prop[rows, pos] + jump, 0,
                                      dims[pos] - 1)
            resets = rng.random(N) < self.reset_prob
            if resets.any():
                rand_pos = rng.integers(0, D, size=N)
                rand_val = rng.integers(0, dims[rand_pos])
                prop[resets, rand_pos[resets]] = rand_val[resets]

            # proposals differ from their chain's state by one coordinate:
            # eligible for the incremental re-simulation fast path
            lat, bram, dead = yield EvalRequest(
                self._depths(prop), base=self._depths(state))
            e_new = energy(lat, bram, dead)
            with np.errstate(invalid="ignore", over="ignore"):
                accept = (e_new <= e_cur) | (
                    rng.random(N) < np.exp(-(e_new - e_cur) /
                                           max(temp, 1e-9)))
            accept &= np.isfinite(e_new) | (e_new <= e_cur)
            state[accept] = prop[accept]
            e_cur = np.where(accept, e_new, e_cur)
            temp *= cool


class GroupedSimulatedAnnealing(SimulatedAnnealing):
    name = "grouped_sa"
    grouped = True
