# A frozen copy of src/repro_torch/core/pareto.py, imports renamed: part of the
# benchmark's yardstick, which later changes to the program do not move.
"""Pareto-frontier utilities for the dual-objective (latency, BRAM) DSE."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def pareto_mask(points: np.ndarray) -> np.ndarray:
    """Boolean mask of non-dominated rows of an (N, 2) minimize-both array.

    O(N log N): sort by (f0, f1); sweep keeping the running min of f1.
    Duplicate points are all kept (they are mutually non-dominating).
    """
    pts = np.asarray(points, dtype=np.float64)
    if pts.size == 0:
        return np.zeros(0, dtype=bool)
    n = pts.shape[0]
    order = np.lexsort((pts[:, 1], pts[:, 0]))
    mask = np.zeros(n, dtype=bool)
    best_f1 = np.inf
    i = 0
    while i < n:
        # group rows with identical f0: dominance among them is via f1 only
        j = i
        f0 = pts[order[i], 0]
        while j < n and pts[order[j], 0] == f0:
            j += 1
        grp = order[i:j]
        g1 = pts[grp, 1]
        gmin = g1.min()
        if gmin < best_f1:
            mask[grp[g1 == gmin]] = True
            best_f1 = gmin
        else:
            mask[grp[g1 == best_f1]] = False  # strictly dominated
        i = j
    return mask


def pareto_front(points: np.ndarray) -> np.ndarray:
    """Indices of the Pareto-optimal rows, sorted by f0 ascending."""
    m = pareto_mask(points)
    idx = np.flatnonzero(m)
    return idx[np.argsort(points[idx, 0], kind="stable")]


def hypervolume_2d(points: np.ndarray, ref: Tuple[float, float]) -> float:
    """Dominated hypervolume (minimize both) w.r.t. reference point ``ref``."""
    pts = np.asarray(points, dtype=np.float64)
    if pts.size == 0:
        return 0.0
    idx = pareto_front(pts)
    front = pts[idx]
    front = front[(front[:, 0] < ref[0]) & (front[:, 1] < ref[1])]
    if front.size == 0:
        return 0.0
    hv = 0.0
    prev_f1 = ref[1]
    for f0, f1 in front:
        f1 = min(f1, prev_f1)
        hv += (ref[0] - f0) * (prev_f1 - f1)
        prev_f1 = f1
    return float(hv)


def alpha_score(points: np.ndarray, baseline: Tuple[float, float],
                alpha: float = 0.7) -> np.ndarray:
    """The paper's §IV-B selection metric, per point:

        alpha * (lat / base_lat) + (1 - alpha) * (bram / base_bram)

    A zero-BRAM baseline degrades the second term to ``bram / 1``.
    """
    pts = np.asarray(points, dtype=np.float64)
    base_lat = max(float(baseline[0]), 1.0)
    base_bram = max(float(baseline[1]), 1.0)
    return alpha * pts[:, 0] / base_lat + (1.0 - alpha) * pts[:, 1] / base_bram


def select_alpha_point(points: np.ndarray, baseline: Tuple[float, float],
                       alpha: float = 0.7) -> Optional[int]:
    """Index of the frontier point minimizing the alpha score (paper's ★)."""
    if np.asarray(points).size == 0:
        return None
    idx = pareto_front(points)
    scores = alpha_score(points[idx], baseline, alpha)
    return int(idx[int(np.argmin(scores))])
