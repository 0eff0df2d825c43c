# A frozen copy of src/repro_torch/core/bram.py, imports renamed: part of the
# benchmark's yardstick, which later changes to the program do not move.
"""FIFO memory model: Algorithm 1 BRAM18K counting + breakpoint pruning.

Targets UltraScale+ style BRAM18K primitives with aspect ratios
1K x 18, 2K x 9, 4K x 4, 8K x 2, 16K x 1.  FIFOs with depth <= 2 or total
bits <= 1024 are implemented as shift registers (SRL) and cost zero BRAM.

The paper's §III-C pruning observation: ``f_bram`` only changes at a small
set of *breakpoints* in depth, so the DSE need only ever sample depths that
maximally utilize their allocated BRAMs.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

# (depth, width) aspect ratios of one BRAM18K, widest first (paper order).
BRAM18K_CONFIGS: Tuple[Tuple[int, int], ...] = (
    (1024, 18), (2048, 9), (4096, 4), (8192, 2), (16384, 1),
)
SRL_BITS = 1024     # depth*width at or under this => shift register
SRL_DEPTH = 2       # depth at or under this => shift register

# Extra read-latency cycle of a BRAM-backed FIFO vs a shift-register FIFO
# (Vitis behaviour; reproduces the paper's footnote-2 effect).
SRL_READ_LATENCY = 1
BRAM_READ_LATENCY = 2


def is_srl(depth: int, width: int) -> bool:
    return depth <= SRL_DEPTH or depth * width <= SRL_BITS


def fifo_read_latency(depth: int, width: int) -> int:
    return SRL_READ_LATENCY if is_srl(depth, width) else BRAM_READ_LATENCY


def read_latency_np(depths: np.ndarray, widths: np.ndarray) -> np.ndarray:
    """Vectorized :func:`fifo_read_latency` over broadcastable arrays —
    the single numpy copy of the SRL/BRAM rule (the evaluators and the
    condensation certificate must agree on it bit for bit)."""
    srl = (depths <= SRL_DEPTH) | (depths * widths <= SRL_BITS)
    return np.where(srl, SRL_READ_LATENCY, BRAM_READ_LATENCY)


def bram_count(depth: int, width: int) -> int:
    """Algorithm 1 from the paper, verbatim."""
    if is_srl(depth, width):
        return 0
    n = 0
    w = width
    for d_i, w_i in BRAM18K_CONFIGS:
        n += (w // w_i) * -(-depth // d_i)   # floor(w/w_i) * ceil(d/d_i)
        w = w % w_i
        if w > 0 and depth <= d_i:
            n += 1
            w = 0
    return n


def bram_count_np(depths: np.ndarray, widths: np.ndarray) -> np.ndarray:
    """Vectorized Algorithm 1 over arbitrary broadcastable int arrays."""
    depths = np.asarray(depths, dtype=np.int64)
    widths = np.asarray(widths, dtype=np.int64)
    n = np.zeros(np.broadcast(depths, widths).shape, dtype=np.int64)
    w = np.broadcast_to(widths, n.shape).copy()
    d = np.broadcast_to(depths, n.shape)
    for d_i, w_i in BRAM18K_CONFIGS:
        n += (w // w_i) * -(-d // d_i)
        w = w % w_i
        fits = (w > 0) & (d <= d_i)
        n += fits
        w = np.where(fits, 0, w)
    srl = (d <= SRL_DEPTH) | (d * np.broadcast_to(widths, n.shape) <= SRL_BITS)
    return np.where(srl, 0, n)


def design_bram_np(depth_matrix: np.ndarray,
                   widths: Sequence[int]) -> np.ndarray:
    """f_bram for a batch of configs: (C, n_fifos) -> (C,) total BRAMs."""
    w = np.asarray(widths, dtype=np.int64)[None, :]
    return bram_count_np(depth_matrix, w).sum(axis=-1)


def breakpoints(width: int, upper: int) -> np.ndarray:
    """All depths in [2, upper] that maximally utilize their BRAM count.

    Returns the sorted, deduplicated set {d : bram(d+1,w) > bram(d,w)}
    ∪ {2, upper} clipped to [2, upper].  These are the only depths the DSE
    should ever sample (any other depth is dominated: same BRAM cost,
    no-larger buffering).
    """
    upper = int(max(2, upper))
    cand = {2, upper}
    # SRL boundary: largest depth still mapped to a shift register.
    srl_edge = SRL_BITS // width
    if SRL_DEPTH < srl_edge < upper:
        cand.add(srl_edge)
    # BRAM row-count boundaries: multiples of each aspect-ratio depth.
    for d_i, _ in BRAM18K_CONFIGS:
        for k in range(1, upper // d_i + 1):
            cand.add(k * d_i)
        if d_i < upper:
            cand.add(d_i)          # the `depth <= d_i` condition flips here
    cand = sorted(c for c in cand if 2 <= c <= upper)
    # Keep only genuine step points (and always keep 2 and upper).
    out: List[int] = []
    for c in cand:
        if c in (2, upper) or bram_count(c + 1, width) > bram_count(c, width):
            out.append(c)
    return np.asarray(sorted(set(out)), dtype=np.int64)


def breakpoints_brute(width: int, upper: int) -> np.ndarray:
    """O(upper) reference used by property tests."""
    upper = int(max(2, upper))
    out = [2]
    for d in range(2, upper):
        if bram_count(d + 1, width) > bram_count(d, width):
            out.append(d)
    out.append(upper)
    return np.asarray(sorted(set(out)), dtype=np.int64)
