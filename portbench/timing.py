"""Window and spread arithmetic of the benchmark.

Pure Python, so the CPU tests hold it to made-up timings.
"""

from __future__ import annotations

import statistics
from typing import Sequence


def rate_over_window(start: float, ends: Sequence[float]) -> float:
    """Seconds per completed job over a closed loop's whole window: the
    window runs from ``start`` to the end of its last job, and every job
    completed in it counts."""
    if not ends:
        raise ValueError("no job completed in the window")
    return (max(ends) - start) / len(ends)


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartile, as
    ``statistics.quantiles(values, n=4)`` gives them, over the median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
