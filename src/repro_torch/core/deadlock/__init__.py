"""Deadlock diagnosis and certification.

Two first-class capabilities on top of the boolean ``deadlocked`` flag:

* **blame** — wait-for-graph extraction from deadlocked oracle runs with
  per-FIFO blame assignment (which channels sit on the blocking cycle);
* **certification** — minimal deadlock-free depth vectors via monotone
  binary search, driven through the incremental ``solve_delta`` /
  :class:`~repro_torch.core.backends.ConfigCache` fast path, with a naive
  oracle-bisection arbiter for cross-checking.

``FifoAdvisor.min_safe_depths()`` is the high-level entry point; see
``docs/fuzzing.md`` for semantics.
"""

from repro_torch.core.deadlock.certify import (CertificationResult,
                                               certify_min_depths,
                                               certify_min_depths_oracle)
from repro_torch.core.deadlock.waitgraph import (WaitEdge, WaitForGraph,
                                                 deadlock_blame,
                                                 extract_wait_graph,
                                                 fifo_endpoints)

__all__ = [
    "CertificationResult", "WaitEdge", "WaitForGraph",
    "certify_min_depths", "certify_min_depths_oracle", "deadlock_blame",
    "extract_wait_graph", "fifo_endpoints",
]
