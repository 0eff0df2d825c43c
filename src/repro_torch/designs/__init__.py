"""Benchmark dataflow designs (Stream-HLS-style kernels + DDCF designs).

The reference's seeded random design generator (``generate.py``) waits
for ROADMAP P9.
"""

from repro_torch.designs.streamhls import (FAST_DESIGNS, QUICK_DESIGNS,
                                           STREAMHLS_DESIGNS, make_design)
from repro_torch.designs.ddcf import flowgnn_pna, mult_by_2

__all__ = ["FAST_DESIGNS", "QUICK_DESIGNS", "STREAMHLS_DESIGNS",
           "flowgnn_pna", "make_design", "mult_by_2"]
