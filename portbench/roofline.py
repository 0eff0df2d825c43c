"""The kernels' roofline arithmetic and the H100's published peaks.

A copy of ``chip_smoke.py::bound_ms``, kept here so that a later change
to the program cannot move it.  A launch's bound is the larger of

* its bytes over the memory rate: every input tensor read once and every
  output tensor written once, and
* its float32 operations over the peak: the iterations its rows actually
  ran (the ``iters`` lane of the output) times ``E_pad`` times
  :data:`OPS_PER_EVENT_ITER`, plus :data:`OPS_PER_CERT_SLOT` per
  certificate slot.

The count is of the work these inputs need, whatever implements it.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

#: published peaks of one H100 SXM (data sheet; dense, no sparsity)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: float32 operations per event per fixpoint iteration: the edge add, the
#: max with delta, the scan combine (two adds and a max) and max(A, M)
OPS_PER_EVENT_ITER = 6
#: per certificate slot: the difference and the comparison
OPS_PER_CERT_SLOT = 2
#: the output lane that holds the iterations a row ran
ITERS_LANE = 3


def bound_s(n_bytes: int, iters: float, e_pad: int,
            cert_slots: int = 0) -> Tuple[float, str]:
    """(least seconds, what bounds it) of one launch."""
    ops = iters * e_pad * OPS_PER_EVENT_ITER + cert_slots * OPS_PER_CERT_SLOT
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tensor_bytes(tensors: Iterable) -> int:
    """Bytes of every tensor given, each counted once; None is skipped."""
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def share_percent(bound_total_s: float, device_s: float) -> Optional[float]:
    """The launches' bound over their measured device time, in percent;
    None when there is no device time to divide by."""
    if device_s <= 0:
        return None
    return 100.0 * bound_total_s / device_s
