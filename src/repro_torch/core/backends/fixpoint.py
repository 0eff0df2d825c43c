"""Batched fixpoint backends: the plain torch fixpoint and the CUDA kernels.

Both compute event times as the least fixpoint of a monotone max-plus map;
each Jacobi step is

    cross-edge gathers (data edges + depth-dependent back-pressure)
    -> segmented max-plus scan along each task's ops

over a batch of candidate depth vectors.  A true deadlock is a positive
cycle: iterates grow strictly, provably never converging; rows are flagged
DEADLOCK as soon as any time exceeds the design's schedule upper bound,
and anything still unresolved at the iteration cap is reported UNRESOLVED
for the dispatch policy to escalate to the worklist arbiter.

The two backends share all operand preparation
(:mod:`repro_torch.core.backends.operands`) and the evaluation closures
(:mod:`repro_torch.kernels.fifo_eval.ops`); they differ only in the inner
fixpoint:

``FixpointBackend``  the plain torch fixpoint (Hillis-Steele doubling)
``CudaBackend``      the hand-written CUDA kernels
                     (:mod:`repro_torch.core.backends.pallas`)

Both take ``device=None`` (CUDA; raises without a card) or an explicit
device such as ``"cpu"``.  Numeric domain: times are exact in float32 while
below 2**24; the evaluator asserts the design's schedule upper bound stays
below 1.5e7 cycles.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from repro_torch.core.simgraph import SimGraph

from repro_torch.core.backends.base import (EvalBackend, register_backend,
                                            resolve_device)
from repro_torch.core.backends.operands import get_operands

#: minimum condensation ratio for the kernel backend to fuse the
#: certificate into the evaluation launch (kept from the reference so that
#: dispatch counts compare; re-deriving it on the H100 is ROADMAP work)
FUSED_MIN_COMPRESSION = 8.0


class _ScanBackend(EvalBackend):
    """Common wrapper: shared operands + one batched callable."""

    use_ref = True
    wants_bucketing = True

    def __init__(self, max_iters: int = 64, device=None):
        super().__init__(max_iters=max_iters,
                         device=resolve_device(device))

    def prepare(self, g: SimGraph):
        from repro_torch.kernels.fifo_eval.ops import (make_batched_eval,
                                                       make_condensed_eval)
        self.g = g
        self.ops = get_operands(g, self.device)
        self._call = make_batched_eval(
            g, use_ref=self.use_ref, max_iters=self.max_iters,
            device=self.device)
        self._call_times = None
        # the kernel backend prepared on a CondensedGraph fuses the
        # exactness certificate into the evaluation launch (the rung
        # cascade then never ships event times to the host); the plain
        # fixpoint keeps the host verifier as the cross-check.  Fusion
        # is used on high-compression rungs only: the 2-3x safe rung
        # stays on the scan path, where the host verifier's cost is
        # bounded by the few escalated rows that reach it.
        self._fused = None
        if not self.use_ref:
            from repro_torch.core.condense import CondensedGraph
            if (isinstance(g, CondensedGraph)
                    and g.compression >= FUSED_MIN_COMPRESSION):
                self._fused = make_condensed_eval(
                    g, max_iters=self.max_iters, device=self.device)
        return self.ops

    @property
    def fused_certificate(self) -> bool:
        return getattr(self, "_fused", None) is not None

    def evaluate_certified(self, depth_matrix: np.ndarray
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                      np.ndarray]:
        """(C, F) depths -> (latency i64, bram i64, status i8, cert bool)
        in ONE kernel launch: the condensed fixpoint and every folded
        cross constraint (``verify_rows`` semantics — cert is True only on
        CONVERGED rows whose expansion is provably the raw least
        fixpoint).  Only valid when :attr:`fused_certificate`."""
        m = np.atleast_2d(np.asarray(depth_matrix, dtype=np.int32))
        lat, bram, status, cert = self._fused(m)
        return (np.asarray(np.rint(lat), dtype=np.int64),
                np.asarray(bram, dtype=np.int64),
                np.asarray(status, dtype=np.int8),
                np.asarray(cert, dtype=bool))

    def evaluate(self, depth_matrix: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        m = np.atleast_2d(np.asarray(depth_matrix, dtype=np.int32))
        lat, bram, status = self._call(m)
        return (np.asarray(np.rint(lat), dtype=np.int64),
                np.asarray(bram, dtype=np.int64),
                np.asarray(status, dtype=np.int8))

    def evaluate_with_times(self, depth_matrix: np.ndarray
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                       np.ndarray]:
        """Like :meth:`evaluate`, also returning the (C, E_pad) final
        event times (int64) — the condensation certificate's input."""
        if self._call_times is None:
            from repro_torch.kernels.fifo_eval.ops import make_batched_eval
            self._call_times = make_batched_eval(
                self.g, use_ref=self.use_ref, max_iters=self.max_iters,
                with_times=True, device=self.device)
        m = np.atleast_2d(np.asarray(depth_matrix, dtype=np.int32))
        lat, bram, status, times = self._call_times(m)
        return (np.asarray(np.rint(lat), dtype=np.int64),
                np.asarray(bram, dtype=np.int64),
                np.asarray(status, dtype=np.int8),
                np.asarray(np.rint(times), dtype=np.int64))


@register_backend
class FixpointBackend(_ScanBackend):
    """The plain torch Jacobi + segmented-scan fixpoint."""

    name = "fixpoint"
    aliases = ("jax",)
    use_ref = True
