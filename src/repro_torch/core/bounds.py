"""Analytical per-channel depth bounds from one pass over the trace.

The paper leans on runtime analysis because fully static FIFO sizing is
"restrictive" — but for the affine-stage majority of the Stream-HLS
suite, closed-form bounds in the style of Alias's polyhedral
process-network communication-patterns analysis are exact and free.
This module derives them from the packed :class:`~repro_torch.core.simgraph.
SimGraph` (the artifact every other engine already shares), so the
analysis is *static over the trace*: for affine designs the trace IS
the program and the bounds are closed-form; for data-dependent (DDCF)
designs they remain sound for the traced argument values and are
labelled as instance-specific.

Derivation
----------

For each FIFO ``f``, let read ``k`` (rank order) *transitively require*
write rank ``J_f(k)``: the largest write rank of ``f`` that must
complete before read ``k`` can issue, following program-order edges
within tasks and data edges across them.  One forward DP over the
trace (which is a topological order of program-order + data edges,
because the tracer runs tasks to completion in declaration order)
computes ``J`` for every channel simultaneously in O(E·F)::

    need[e] = max(need[prev-op-in-task], need[data_src[e]] if READ)
    need[e][fifo[e]] = max(need[e][fifo[e]], rank[e])   # on WRITE

With only ``f`` bounded at depth ``d`` (every other channel
behaviourally unbounded), the system deadlocks **iff** some read ``k``
requires a write ``J_f(k) >= k + d`` that back-pressure parks behind
it.  Hence the isolated minimal depth is exact::

    lower[f] = 1 + max_k (J_f(k) - k)        # slack of channel f

and it is a *sound lower bound* on the coordinate-descent certificate:
during descent every other coordinate sits at or below its
behaviourally-unbounded occupancy, so by monotonicity of feasibility
any ``d < lower[f]`` deadlocks in the descent context too.  The sound
upper bound is ``max_occupancy`` — a depth at that occupancy is
provably stall-free (:mod:`repro_torch.core.simgraph`), and it is exactly
the vector certification descends from.

Channels with ``lower == upper`` are **pinned**: their certified depth
is known without a single simulation probe.  Rate-matched map chains
pin at depth 1; reorder/burst channels (matmul column replay, conv
line buffers, fork/join skew) pin wherever the slack meets the
occupancy.  :func:`repro_torch.core.deadlock.certify_min_depths` accepts
these bounds to seed its start vector and floors, and the optimizers
clamp their candidate grids with ``lower`` (every candidate below it
deadlocks in *every* configuration).  See ``docs/bounds.md``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch import obs
from repro_torch.core.design import READ, WRITE
from repro_torch.core.simgraph import SimGraph

__all__ = [
    "ChannelBounds", "channel_bounds",
    "INORDER_MATCHED", "INORDER_MISMATCHED", "REORDER", "DATA_DEPENDENT",
]

#: producer/consumer never skew: every read k waits only on write k, and
#: at most one element is ever in flight — pinned exactly at depth 1.
INORDER_MATCHED = "inorder_matched"
#: reads stay in write order (slack 0) but bursts leave >1 element in
#: flight — depth 1 is feasible, larger depths only buy performance.
INORDER_MISMATCHED = "inorder_mismatched"
#: some read transitively requires a *later* write of the same channel
#: (cross-lane reorder, fork/join skew) — depth must cover the skew.
REORDER = "reorder"
#: an endpoint task is data-dependent (DDCF): bounds hold for the traced
#: arguments but are not closed-form over all inputs.
DATA_DEPENDENT = "data_dependent"


@dataclasses.dataclass
class ChannelBounds:
    """Per-FIFO analytical depth bounds plus the channel taxonomy.

    ``lower[f] <= certified[f] <= upper[f]`` for the coordinate-descent
    certificate; ``slack[f] = max_k (J_f(k) - k)`` is the reorder skew
    the lower bound covers (0 for in-order channels).
    """

    lower: np.ndarray     # (F,) sound lower bounds on certified depths
    upper: np.ndarray     # (F,) sound upper bounds (= max_occupancy)
    slack: np.ndarray     # (F,) max transitive write-rank skew per read
    kinds: tuple          # (F,) channel classification strings

    @property
    def n_fifos(self) -> int:
        return int(self.lower.shape[0])

    @property
    def pinned(self) -> np.ndarray:
        """Mask of channels whose exact depth is provable without probing."""
        return self.lower == self.upper

    @property
    def n_pinned(self) -> int:
        return int(self.pinned.sum())

    def to_dict(self) -> dict:
        """JSON-ready summary (fuzz reports, benchmark artifacts)."""
        return {
            "lower": self.lower.tolist(),
            "upper": self.upper.tolist(),
            "slack": self.slack.tolist(),
            "kinds": list(self.kinds),
            "n_pinned": self.n_pinned,
        }

    def describe(self, names=None) -> str:
        """Human-readable per-channel table (used by docs snippets)."""
        lines = ["fifo                 kind                lower upper  pinned"]
        for f in range(self.n_fifos):
            name = (names[f] if names is not None else f"#{f}")
            lines.append(
                f"{name:<20} {self.kinds[f]:<18} {int(self.lower[f]):>5}"
                f" {int(self.upper[f]):>5}  {'yes' if self.pinned[f] else ''}")
        return "\n".join(lines)


def _event_tasks(g: SimGraph) -> np.ndarray:
    """Owning task index per event (events are task-contiguous)."""
    task_of = np.zeros(g.n_events, dtype=np.int64)
    prev = 0
    for t in range(g.n_tasks):
        le = int(g.last_evt[t])
        if le >= 0:
            task_of[prev:le + 1] = t
            prev = le + 1
    return task_of


def last_owner(owner: np.ndarray, events: np.ndarray, fifo: np.ndarray,
               n_fifos: int) -> np.ndarray:
    """``owner`` of the last of ``events`` on each fifo (-1: none)."""
    last = np.full(n_fifos, -1, dtype=np.int64)
    np.maximum.at(last, fifo[events], events)
    out = np.full(n_fifos, -1, dtype=np.int64)
    has = last >= 0
    out[has] = owner[last[has]]
    return out


def _required_write_ranks(g: SimGraph) -> np.ndarray:
    """The need-DP: ``need[e, f]`` = max write rank of fifo ``f`` that
    event ``e`` transitively requires (-1: none).  O(E·F).

    One pass a task segment, in trace order: each event's row starts at
    -1 but for its own rank at its own fifo, a read whose ``data_src``
    lies in an earlier segment takes that (finished) row in, and a
    prefix max down the segment carries program order.  A ``data_src``
    earlier in the same segment is already inside the prefix max; one at
    or after the read contributes nothing."""
    E, F = g.n_events, g.n_fifos
    need = np.full((E, F), -1, dtype=np.int64)
    # the op itself touches write rank `rank[e]` of its fifo: a WRITE
    # emits it, a READ consumes it (its data_src already carries it, but
    # stating it keeps the invariant J(k) >= k explicit)
    need[np.arange(E), g.fifo] = g.rank
    starts = np.union1d(np.flatnonzero(g.seg_start), [0])[:E]
    src = g.data_src
    for lo, hi in zip(starts, np.append(starts[1:], E)):
        seg = slice(lo, hi)
        cross = lo + np.flatnonzero((g.kind[seg] == READ) & (src[seg] >= 0)
                                    & (src[seg] < lo))
        need[cross] = np.maximum(need[cross], need[src[cross]])
        np.maximum.accumulate(need[seg], axis=0, out=need[seg])
    return need


def channel_bounds(g: SimGraph) -> ChannelBounds:
    """Classify every channel and derive its ``(lower, upper)`` bounds.
    Timed by the :mod:`repro_torch.obs` span ``bounds`` (``fifos``;
    ``tight``: the channels whose lower bound is their upper)."""
    with obs.span("bounds", fifos=g.n_fifos) as span:
        out = _channel_bounds(g)
        if span:
            span.set(tight=int(np.sum(out.lower == out.upper)))
    return out


def _channel_bounds(g: SimGraph) -> ChannelBounds:
    F = g.n_fifos
    need = _required_write_ranks(g)
    task_of = _event_tasks(g)

    writes = np.flatnonzero(g.kind == WRITE)
    reads = np.flatnonzero(g.kind != WRITE)
    writer = last_owner(task_of, writes, g.fifo, F)
    reader = last_owner(task_of, reads, g.fifo, F)
    slack = np.zeros(F, dtype=np.int64)
    rf = g.fifo[reads]
    np.maximum.at(slack, rf, need[reads, rf] - g.rank[reads])

    upper = np.maximum(g.max_occupancy, 1).astype(np.int64)
    # slack exceeding occupancy-1 would contradict the occupancy proof
    # (depth == occupancy is stall-free); clip defensively so the bounds
    # stay sound even if a future scheduler tweak shifts occupancy.
    lower = np.minimum(1 + slack, upper)

    tasks = g.design.tasks if g.design is not None else []
    ddcf = np.zeros(F, dtype=bool)
    for f in range(F):
        for t in (writer[f], reader[f]):
            if t >= 0 and getattr(tasks[t], "data_dependent", False):
                ddcf[f] = True

    kinds = []
    for f in range(F):
        if ddcf[f]:
            kinds.append(DATA_DEPENDENT)
        elif slack[f] > 0:
            kinds.append(REORDER)
        elif upper[f] == 1:
            kinds.append(INORDER_MATCHED)
        else:
            kinds.append(INORDER_MISMATCHED)

    return ChannelBounds(lower=lower, upper=upper, slack=slack,
                         kinds=tuple(kinds))
