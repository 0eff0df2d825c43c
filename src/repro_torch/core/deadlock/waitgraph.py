"""Wait-for-graph extraction and per-FIFO blame assignment.

When the discrete-event oracle (:mod:`repro_torch.core.oracle`) reports a
deadlock, every blocked task is stuck on exactly one FIFO op:

* blocked on a **READ** of fifo ``f``  -> it waits for ``f``'s *writer*
  task to produce the next element (``f`` is empty at its read rank);
* blocked on a **WRITE** to fifo ``f`` -> it waits for ``f``'s *reader*
  task to free a slot (``f`` is full at depth ``d_f``).

Each blocked task therefore has exactly one outgoing wait edge, so the
wait-for graph restricted to blocked tasks is a functional graph and
always contains at least one cycle — the deadlock cycle.  The FIFOs
labelling the edges of those cycles are the *blamed* channels: enlarging
(or, for empty-waits, filling) any one of them is what breaks the cycle.
This is the diagnosis FIFOAdvisor surfaces instead of a boolean flag.

FIFO endpoint tasks (single producer / single consumer, enforced by
:mod:`repro_torch.core.simgraph`) are recovered from the software-execution
trace, which always completes — sequential executability does not depend
on depths.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.design import Design, READ
from repro_torch.core.oracle import SimResult, simulate
from repro_torch.core.tracer import Trace, collect_trace

__all__ = ["WaitEdge", "WaitForGraph", "deadlock_blame",
           "extract_wait_graph", "fifo_endpoints"]


def fifo_endpoints(trace: Trace) -> Tuple[np.ndarray, np.ndarray]:
    """Per-fifo (writer_task, reader_task) indices from the trace
    (-1 where a side never touches the fifo)."""
    F = trace.design.n_fifos
    writer = np.full(F, -1, dtype=np.int64)
    reader = np.full(F, -1, dtype=np.int64)
    for tt in trace.tasks:
        for i in range(tt.n_ops):
            f = int(tt.fifos[i])
            if tt.kinds[i] == READ:
                reader[f] = tt.task
            else:
                writer[f] = tt.task
    return writer, reader


@dataclasses.dataclass(frozen=True)
class WaitEdge:
    """``waiter`` cannot progress until ``holder`` acts on ``fifo``."""

    waiter: str          # blocked task name
    holder: str          # the task it waits for
    fifo: str            # the channel the wait goes through
    reason: str          # "empty" (blocked read) | "full" (blocked write)


@dataclasses.dataclass
class WaitForGraph:
    """The wait-for graph of one deadlocked oracle run."""

    edges: List[WaitEdge]

    def cycles(self) -> List[List[str]]:
        """Task-name cycles, each rotated to start at its lexicographically
        smallest member (deterministic across runs).

        Every blocked task has exactly one outgoing edge, so cycles are
        found by pointer chasing in O(tasks).
        """
        nxt: Dict[str, str] = {e.waiter: e.holder for e in self.edges}
        seen: Set[str] = set()
        out: List[List[str]] = []
        for start in sorted(nxt):
            if start in seen:
                continue
            path: List[str] = []
            pos: Dict[str, int] = {}
            node: Optional[str] = start
            while node is not None and node not in seen:
                if node in pos:             # closed a new cycle
                    cyc = path[pos[node]:]
                    k = cyc.index(min(cyc))
                    out.append(cyc[k:] + cyc[:k])
                    break
                pos[node] = len(path)
                path.append(node)
                node = nxt.get(node)
            seen.update(path)
        return out

    def blame(self) -> List[str]:
        """Sorted names of the FIFOs on the blocking cycle(s) — the
        channels whose sizing participates in the deadlock."""
        on_cycle: Set[str] = set()
        for cyc in self.cycles():
            members = set(cyc)
            for e in self.edges:
                if e.waiter in members and e.holder in members:
                    on_cycle.add(e.fifo)
        return sorted(on_cycle)

    def describe(self) -> str:
        """Human-readable one-line-per-edge diagnosis."""
        lines = []
        for cyc in self.cycles():
            lines.append("cycle: " + " -> ".join(cyc + [cyc[0]]))
        for e in self.edges:
            lines.append(f"  {e.waiter} waits for {e.holder} "
                         f"({e.fifo} {e.reason})")
        return "\n".join(lines)


def extract_wait_graph(design: Design, result: SimResult,
                       trace: Optional[Trace] = None) -> WaitForGraph:
    """Build the wait-for graph of a deadlocked :class:`SimResult`.

    ``result`` must come from :func:`repro_torch.core.oracle.simulate` (it
    carries ``blocked_ops``); ``trace`` is collected on demand when not
    supplied by the caller.
    """
    if not result.deadlocked:
        return WaitForGraph(edges=[])
    if trace is None:
        trace = collect_trace(design)
    writer, reader = fifo_endpoints(trace)
    task_names = [t.name for t in design.tasks]
    edges: List[WaitEdge] = []
    for (name, kind, fifo) in result.blocked_ops:
        if kind == READ:
            holder, reason = writer[fifo], "empty"
        else:
            holder, reason = reader[fifo], "full"
        if holder < 0:       # no counterpart task ever touches this fifo
            continue
        edges.append(WaitEdge(waiter=name, holder=task_names[int(holder)],
                              fifo=design.fifos[fifo].name, reason=reason))
    return WaitForGraph(edges=edges)


def deadlock_blame(design: Design, depths: Sequence[int],
                   trace: Optional[Trace] = None) -> List[str]:
    """Run the oracle at ``depths`` and return the blamed FIFO names
    (empty list when the configuration is deadlock-free)."""
    result = simulate(design, depths)
    if not result.deadlocked:
        return []
    return extract_wait_graph(design, result, trace=trace).blame()
