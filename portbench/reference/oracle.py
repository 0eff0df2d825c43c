# A frozen copy of src/repro_torch/core/oracle.py, imports renamed: part of the
# benchmark's yardstick, which later changes to the program do not move.
"""Cycle-accurate discrete-event simulation of a design with bounded FIFOs.

This is the reproduction's stand-in for Vitis HLS C/RTL co-simulation: an
*independent* evaluator that executes the task generators directly against
bounded FIFO queues (values and data-dependent control flow included) and
resolves op completion times with a Kahn-style worklist over the dependency
structure.  It shares no code with the trace-based evaluator in
:mod:`repro_torch.core.simulate`; Table-II-style accuracy numbers compare
the two.

Timing semantics (shared contract, see DESIGN.md §2.1):

* op ``i`` of a task may not complete before ``t[i-1] + delta[i]``;
* the k-th READ of fifo ``f`` may not complete before
  ``t(write_k) + rd_lat(f)`` where ``rd_lat`` is 1 for shift-register FIFOs
  and 2 for BRAM-backed FIFOs (the Vitis extra read-latency cycle — this is
  what makes *shrinking* a FIFO below the SRL threshold occasionally
  *reduce* latency, the paper's footnote 2);
* the j-th WRITE (0-indexed) to fifo ``f`` of depth ``d`` may not complete
  before ``t(read_{j-d}) + 1`` (a slot frees one cycle after its read);
* task end = last op completion + trailing delay; design latency = max.

Deadlock is reported when unfinished tasks exist but none can progress.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from portbench.inputs.design import DELAY, Design, READ, TaskCtx
from portbench.reference.bram import fifo_read_latency


@dataclasses.dataclass
class SimResult:
    latency: int                 # total cycles (valid iff not deadlocked)
    deadlocked: bool
    blocked_tasks: List[str]     # names of tasks stuck at deadlock
    results: Dict[str, Any]      # functional outputs (ctx.result)
    #: per blocked task: (task_name, op_kind READ/WRITE, fifo_index) of the
    #: FIFO op it is stuck on — the raw material for wait-for-graph
    #: extraction (:mod:`repro_torch.core.deadlock`)
    blocked_ops: List[Tuple[str, int, int]] = \
        dataclasses.field(default_factory=list)

    def ok(self) -> bool:
        return not self.deadlocked


class _TaskState:
    __slots__ = ("task", "gen", "done", "time", "pending_delay", "next_op",
                 "send_value")

    def __init__(self, task, gen):
        self.task = task
        self.gen = gen
        self.done = False
        self.time = 0            # completion time of the last FIFO op
        self.pending_delay = 0   # accumulated DELAY cycles since last op
        self.next_op = None      # the FIFO op we are blocked on (or None)
        self.send_value: Any = None


def simulate(design: Design, depths: Sequence[int],
             widths: Optional[Sequence[int]] = None) -> SimResult:
    """Run the discrete-event simulation with the given FIFO depths."""
    depths = [int(d) for d in depths]
    if len(depths) != design.n_fifos:
        raise ValueError("depths length mismatch")
    if any(d < 1 for d in depths):
        raise ValueError("FIFO depths must be >= 1")
    if widths is None:
        widths = design.widths()
    rd_lat = [fifo_read_latency(d, w) for d, w in zip(depths, widths)]

    results: Dict[str, Any] = {}
    ctx = TaskCtx(design, design.args, results)

    # Per-fifo completed op timelines and live value queues.
    write_times: List[List[int]] = [[] for _ in range(design.n_fifos)]
    read_times: List[List[int]] = [[] for _ in range(design.n_fifos)]
    values: List[deque] = [deque() for _ in range(design.n_fifos)]

    states: List[_TaskState] = []
    for task in design.tasks:
        st = _TaskState(task, task.program(ctx))
        states.append(st)
        _advance_to_next_fifo_op(st)

    end_times: Dict[int, int] = {}

    def op_ready(st: _TaskState) -> bool:
        op = st.next_op
        if op.kind == READ:
            return len(write_times[op.fifo]) > len(read_times[op.fifo])
        j = len(write_times[op.fifo])          # rank of this write
        d = depths[op.fifo]
        return j < d or len(read_times[op.fifo]) > j - d

    # Kahn-style worklist: repeatedly execute any task whose next FIFO op has
    # all dependencies resolved.  Completion times only ever reference ops
    # already executed, so any execution order yields the same times.
    progress = True
    while progress:
        progress = False
        for st in states:
            while not st.done and st.next_op is not None and op_ready(st):
                op = st.next_op
                ready = st.time + st.pending_delay
                if op.kind == READ:
                    k = len(read_times[op.fifo])
                    t = max(ready, write_times[op.fifo][k] + rd_lat[op.fifo])
                    read_times[op.fifo].append(t)
                    st.send_value = values[op.fifo].popleft()
                else:  # WRITE
                    j = len(write_times[op.fifo])
                    d = depths[op.fifo]
                    t = ready
                    if j >= d:
                        t = max(t, read_times[op.fifo][j - d] + 1)
                    write_times[op.fifo].append(t)
                    values[op.fifo].append(op.value)
                st.time = t
                st.pending_delay = 0
                _advance_to_next_fifo_op(st)
                progress = True
            if st.done and st.task.index not in end_times:
                end_times[st.task.index] = st.time + st.pending_delay

    blocked = [st.task.name for st in states if not st.done]
    if blocked:
        blocked_ops = [(st.task.name, int(st.next_op.kind), int(st.next_op.fifo))
                       for st in states
                       if not st.done and st.next_op is not None]
        return SimResult(latency=-1, deadlocked=True, blocked_tasks=blocked,
                         results=results, blocked_ops=blocked_ops)
    latency = max(end_times.values()) if end_times else 0
    return SimResult(latency=int(latency), deadlocked=False,
                     blocked_tasks=[], results=results)


def _advance_to_next_fifo_op(st: _TaskState) -> None:
    """Drive the generator until it yields a FIFO op (or finishes),
    folding DELAY ops into ``pending_delay``."""
    while True:
        try:
            op = st.gen.send(st.send_value)
        except StopIteration:
            st.done = True
            st.next_op = None
            return
        st.send_value = None
        if op.kind == DELAY:
            st.pending_delay += op.cycles
        else:
            st.next_op = op
            return


def batch_simulate(design: Design, depth_matrix: np.ndarray) -> np.ndarray:
    """Evaluate many configs with the DES.  Returns (lat, deadlock) arrays.

    Intentionally naive (one full simulation per config): this is the
    "co-simulation search" cost model for Table-III-style benchmarks.
    """
    n = depth_matrix.shape[0]
    lat = np.zeros(n, dtype=np.int64)
    dead = np.zeros(n, dtype=bool)
    for i in range(n):
        r = simulate(design, depth_matrix[i])
        lat[i] = r.latency
        dead[i] = r.deadlocked
    return lat, dead
