"""Software-execution trace collection (the LightningSim front-end).

HLS ``#pragma HLS dataflow`` regions are required to be *sequentially
executable*: running the tasks to completion one after another in
declaration order, with unbounded FIFOs, is a valid execution that fixes
every data value — and therefore fixes all data-dependent control flow.
This is exactly how LightningSim collects its trace from native software
execution of the C source.  The collected trace pins down, per task, the
linear sequence of FIFO operations and the compute-cycle gaps between
them; FIFO depths only ever change *stall* timing, never the op sequence.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, List

import numpy as np

from repro_torch.core.design import DELAY, Design, READ, TaskCtx, WRITE


@dataclasses.dataclass
class TaskTrace:
    """Linear FIFO-op trace of one task.

    ``kinds[i]``/``fifos[i]`` identify the i-th FIFO op; ``deltas[i]`` is the
    number of compute cycles between the completion of op ``i-1`` (or task
    start) and the earliest issue of op ``i``.  ``end_delay`` is trailing
    compute after the last FIFO op.
    """

    task: int
    kinds: np.ndarray      # int8  (n_ops,)   READ/WRITE
    fifos: np.ndarray      # int32 (n_ops,)
    deltas: np.ndarray     # int64 (n_ops,)
    end_delay: int

    @property
    def n_ops(self) -> int:
        return int(self.kinds.shape[0])


@dataclasses.dataclass
class Trace:
    """Full design trace + functional results of the software execution."""

    design: Design
    tasks: List[TaskTrace]
    results: Dict[str, Any]
    write_counts: np.ndarray   # int64 (n_fifos,) total writes observed
    read_counts: np.ndarray    # int64 (n_fifos,)

    @property
    def n_events(self) -> int:
        return int(sum(t.n_ops for t in self.tasks))

    def default_upper_bounds(self) -> np.ndarray:
        """Per-FIFO search upper bound u_i.

        The paper: "the sizes defined in the design, the total number of
        writes observed during kernel execution, or user-specified".  We use
        the declared depth when present, else the observed write count
        (min depth that can buffer everything => Baseline-Max), floor 2.
        """
        u = np.empty(self.design.n_fifos, dtype=np.int64)
        for f in self.design.fifos:
            if f.depth is not None:
                u[f.index] = f.depth
            else:
                u[f.index] = self.write_counts[f.index]
        return np.maximum(u, 2)


class TraceDivergenceError(RuntimeError):
    """A task read from a FIFO that is empty under sequential semantics —
    the design is not sequentially executable (illegal HLS dataflow)."""


def collect_trace(design: Design) -> Trace:
    """Run the design under sequential semantics and collect its trace."""
    queues: List[deque] = [deque() for _ in range(design.n_fifos)]
    results: Dict[str, Any] = {}
    ctx = TaskCtx(design, design.args, results)

    task_traces: List[TaskTrace] = []
    write_counts = np.zeros(design.n_fifos, dtype=np.int64)
    read_counts = np.zeros(design.n_fifos, dtype=np.int64)

    for task in design.tasks:
        kinds: List[int] = []
        fifos: List[int] = []
        deltas: List[int] = []
        pending_delay = 0

        gen = task.program(ctx)
        send_value: Any = None
        while True:
            try:
                op = gen.send(send_value)
            except StopIteration:
                break
            send_value = None
            if op.kind == DELAY:
                pending_delay += op.cycles
            elif op.kind == WRITE:
                queues[op.fifo].append(op.value)
                write_counts[op.fifo] += 1
                kinds.append(WRITE)
                fifos.append(op.fifo)
                deltas.append(pending_delay)
                pending_delay = 0
            elif op.kind == READ:
                if not queues[op.fifo]:
                    raise TraceDivergenceError(
                        f"task {task.name!r} read empty fifo "
                        f"{design.fifos[op.fifo].name!r} under sequential "
                        f"semantics")
                send_value = queues[op.fifo].popleft()
                read_counts[op.fifo] += 1
                kinds.append(READ)
                fifos.append(op.fifo)
                deltas.append(pending_delay)
                pending_delay = 0
            else:  # pragma: no cover - defensive
                raise ValueError(f"unknown op kind {op.kind}")

        task_traces.append(TaskTrace(
            task=task.index,
            kinds=np.asarray(kinds, dtype=np.int8),
            fifos=np.asarray(fifos, dtype=np.int32),
            deltas=np.asarray(deltas, dtype=np.int64),
            end_delay=pending_delay,
        ))

    return Trace(design=design, tasks=task_traces, results=results,
                 write_counts=write_counts, read_counts=read_counts)
