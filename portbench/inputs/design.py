# A frozen copy of src/repro_torch/core/design.py, imports renamed: part of the
# benchmark's yardstick, which later changes to the program do not move.
"""Dataflow design IR: the HLS-like object FIFOAdvisor optimizes.

A :class:`Design` is a set of *tasks* (HLS dataflow processes) communicating
through named FIFO *streams*.  Task bodies are plain Python generator
functions so that data-dependent control flow (DDCF) — loop bounds that
depend on values read from FIFOs or on kernel arguments — is expressed
naturally and resolved only at trace-collection time, exactly like
LightningSim executing the C source natively.

Task programs yield :class:`Op` requests and receive read values back::

    @design.task("consumer")
    def consumer(ctx):
        n = ctx.arg("n")
        total = 0
        for _ in range(n):
            v = yield ctx.read("x")
            total += v
            yield ctx.delay(1)
        ctx.result("sum", total)

The same generator is driven by two independent engines:

* :mod:`repro_torch.core.tracer` — HLS *sequential semantics* (tasks run to
  completion in declaration order against unbounded FIFOs) to collect the
  event trace, and
* :mod:`repro_torch.core.oracle` — a cycle-accurate discrete-event
  simulation against *bounded* FIFOs (the stand-in for RTL co-simulation).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Generator, List, Optional

# Op kinds (shared integer encoding across tracer / oracle / simulators).
READ = 0
WRITE = 1
DELAY = 2


@dataclasses.dataclass(frozen=True)
class Op:
    """A single request yielded by a task program."""

    kind: int
    fifo: int = -1          # fifo index for READ/WRITE
    cycles: int = 0         # cycle count for DELAY
    value: Any = None       # payload for WRITE


@dataclasses.dataclass
class Fifo:
    """A FIFO stream declaration.

    ``width`` is the element bit-width (drives the BRAM model).  ``group``
    names the HLS array this stream belongs to (``hls::stream<T> v[16]``
    style); grouped optimizers assign one depth per group.  ``depth`` is the
    designer-declared depth, used as one possible per-FIFO upper bound.
    """

    name: str
    index: int
    width: int = 32
    group: Optional[str] = None
    depth: Optional[int] = None


class TaskCtx:
    """Handle passed to task programs for building ops and reading args."""

    def __init__(self, design: "Design", args: Dict[str, Any],
                 results: Dict[str, Any]):
        self._design = design
        self._args = args
        self._results = results

    def arg(self, name: str) -> Any:
        return self._args[name]

    def read(self, fifo: str) -> Op:
        return Op(READ, fifo=self._design.fifo_index(fifo))

    def write(self, fifo: str, value: Any = 0) -> Op:
        return Op(WRITE, fifo=self._design.fifo_index(fifo), value=value)

    def delay(self, cycles: int) -> Op:
        if cycles < 0:
            raise ValueError("delay must be non-negative")
        return Op(DELAY, cycles=int(cycles))

    def result(self, key: str, value: Any) -> None:
        """Record a functional output (used to check design correctness)."""
        self._results[key] = value


TaskProgram = Callable[[TaskCtx], Generator[Op, Any, None]]


@dataclasses.dataclass
class Task:
    """A dataflow process.

    ``data_dependent`` marks tasks whose FIFO access *pattern* (op counts
    or interleaving) depends on values read from FIFOs or on kernel
    arguments — the paper's DDCF processes.  The static channel-bounds
    pass (:mod:`repro_torch.core.bounds`) treats every FIFO touched by
    such a task as instance-specific: its trace-derived bounds still hold for
    the traced argument values, but are not closed-form over all inputs.
    """

    name: str
    index: int
    program: TaskProgram
    data_dependent: bool = False


class Design:
    """A dataflow design: FIFO declarations + task programs + kernel args."""

    def __init__(self, name: str, args: Optional[Dict[str, Any]] = None):
        self.name = name
        self.args: Dict[str, Any] = dict(args or {})
        self.fifos: List[Fifo] = []
        self.tasks: List[Task] = []
        self._fifo_by_name: Dict[str, int] = {}

    # ---------------------------------------------------------------- fifos
    def fifo(self, name: str, width: int = 32, group: Optional[str] = None,
             depth: Optional[int] = None) -> str:
        if name in self._fifo_by_name:
            raise ValueError(f"duplicate fifo {name!r}")
        f = Fifo(name=name, index=len(self.fifos), width=width, group=group,
                 depth=depth)
        self.fifos.append(f)
        self._fifo_by_name[name] = f.index
        return name

    def fifo_array(self, name: str, n: int, width: int = 32,
                   depth: Optional[int] = None) -> List[str]:
        """Declare ``hls::stream<T> name[n]`` — one group of n streams."""
        return [self.fifo(f"{name}[{i}]", width=width, group=name, depth=depth)
                for i in range(n)]

    def fifo_index(self, name: str) -> int:
        return self._fifo_by_name[name]

    # ---------------------------------------------------------------- tasks
    def task(self, name: str, data_dependent: bool = False
             ) -> Callable[[TaskProgram], TaskProgram]:
        def deco(fn: TaskProgram) -> TaskProgram:
            self.tasks.append(Task(name=name, index=len(self.tasks),
                                   program=fn,
                                   data_dependent=data_dependent))
            return fn
        return deco

    def add_task(self, name: str, fn: TaskProgram,
                 data_dependent: bool = False) -> None:
        self.tasks.append(Task(name=name, index=len(self.tasks), program=fn,
                               data_dependent=data_dependent))

    # ------------------------------------------------------------- metadata
    @property
    def n_fifos(self) -> int:
        return len(self.fifos)

    @property
    def n_tasks(self) -> int:
        return len(self.tasks)

    def groups(self) -> Dict[str, List[int]]:
        """Map group name -> fifo indices.  Ungrouped fifos form singleton
        groups keyed by their own name (the paper's grouped optimizers then
        degrade gracefully on designs without stream arrays)."""
        out: Dict[str, List[int]] = {}
        for f in self.fifos:
            key = f.group if f.group is not None else f.name
            out.setdefault(key, []).append(f.index)
        return out

    def widths(self) -> List[int]:
        return [f.width for f in self.fifos]

    def declared_depths(self) -> List[Optional[int]]:
        return [f.depth for f in self.fifos]

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Design({self.name!r}, fifos={self.n_fifos}, "
                f"tasks={self.n_tasks})")
