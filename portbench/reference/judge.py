"""The plain reference's verdicts on what the program produced.

Everything here is plain Python and NumPy over the frozen designs of
:mod:`portbench.inputs`: the discrete-event oracle
(:mod:`portbench.reference.oracle`), the BRAM arithmetic
(:mod:`portbench.reference.bram`) and the Pareto arithmetic
(:mod:`portbench.reference.pareto`).  It imports nothing of the program.

:class:`Judge` gathers what it finds in :attr:`Judge.values`:

``lat_gap``     largest |latency - oracle latency| of a checked row
``bram_gap``    largest |BRAM - reference BRAM| of a checked row
``dead_flips``  checked rows whose deadlock verdict differs
``rows_wrong``  checked rows with any of the three wrong
``front_diff``  results whose frontier differs from the one the
                reference draws from the same history
``hv_gap``      largest relative gap of a result's hypervolume to the
                reference's, over the same frontier and a Baseline-Max
                the oracle evaluated
``hv_bad``      results whose gap is over :data:`HV_RTOL`
``missing``     answers that never came

and the check compares two numbers (:meth:`Judge.numbers`): ``lat_gap``
and ``wrong``, the answers found wrong (``rows_wrong + front_diff +
hv_bad + missing``).

:func:`simulate_control` is the check's control: the oracle with every
event time rounded to bfloat16, the precision below the float32 the
configurations state.
"""

from __future__ import annotations

import struct
from collections import deque
from typing import Dict, List, Sequence

import numpy as np

from portbench.inputs.design import DELAY, READ, TaskCtx
from portbench.reference.bram import design_bram_np, fifo_read_latency
from portbench.reference.oracle import simulate
from portbench.reference.pareto import hypervolume_2d, pareto_front

#: what the judge records, in the order it is printed
DETAILS = ("lat_gap", "bram_gap", "dead_flips", "rows_wrong", "front_diff",
           "hv_gap", "hv_bad", "missing")
#: the counts that make up ``wrong``
WRONG = ("rows_wrong", "front_diff", "hv_bad", "missing")
#: a hypervolume is the reference's when within this relative gap: both
#: sum the same float64 areas, perhaps in another order
HV_RTOL = 1e-9


def bf16(x: float) -> float:
    """``x`` rounded to the nearest bfloat16 (ties to even)."""
    b = struct.unpack("<I", struct.pack("<f", float(x)))[0]
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return struct.unpack("<f", struct.pack("<I", b))[0]


def _advance(st) -> None:
    while True:
        try:
            op = st["gen"].send(st["send"])
        except StopIteration:
            st["done"], st["op"] = True, None
            return
        st["send"] = None
        if op.kind == DELAY:
            st["pending"] += op.cycles
        else:
            st["op"] = op
            return


def simulate_control(design, depths: Sequence[int]):
    """(latency, deadlocked) of the oracle's schedule with every event
    time rounded to bfloat16 as it is computed."""
    depths = [int(d) for d in depths]
    widths = design.widths()
    rd_lat = [fifo_read_latency(d, w) for d, w in zip(depths, widths)]
    ctx = TaskCtx(design, design.args, {})
    wt: List[List[float]] = [[] for _ in range(design.n_fifos)]
    rt: List[List[float]] = [[] for _ in range(design.n_fifos)]
    vals: List[deque] = [deque() for _ in range(design.n_fifos)]
    states = []
    for task in design.tasks:
        st = {"gen": task.program(ctx), "done": False, "time": 0.0,
              "pending": 0, "op": None, "send": None}
        _advance(st)
        states.append(st)
    progress = True
    while progress:
        progress = False
        for st in states:
            while not st["done"] and st["op"] is not None:
                op = st["op"]
                f = op.fifo
                if op.kind == READ:
                    if len(wt[f]) <= len(rt[f]):
                        break
                    t = max(st["time"] + st["pending"],
                            wt[f][len(rt[f])] + rd_lat[f])
                    rt[f].append(bf16(t))
                    st["send"] = vals[f].popleft()
                else:
                    j, d = len(wt[f]), depths[f]
                    if j >= d and len(rt[f]) <= j - d:
                        break
                    t = st["time"] + st["pending"]
                    if j >= d:
                        t = max(t, rt[f][j - d] + 1)
                    wt[f].append(bf16(t))
                    vals[f].append(op.value)
                st["time"] = bf16(t)
                st["pending"] = 0
                _advance(st)
                progress = True
    if any(not st["done"] for st in states):
        return -1.0, True
    ends = [bf16(st["time"] + st["pending"]) for st in states]
    return (max(ends) if ends else 0.0), False


def reference_rows(design, rows: np.ndarray, control: bool = False):
    """(latency, BRAM, deadlocked) of each row by the oracle (or by the
    control) and the reference BRAM arithmetic."""
    rows = np.asarray(rows, dtype=np.int64).reshape(-1, design.n_fifos)
    lat = np.zeros(rows.shape[0], dtype=np.float64)
    dead = np.zeros(rows.shape[0], dtype=bool)
    for i, r in enumerate(rows):
        if control:
            lat[i], dead[i] = simulate_control(design, r)
        else:
            res = simulate(design, r)
            lat[i], dead[i] = res.latency, res.deadlocked
    bram = design_bram_np(rows, np.asarray(design.widths(), dtype=np.int64))
    return lat, bram, dead


def observed_writes(design) -> np.ndarray:
    """Writes to each FIFO when the tasks run to completion in declaration
    order against unbounded FIFOs (the design's sequential semantics)."""
    ctx = TaskCtx(design, design.args, {})
    queues = [deque() for _ in range(design.n_fifos)]
    writes = np.zeros(design.n_fifos, dtype=np.int64)
    for task in design.tasks:
        gen = task.program(ctx)
        send = None
        while True:
            try:
                op = gen.send(send)
            except StopIteration:
                break
            send = None
            if op.kind == READ:
                send = queues[op.fifo].popleft()
            elif op.kind != DELAY:
                queues[op.fifo].append(op.value)
                writes[op.fifo] += 1
    return writes


def baseline_max_depths(design) -> np.ndarray:
    """Baseline-Max: each FIFO's declared depth, else its observed write
    count, at least 2."""
    writes = observed_writes(design)
    u = np.array([f.depth if f.depth is not None else writes[f.index]
                  for f in design.fifos], dtype=np.int64)
    return np.maximum(u, 2)


def frontier_of(lat: np.ndarray, bram: np.ndarray,
                dead: np.ndarray) -> np.ndarray:
    """The Pareto-optimal (latency, BRAM) points of the feasible rows,
    deduplicated, sorted."""
    ok = ~np.asarray(dead, dtype=bool)
    pts = np.stack([np.asarray(lat)[ok], np.asarray(bram)[ok]],
                   axis=1).astype(np.float64)
    if pts.shape[0] == 0:
        return np.zeros((0, 2))
    return np.unique(pts[pareto_front(pts)], axis=0)


def hv_reference(latency: float, bram: float):
    """The hypervolume's reference point from Baseline-Max's objectives."""
    return (latency * 2.0 + 1.0, bram * 2.0 + 2.0)


class Judge:
    """Gathers the numbers the check compares (module docstring).

    ``control=True`` puts :func:`simulate_control` in the program's place
    for every row shown to :meth:`rows`: the answers then come from the
    control and are judged against the oracle.
    """

    def __init__(self, control: bool = False):
        self.control = control
        self.values: Dict[str, float] = dict.fromkeys(DETAILS, 0)
        self.values.update(lat_gap=0.0, bram_gap=0.0, hv_gap=0.0)
        self.n_rows = 0
        self.n_results = 0

    def _worst(self, name: str, value: float) -> None:
        self.values[name] = max(self.values[name], value)

    def rows(self, design, rows: np.ndarray, lat, bram, dead) -> None:
        """Judge the program's ``(lat, bram, dead)`` of ``rows``."""
        rows = np.asarray(rows, dtype=np.int64).reshape(-1, design.n_fifos)
        if rows.shape[0] == 0:
            return
        if self.control:
            lat, bram, dead = reference_rows(design, rows, control=True)
        self.compare(lat, bram, dead, *reference_rows(design, rows))

    def compare(self, lat, bram, dead, r_lat, r_bram, r_dead) -> None:
        """Judge answers against reference answers already computed."""
        lat = np.asarray(lat, dtype=np.float64)
        bram = np.asarray(bram, dtype=np.float64)
        dead = np.asarray(dead, dtype=bool)
        lat = np.where(dead, -1.0, lat)
        r_lat = np.where(r_dead, -1.0, r_lat)
        self._worst("lat_gap", float(np.max(np.abs(lat - r_lat))))
        self._worst("bram_gap", float(np.max(np.abs(bram - r_bram))))
        self.values["dead_flips"] += int(np.sum(dead != r_dead))
        self.values["rows_wrong"] += int(np.sum(
            (lat != r_lat) | (bram != r_bram) | (dead != r_dead)))
        self.n_rows += lat.shape[0]

    def result(self, lat, bram, dead, frontier, hypervolume: float,
               base_latency: float, base_bram: float) -> None:
        """Judge one result's frontier and hypervolume against the ones
        the reference draws from the same history (``lat, bram, dead``)
        and a Baseline-Max of ``(base_latency, base_bram)``."""
        ref = frontier_of(lat, bram, dead)
        got = np.asarray(frontier, dtype=np.float64).reshape(-1, 2)
        got = np.unique(got, axis=0) if got.size else np.zeros((0, 2))
        if got.shape != ref.shape or not np.array_equal(got, ref):
            self.values["front_diff"] += 1
        ref_hv = hypervolume_2d(ref, hv_reference(base_latency, base_bram))
        gap = abs(float(hypervolume) - ref_hv) / max(abs(ref_hv), 1e-300)
        self._worst("hv_gap", gap)
        self.values["hv_bad"] += int(gap > HV_RTOL)
        self.n_results += 1

    def missing(self, n: int) -> None:
        self.values["missing"] += int(n)

    def numbers(self) -> Dict[str, float]:
        """What the check compares with its limits."""
        return {"lat_gap": self.values["lat_gap"],
                "wrong": sum(self.values[k] for k in WRONG)}
