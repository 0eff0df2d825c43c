"""What the benchmark records around the program, from its own files.

* :class:`Spans`: host spans around the calls into each layer, on the
  wall clock the profiler's trace uses (traced runs only).
* :class:`KernelLog`: every K1 and K2 launch's bytes, ``E_pad``,
  certificate slots and output, by wrapping the kernel wrappers where the
  program's evaluation closures look them up (traced runs only).
* :func:`profile_summary`: device busy time, the largest device
  operations and the idle gaps, named by the span that encloses them.

Nothing here changes what the program computes: each wrapper calls the
original and records what went in and out.  Untraced runs install no
wrapper, so the measured window runs the program as it stands.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional, Tuple

from portbench import roofline

#: the kernel wrappers the program's closures call, by the module
#: attribute they are looked up under, and the kernel each launches
KERNEL_WRAPPERS = {"fifo_eval": "k2", "fifo_eval_hetero": "k2",
                   "fifo_eval_condensed": "k1"}
#: each kernel's function name in the device trace
KERNEL_NAMES = {"k2": "fifo_eval_kernel", "k1": "condensed_kernel"}


class Patches:
    """Attribute replacements undone in reverse order."""

    def __init__(self):
        self._undo: List[Tuple[object, str, object]] = []

    def replace(self, owner, attr: str, make: Callable) -> None:
        orig = getattr(owner, attr)
        self._undo.append((owner, attr, orig))
        setattr(owner, attr, make(orig))

    def undo(self) -> None:
        while self._undo:
            owner, attr, orig = self._undo.pop()
            setattr(owner, attr, orig)


class Spans:
    """Named host spans ``(name, start_ns, end_ns)`` on ``time.time_ns``,
    the clock the profiler's events are stamped with."""

    def __init__(self):
        self.records: List[Tuple[str, int, int]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.records.append((name, t0, time.time_ns()))

    def around(self, patches: Patches, owner, attr: str, name: str) -> None:
        """Record a span named ``name`` around every call of
        ``owner.attr``."""
        spans = self

        def make(orig):
            def wrapped(*args, **kwargs):
                with spans.span(name):
                    return orig(*args, **kwargs)
            return wrapped
        patches.replace(owner, attr, make)

    def clear(self) -> None:
        self.records.clear()

    def innermost(self, points: List[int]) -> List[Optional[str]]:
        """The innermost span around each of the sorted ``points`` (None
        where no span is).  Spans nest, being calls of one thread, so one
        sweep with a stack of the open spans finds them all."""
        order = sorted(self.records, key=lambda r: (r[1], -r[2]))
        stack: List[Tuple[str, int, int]] = []
        out: List[Optional[str]] = []
        i = 0
        for t in points:
            while i < len(order) and order[i][1] <= t:
                while stack and stack[-1][2] <= order[i][1]:
                    stack.pop()
                stack.append(order[i])
                i += 1
            while stack and stack[-1][2] <= t:
                stack.pop()
            out.append(stack[-1][0] if stack else None)
        return out


class KernelLog:
    """Each K1/K2 launch: ``(kernel, bytes, E_pad, cert slots, out)``.

    The output tensor is kept, so that the iterations its rows ran are
    read once the window has closed, without a synchronise inside it.
    """

    def __init__(self):
        self.launches: List[Tuple[str, int, int, int, object]] = []

    def install(self, patches: Patches) -> None:
        from repro_torch.kernels.fifo_eval import ops
        for attr, kernel in KERNEL_WRAPPERS.items():
            patches.replace(ops, attr, self._wrap(kernel))

    def _wrap(self, kernel: str) -> Callable:
        log = self.launches

        def make(orig):
            def wrapped(*args, **kwargs):
                out, times = orig(*args, **kwargs)
                if out.shape[0]:
                    inputs = list(args) + [kwargs.get("table_of_row"),
                                           kwargs.get("bounds")]
                    n_bytes = roofline.tensor_bytes(
                        [a for a in inputs if hasattr(a, "element_size")]
                        + [out, times])
                    cert = args[10].numel() if kernel == "k1" else 0
                    log.append((kernel, n_bytes, int(args[6].shape[1]),
                                cert, out))
                return out, times
            return wrapped
        return make

    def clear(self) -> None:
        self.launches.clear()

    def bounds(self) -> Dict[str, Tuple[int, float]]:
        """Per kernel: (launches, summed bound seconds)."""
        out: Dict[str, Tuple[int, float]] = {}
        for kernel, n_bytes, e_pad, cert, o in self.launches:
            iters = float(o[:, roofline.ITERS_LANE].sum())
            t, _ = roofline.bound_s(n_bytes, iters, e_pad, cert)
            n, total = out.get(kernel, (0, 0.0))
            out[kernel] = (n + 1, total + t)
        return out


def start_profiler(device: str = "cuda"):
    """A started ``torch.profiler`` that records device activity only
    (host operations would slow the run); on the CPU, which has no device
    activity, the host's (so that the CPU tests drive the same path)."""
    from torch.profiler import ProfilerActivity, profile
    prof = profile(activities=[ProfilerActivity.CUDA if device == "cuda"
                               else ProfilerActivity.CPU])
    prof.start()
    return prof


def device_events(prof) -> List[Tuple[str, int, int]]:
    """``(name, start_ns, end_ns)`` of every device activity (kernels,
    copies, sets) in a stopped profiler, on ``time.time_ns``'s clock."""
    from torch.autograd import DeviceType
    res = prof.profiler.kineto_results
    out = []
    for e in res.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        if hasattr(e, "start_ns"):
            s, t = e.start_ns(), e.end_ns()
        else:
            s = e.start_us() * 1000
            t = s + e.duration_us() * 1000
        out.append((e.name(), int(s), int(t)))
    return out


def profile_summary(events: List[Tuple[str, int, int]], w0: int, w1: int,
                    spans: Optional[Spans] = None, top: int = 10) -> dict:
    """Busy seconds (the union of device activity inside ``[w0, w1)``),
    seconds by device operation, and idle seconds by the innermost span
    around each gap (``"outside spans"`` where none is)."""
    clipped = sorted((max(s, w0), min(e, w1), n) for n, s, e in events
                     if e > w0 and s < w1)
    by_op: Dict[str, float] = {}
    for s, e, n in clipped:
        by_op[n] = by_op.get(n, 0.0) + (e - s) / 1e9
    busy = 0
    gaps: List[Tuple[int, int]] = []
    cur_s, cur_e = None, w0
    for s, e, _ in clipped:
        if cur_s is None or s > cur_e:
            if cur_s is not None:
                busy += cur_e - cur_s
            if s > cur_e:
                gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_s is not None:
        busy += cur_e - cur_s
    if cur_e < w1:
        gaps.append((cur_e, w1))
    mids = [(s + e) // 2 for s, e in gaps]
    names = spans.innermost(mids) if spans is not None else [None] * len(mids)
    idle: Dict[str, float] = {}
    for (s, e), name in zip(gaps, names):
        name = name or "outside spans"
        idle[name] = idle.get(name, 0.0) + (e - s) / 1e9

    def largest(d):
        return [[k, v] for k, v in sorted(d.items(),
                                          key=lambda kv: -kv[1])[:top]]
    return {"busy_s": busy / 1e9, "window_s": (w1 - w0) / 1e9,
            "device_ops": largest(by_op), "idle_gaps": largest(idle),
            "by_op": by_op}


def kernel_device_s(by_op: Dict[str, float], kernel: str) -> float:
    """Device seconds of every trace entry of one kernel."""
    name = KERNEL_NAMES[kernel]
    return sum(v for k, v in by_op.items() if name in k)
