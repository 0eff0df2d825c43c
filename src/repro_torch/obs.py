"""Host spans inside the program, recorded only while someone looks.

    from repro_torch import obs

    with obs.span("evaluate", rows=c) as s:
        ...
        s.set(unique=u)

records ``(name, start_ns, end_ns, parent, attrs)`` while a
``torch.profiler`` profile runs, or between :func:`enable` and
:func:`disable`.  Otherwise :func:`span` returns one shared no-op context
that is false and whose ``set`` does nothing, so work that only feeds an
attribute goes under ``if s:``.

* Times are ``time.time_ns()``, the clock ``torch.profiler`` stamps its
  events with, so a device event of a traced window can be placed inside
  the span that launched it.
* ``parent`` is the index (in :func:`records`) of the span that was open
  on the same thread when this one began, None at the top.  Each thread
  keeps its own stack, so the spans of concurrent threads never nest in
  one another.
* ``attrs`` are integers, summed per name by :func:`summary`.

This module imports no torch: it reads the profiler's own flag,
``torch.autograd.profiler._is_profiler_enabled``, once torch has loaded
that module, so the numpy-only worker processes import it freely.
Records stay in memory, at most :data:`CAP` of them; the rest are counted
by :func:`dropped`.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

#: records kept at most; later spans are dropped and counted
CAP = 2_000_000

_records: List[list] = []      # [name, start_ns, end_ns, parent rec, attrs]
_lock = threading.Lock()
_local = threading.local()
_on = False
_dropped = 0
_prof = None                   # torch.autograd.profiler, once loaded


class _Off:
    """The span handed out while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("_rec", "_stack")

    def __init__(self, name: str, attrs: Dict[str, int]):
        self._rec = [name, 0, None, None, attrs]
        self._stack = None

    def __enter__(self):
        global _dropped
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        rec = self._rec
        rec[3] = stack[-1] if stack else None
        with _lock:
            if len(_records) >= CAP:
                _dropped += 1
                return _OFF
            _records.append(rec)
            rec[1] = time.time_ns()
        stack.append(rec)
        self._stack = stack
        return self

    def __exit__(self, *exc):
        if self._stack is not None:
            self._rec[2] = time.time_ns()
            self._stack.pop()
        return False

    def set(self, **attrs) -> None:
        self._rec[4].update(attrs)


def span(name: str, **attrs):
    """A context that records one span named ``name`` with integer
    ``attrs`` (the no-op context while nothing records)."""
    global _prof
    if not _on:
        if _prof is None:
            _prof = sys.modules.get("torch.autograd.profiler")
        if _prof is None or not getattr(_prof, "_is_profiler_enabled",
                                        False):
            return _OFF
    return _Span(name, attrs)


def enable() -> None:
    """Record from now on, with or without a profiler."""
    global _on
    _on = True


def disable() -> None:
    """Record only while a profiler runs, as before :func:`enable`."""
    global _on
    _on = False


def clear() -> None:
    """Forget every record and the count of drops."""
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0


def dropped() -> int:
    """Spans not recorded because :data:`CAP` records were held."""
    return _dropped


def records() -> List[Tuple[str, int, Optional[int], Optional[int],
                            Dict[str, int]]]:
    """Every span in start order: ``(name, start_ns, end_ns, parent,
    attrs)``; ``end_ns`` is None while the span is open."""
    with _lock:
        recs = list(_records)
    index = {id(r): i for i, r in enumerate(recs)}
    return [(n, s, e, None if p is None else index.get(id(p)), dict(a))
            for n, s, e, p, a in recs]


def summary() -> Dict[str, dict]:
    """Per span name, over the closed spans: ``count``, ``total_s``,
    ``self_s`` (the durations less the parts their child spans cover) and
    ``attrs``, each attribute summed."""
    recs = records()
    child_ns = [0] * len(recs)
    for _, s, e, p, _ in recs:
        if e is not None and p is not None:
            child_ns[p] += e - s
    acc: Dict[str, list] = {}
    for i, (name, s, e, _, attrs) in enumerate(recs):
        if e is None:
            continue
        a = acc.setdefault(name, [0, 0, 0, {}])
        a[0] += 1
        a[1] += e - s
        a[2] += e - s - child_ns[i]
        for k, v in attrs.items():
            a[3][k] = a[3].get(k, 0) + v
    return {name: {"count": n, "total_s": t / 1e9, "self_s": own / 1e9,
                   "attrs": at}
            for name, (n, t, own, at) in acc.items()}
