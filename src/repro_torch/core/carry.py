"""Carry the traced state of a design across from plain arrays.

The system has no weights: its state is the packed event graph.  These
helpers build this package's :class:`SimGraph` and :class:`CondensedGraph`
from a dict of numpy arrays (for instance the fields of a graph built by
the reference package), so both packages can be fed the very same graph:

    fields = graph_fields(other_graph)           # any object with the fields
    g = simgraph_from_arrays(fields)
    cg = condensed_from_arrays(graph_fields(other_condensed, CondensedGraph),
                               raw=g)

``EvalConfig.from_dict`` carries a config dict across the same way.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.condense import CondensedGraph
from repro_torch.core.simgraph import SimGraph

__all__ = ["condensed_from_arrays", "graph_fields", "simgraph_from_arrays"]

#: fields that are not arrays (copied as they are)
_SCALARS = {"unbounded_latency": int, "_bound": int, "tag": str}
#: fields that are objects, not state (set by the caller)
_OBJECTS = ("design", "raw")


def graph_fields(obj, cls=SimGraph) -> dict:
    """The state fields of ``cls`` read off ``obj`` (any object carrying
    them, e.g. a graph of the reference package), as numpy arrays."""
    out = {}
    for f in dataclasses.fields(cls):
        if f.name in _OBJECTS:
            continue
        v = getattr(obj, f.name)
        out[f.name] = (_SCALARS[f.name](v) if f.name in _SCALARS
                       else np.array(v, copy=True))
    return out


def _build(cls, fields: dict, **objects):
    names = [f.name for f in dataclasses.fields(cls)]
    missing = [n for n in names if n not in _OBJECTS and n not in fields]
    if missing:
        raise ValueError(f"{cls.__name__}: missing field(s) {missing}")
    unknown = set(fields) - set(names)
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown field(s) "
                         f"{sorted(unknown)}")
    kw = {n: (_SCALARS[n](fields[n]) if n in _SCALARS
              else np.array(fields[n], copy=True))
          for n in names if n not in _OBJECTS}
    return cls(**kw, **objects)


def simgraph_from_arrays(fields: dict, design=None) -> SimGraph:
    """This package's :class:`SimGraph` from its array fields
    (``simgraph.py``'s table).  ``design`` (optional) is only needed for
    :meth:`SimGraph.groups` (the grouped optimizers)."""
    return _build(SimGraph, fields, design=design)


def condensed_from_arrays(fields: dict,
                          raw: Optional[SimGraph] = None) -> CondensedGraph:
    """This package's :class:`CondensedGraph` from its array fields
    (``condense.py``'s table, including ``cond_of``, ``off_of``,
    ``data_off``, ``read_off_flat``, the ``vr_*``/``vw_*`` certificate
    tables and ``floor``).  ``raw`` is the carried raw graph, or
    ``fields["raw"]`` as a dict of its fields."""
    fields = dict(fields)
    raw_fields = fields.pop("raw", None)
    if raw is None:
        if raw_fields is None:
            raise ValueError("condensed_from_arrays needs the raw graph")
        raw = simgraph_from_arrays(raw_fields)
    return _build(CondensedGraph, fields, raw=raw)
