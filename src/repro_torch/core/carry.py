"""Carry the traced state of a design across from plain arrays.

The system has no weights: its state is the packed event graph.  These
helpers build this package's :class:`SimGraph` and :class:`CondensedGraph`
from a dict of numpy arrays (for instance the fields of a graph built by
the reference package), so both packages can be fed the very same graph:

    fields = graph_fields(other_graph)           # any object with the fields
    g = simgraph_from_arrays(fields)
    cg = condensed_from_arrays(graph_fields(other_condensed, CondensedGraph),
                               raw=g)

``EvalConfig.from_dict`` carries a config dict across the same way, and
:func:`lm_params_from_arrays` the parameters of the LLM substrate
(``repro_torch.models``), whose random initialisation differs from the
reference's ``jax.random`` streams; :func:`train_state_from_arrays`
carries a whole training state (parameters and AdamW state) the same
way.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core.condense import CondensedGraph
from repro_torch.core.simgraph import SimGraph

__all__ = ["condensed_from_arrays", "graph_fields", "lm_params_from_arrays",
           "simgraph_from_arrays", "train_state_from_arrays"]

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


def lm_params_from_arrays(cfg, tree, device, dtype=None) -> dict:
    """This package's LLM parameters from the reference's parameter tree
    given as numpy arrays (nested dicts, with ``layers`` and
    ``dense_layers`` stacked ``(L, ...)``): every key and shape is checked
    against :func:`repro_torch.models.transformer.model_specs` and any
    mismatch raises ``ValueError``.  Tensors go to ``device`` in ``dtype``
    (default: each spec's, float32)."""
    return _carry_lm(cfg, tree, device, dtype, "params")


def _carry_lm(cfg, tree, device, dtype, root: str) -> dict:
    import torch

    from repro_torch.models.params import is_spec
    from repro_torch.models.transformer import model_specs

    def carry(spec, arr, path: str):
        if is_spec(spec):
            a = np.asarray(arr)
            if a.shape != tuple(spec.shape):
                raise ValueError(f"{cfg.name}: {path} has shape {a.shape}, "
                                 f"expected {tuple(spec.shape)}")
            return torch.tensor(a, dtype=dtype or spec.dtype,
                                device=device)
        if not isinstance(arr, dict):
            raise ValueError(f"{cfg.name}: {path} should be a dict of "
                             f"{sorted(spec)}, got {type(arr).__name__}")
        if set(arr) != set(spec):
            raise ValueError(
                f"{cfg.name}: {path} has keys {sorted(arr)}, expected "
                f"{sorted(spec)}")
        return {k: carry(spec[k], arr[k], f"{path}/{k}") for k in spec}

    return carry(model_specs(cfg), tree, root)


def train_state_from_arrays(cfg, params_tree, opt_tree, device):
    """``(params, opt_state)`` of this package's train step from the
    reference's ``(params, {"m", "v", "step"})`` given as numpy arrays:
    parameters as :func:`lm_params_from_arrays` carries them, both
    moments float32 with the same key and shape checks, and the step a
    scalar int32 tensor.  Any mismatch raises ``ValueError``."""
    import torch

    if not isinstance(opt_tree, dict) or set(opt_tree) != {"m", "v",
                                                           "step"}:
        keys = sorted(opt_tree) if isinstance(opt_tree, dict) else opt_tree
        raise ValueError(f"{cfg.name}: the optimizer state should be a "
                         f"dict of ['m', 'step', 'v'], got {keys!r}")
    step = np.asarray(opt_tree["step"])
    if step.shape != ():
        raise ValueError(f"{cfg.name}: opt/step has shape {step.shape}, "
                         f"expected ()")
    params = lm_params_from_arrays(cfg, params_tree, device)
    opt = {"m": _carry_lm(cfg, opt_tree["m"], device, torch.float32,
                          "opt/m"),
           "v": _carry_lm(cfg, opt_tree["v"], device, torch.float32,
                          "opt/v"),
           "step": torch.tensor(step, dtype=torch.int32, device=device)}
    return params, opt
