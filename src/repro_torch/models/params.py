"""Parameter metadata: one source of truth for shapes and initialisation.

Models build a tree (nested dicts) of :class:`ParamSpec`; the same tree
yields materialized parameters (:func:`materialize`) and, for tests, the
shapes that weights carried across from the reference must have
(:func:`repro_torch.core.carry.lm_params_from_arrays`).  Leaves are
visited in sorted-key order, as ``jax.tree`` does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    dtype: Any = torch.float32
    init: str = "normal"           # normal | zeros | ones
    scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(f"ParamSpec shape {self.shape} and logical "
                             f"axes {self.logical} differ in rank")


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(fn: Callable, tree):
    """``fn`` over every leaf of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    """The leaves of nested dicts in ``jax.tree.leaves`` order (keys
    sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map_specs(fn, tree):
    """``fn`` over every :class:`ParamSpec` of a spec tree (the
    reference's name for :func:`tree_map` on specs)."""
    return tree_map(fn, tree)


def materialize(tree, generator: torch.Generator, dtype=None, device=None):
    """Real parameter tensors from a ParamSpec tree.

    ``normal`` leaves draw ``randn * scale`` in float32 from
    ``generator`` (on the generator's device, leaf by leaf in sorted-key
    order), then cast to ``dtype or spec.dtype`` and move to ``device``
    (default: the generator's).  The values differ from the reference's
    ``jax.random`` streams; tests carry the reference's weights across
    instead (:func:`repro_torch.core.carry.lm_params_from_arrays`).
    """
    gen_dev = generator.device
    device = torch.device(device) if device is not None else gen_dev

    def make(spec: ParamSpec):
        dt = dtype or spec.dtype
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dt, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dt, device=device)
        if spec.init != "normal":
            raise ValueError(f"unknown init {spec.init!r}")
        x = torch.randn(spec.shape, generator=generator,
                        dtype=torch.float32, device=gen_dev)
        return (x * spec.scale).to(dtype=dt, device=device)

    def build(t):
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        return make(t)

    return build(tree)


def n_params(tree) -> int:
    return int(sum(int(np.prod(s.shape)) for s in tree_leaves(tree)))


def stack_layers(tree, n: int):
    """Add a leading stacked-layers axis to every spec (the layer loop
    indexes it)."""
    def f(s: ParamSpec):
        return ParamSpec((n,) + s.shape, ("layers",) + s.logical,
                         s.dtype, s.init, s.scale)
    return tree_map_specs(f, tree)
