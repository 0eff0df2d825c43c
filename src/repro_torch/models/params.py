"""Parameter metadata: one source of truth for shapes and initialisation.

Models build a tree (nested dicts) of :class:`ParamSpec`; the same tree
yields materialized parameters (:func:`materialize`), shardings and
specs under a :class:`~repro_torch.models.sharding.ShardingCtx`
(:func:`shardings`, :func:`specs`), meta tensors or meta DTensors for
the dry-run (:func:`shape_structs`) and, for tests, the shapes that
weights carried across from the reference must have
(:func:`repro_torch.core.carry.lm_params_from_arrays`).  :func:`place`
cuts a materialized tree into this rank's shards (the reference's
``jax.device_put(tree, shardings)``).  Leaves are visited in sorted-key
order, as ``jax.tree`` does.
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


def meta(shape, dtype, logical, ctx=None):
    """A tensor of ``shape`` that holds no memory: a meta tensor with no
    context (or on a one-device mesh), else a meta DTensor laid out by
    ``ctx.sharding(logical)`` whose local shard is this rank's (made
    without communication)."""
    if ctx is None or ctx.mesh.size == 1:
        return torch.empty(shape, dtype=dtype, device="meta")
    sh = ctx.sharding(logical)
    local = torch.empty(local_shape(shape, sh), dtype=dtype, device="meta")
    return place_local(local, sh, shape)


def shape_structs(tree, ctx=None):
    """:func:`meta` of every spec, for the dry-run."""
    return tree_map_specs(lambda s: meta(s.shape, s.dtype, s.logical, ctx),
                          tree)


def shardings(tree, ctx):
    """The :class:`~repro_torch.models.sharding.Sharding` of every
    spec."""
    return tree_map_specs(lambda s: ctx.sharding(s.logical), tree)


def specs(tree, ctx):
    """The mesh-axis spec of every spec (the reference's
    ``PartitionSpec`` tree)."""
    return tree_map_specs(lambda s: ctx.spec(s.logical), tree)


def shard_bounds(shape, sharding) -> list:
    """``(start, stop)`` of this rank's piece of each dim.  Each mesh dim
    that shards a tensor dim splits its current piece as ``torch.chunk``
    does (the first ranks take the ceiling; trailing ones may be empty),
    major mesh dim first: DTensor's own layout."""
    coord = sharding.mesh.get_coordinate()
    out = [(0, int(n)) for n in shape]
    for i, pl in enumerate(sharding.placements):
        if not pl.is_shard():
            continue
        start, stop = out[pl.dim]
        k = sharding.mesh.size(i)
        size = -(-(stop - start) // k)
        lo = min(start + coord[i] * size, stop)
        out[pl.dim] = (lo, min(lo + size, stop))
    return out


def local_shape(shape, sharding) -> Tuple[int, ...]:
    """This rank's shard shape of a tensor of ``shape``."""
    return tuple(b - a for a, b in shard_bounds(shape, sharding))


def local_shard(t: torch.Tensor, sharding) -> torch.Tensor:
    """This rank's piece of the full tensor ``t`` (a view)."""
    for d, (a, b) in enumerate(shard_bounds(t.shape, sharding)):
        t = t.narrow(d, a, b - a)
    return t


def place_local(local: torch.Tensor, sharding, shape):
    """This rank's shard ``local`` of a tensor of ``shape`` as a DTensor
    laid out by ``sharding`` (no communication)."""
    from repro_torch.models.sharding import from_local
    return from_local(local, sharding.mesh, sharding.placements, shape)


def place(tree, shardings_tree):
    """Each full tensor of ``tree`` as a DTensor laid out by the matching
    sharding: every rank keeps a copy of its own piece, so nothing is
    communicated."""
    def go(t, sh):
        if isinstance(t, dict):
            return {k: go(t[k], sh[k]) for k in t}
        return place_local(local_shard(t, sh).clone(
            memory_format=torch.contiguous_format), sh, t.shape)
    return go(tree, shardings_tree)


def n_params(tree) -> int:
    return int(sum(int(np.prod(s.shape)) for s in tree_leaves(tree)))


def stack_layers(tree, n: int):
    """Add a leading stacked-layers axis to every spec (the layer loop
    indexes it)."""
    def f(s: ParamSpec):
        return ParamSpec((n,) + s.shape, ("layers",) + s.logical,
                         s.dtype, s.init, s.scale)
    return tree_map_specs(f, tree)
