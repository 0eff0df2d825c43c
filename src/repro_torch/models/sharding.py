"""Logical-axis sharding: one rules table maps logical names -> mesh axes.

Model code annotates activations with *logical* axis names via
:func:`constrain`; parameters carry logical names in their
:class:`~repro_torch.models.params.ParamSpec`.  A launcher installs a
:class:`ShardingCtx` (mesh + rules); without one, every annotation is a
no-op, so the same model code runs on one device.

This package serves and trains the models on ONE device.
:meth:`ShardingCtx.spec` resolves logical names exactly as the reference
does (the rules table, and each mesh axis consumed at most once per
spec), and :func:`constrain` is the identity with no context or on a
one-device mesh; placing a model over several devices is ROADMAP P14c
and raises.

Default rules (the reference's):

    batch   -> ("pod", "data")    data parallel (pod axis folds in)
    vocab   -> "model"            embedding/logits tensor parallel
    heads   -> "model"            attention head TP (divisible archs)
    mlp     -> "model"            FFN hidden TP
    experts -> "model"            MoE expert parallel
    kv_seq  -> "model"            context-parallel KV (non-divisible archs)
    fsdp    -> "data"             ZeRO-3 style param sharding (large archs)
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Optional, Sequence, Tuple, Union

Axis = Union[None, str, Tuple[str, ...]]

DEFAULT_RULES: Dict[str, Axis] = {
    "batch": ("pod", "data"),
    "vocab": "model",
    "heads": "model",
    "kv_heads": None,
    "mlp": "model",
    "experts": "model",
    "seq": None,
    "kv_seq": "model",
    # params' d_model dim is ZeRO-3 sharded over the data-parallel axes;
    # on ACTIVATIONS ("batch","seq","embed") the batch spec consumes those
    # axes first, so the embed dim stays unsharded there (spec() dedups).
    "embed": ("pod", "data"),
    "fsdp": ("pod", "data"),     # ZeRO-3 over all data-parallel replicas
    "layers": None,
    "ssm_heads": "model",
    "ssm_inner": "model",
    "capacity": None,
    "conv": None,
    "state": None,
}


@dataclasses.dataclass
class ShardingCtx:
    """A mesh (anything with ``axis_names`` and ``size``, such as
    :class:`repro_torch.launch.mesh.Mesh`) and the logical rules."""

    mesh: object
    rules: Dict[str, Axis]

    def spec(self, logical: Sequence[Optional[str]]) -> tuple:
        """Mesh axes per dimension (None, one axis name, or a tuple of
        them), as the reference's ``PartitionSpec``."""
        axes = []
        used = set()
        for name in logical:
            ax = self.rules.get(name) if name else None
            # an axis may be consumed at most once per spec
            if ax is None:
                axes.append(None)
                continue
            flat = (ax,) if isinstance(ax, str) else tuple(ax)
            flat = tuple(a for a in flat
                         if a not in used and a in self.mesh.axis_names)
            used.update(flat)
            if not flat:
                axes.append(None)
            elif len(flat) == 1:
                axes.append(flat[0])
            else:
                axes.append(flat)
        return tuple(axes)


_ctx = threading.local()


def set_ctx(ctx: Optional[ShardingCtx]) -> None:
    _ctx.value = ctx


def get_ctx() -> Optional[ShardingCtx]:
    return getattr(_ctx, "value", None)


class use_ctx:
    """``with use_ctx(mesh, rules): ...`` — installs the sharding context."""

    def __init__(self, mesh, rules: Optional[Dict[str, Axis]] = None):
        self.ctx = (ShardingCtx(mesh, dict(DEFAULT_RULES, **(rules or {})))
                    if mesh is not None else None)

    def __enter__(self):
        self.prev = get_ctx()
        set_ctx(self.ctx)
        return self.ctx

    def __exit__(self, *exc):
        set_ctx(self.prev)
        return False


def constrain(x, *logical: Optional[str]):
    """Annotate an activation with logical axes: the identity with no
    context or on a one-device mesh; a multi-device mesh raises
    ``NotImplementedError`` (ROADMAP P14c)."""
    ctx = get_ctx()
    if ctx is None:
        return x
    if len(logical) != x.ndim:
        raise ValueError(f"constrain: {len(logical)} logical axes for a "
                         f"tensor of shape {tuple(x.shape)}")
    if ctx.mesh.size > 1:
        raise NotImplementedError(
            "placing a model over several devices is not ported yet: "
            "ROADMAP P14c")
    return x
