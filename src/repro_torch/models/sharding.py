"""Logical-axis sharding: one rules table maps logical names -> mesh axes.

Model code annotates activations with *logical* axis names via
:func:`constrain`; parameters carry logical names in their
:class:`~repro_torch.models.params.ParamSpec`.  A launcher installs a
:class:`ShardingCtx` (mesh + rules); without one, every annotation is a
no-op, so the same model code runs on one device.

:meth:`ShardingCtx.spec` resolves logical names exactly as the reference
does (the rules table, and each mesh axis consumed at most once per
spec).  :meth:`ShardingCtx.sharding` turns a spec into DTensor
placements over the mesh's ``DeviceMesh`` (the reference's
``NamedSharding``), and :func:`constrain` redistributes an activation to
them (the reference's ``with_sharding_constraint``).  With no context or
on a one-device mesh :func:`constrain` is the identity, so one-device
runs never see a DTensor.

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

import contextlib
import dataclasses
import functools
import math
import types
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch

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


class Sharding(NamedTuple):
    """A ``DeviceMesh`` and one DTensor placement per mesh dimension (the
    reference's ``NamedSharding``)."""

    mesh: object
    placements: tuple


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

    def groups(self) -> Tuple[Tuple[str, ...], ...]:
        """The mesh axes as runs of adjacent axes that every rule names
        together, in order (``("pod", "data")`` under the default rules):
        each run is one dim of the ``DeviceMesh`` the placements refer
        to.  Sharding over a run equals sharding over its axes major
        first, and DTensor plans layouts on a mesh of fewer dims much
        faster."""
        names = tuple(self.mesh.axis_names)
        rules = [(r,) if isinstance(r, str) else tuple(r)
                 for r in self.rules.values() if r is not None]
        runs = [[names[0]]]
        for a in names[1:]:
            prev = runs[-1][-1]
            if all((prev in r) == (a in r) and
                   (prev not in r or r.index(a) == r.index(prev) + 1)
                   for r in rules):
                runs[-1].append(a)
            else:
                runs.append([a])
        return tuple(tuple(r) for r in runs)

    def placements(self, logical: Sequence[Optional[str]]) -> tuple:
        """The DTensor placement of each dim of the mesh's ``DeviceMesh``
        (one a run of :meth:`groups`) for :meth:`spec`: ``Shard(d)`` when
        tensor dim ``d`` names that run's axes, ``Replicate()``
        otherwise.  A dim over several runs is sharded on each of them,
        major first, as a ``PartitionSpec`` tuple is."""
        from torch.distributed.tensor import Replicate, Shard
        runs = self.groups()
        names = sum(runs, ())
        out = [Replicate()] * len(runs)
        for d, ax in enumerate(self.spec(logical)):
            if ax is None:
                continue
            flat = (ax,) if isinstance(ax, str) else ax
            idx = [names.index(a) for a in flat]
            if idx != sorted(idx):
                raise ValueError(f"mesh axes {flat} of dim {d} are not in "
                                 f"the mesh's order {names}")
            for i, run in enumerate(runs):
                hit = [a in flat for a in run]
                if all(hit):
                    out[i] = Shard(d)
                elif any(hit):
                    raise ValueError(f"dim {d} names part of the mesh axes "
                                     f"{run}, which the rules name "
                                     f"together")
        return tuple(out)

    def device_mesh(self):
        """The mesh's ``DeviceMesh`` with the runs of :meth:`groups`
        merged, which every placement here refers to (it needs a process
        group of the mesh's size)."""
        return self.mesh.device_mesh(self.groups())

    def sharding(self, logical: Sequence[Optional[str]]) -> Sharding:
        """:meth:`placements` over :meth:`device_mesh`."""
        return Sharding(self.device_mesh(), self.placements(logical))


#: the installed context, process-wide (the reference keeps it per
#: thread): on CUDA the autograd engine runs the backward pass, and
#: remat's recompute of each layer, on threads of its own, which must
#: see the context the forward pass ran under
_ctx = types.SimpleNamespace(value=None, region=False)


def set_ctx(ctx: Optional[ShardingCtx]) -> None:
    _ctx.value = ctx


def get_ctx() -> Optional[ShardingCtx]:
    return _ctx.value


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
    """Annotate an activation with logical axes.

    With no context, or on a one-device mesh, this returns ``x`` itself.
    On a mesh of several devices it returns ``x`` redistributed to
    :meth:`ShardingCtx.sharding` of ``logical`` (a DTensor).  A plain
    tensor counts as replicated over the mesh, as an unsharded jax array
    does: it is wrapped as such first, which costs no communication."""
    ctx = get_ctx()
    if ctx is None:
        return x
    if len(logical) != x.ndim:
        raise ValueError(f"constrain: {len(logical)} logical axes for a "
                         f"tensor of shape {tuple(x.shape)}")
    if ctx.mesh.size == 1:
        return x
    return redistribute(x, ctx.sharding(logical))


def redistribute(x, sharding: Sharding):
    """``x`` (a DTensor, or a plain tensor taken as replicated) moved to
    ``sharding``."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, sharding.mesh,
                               [Replicate()] * sharding.mesh.ndim,
                               run_check=False)
    return x.redistribute(sharding.mesh, sharding.placements)


def is_sharded() -> bool:
    """True under a context whose mesh has several devices."""
    ctx = get_ctx()
    return ctx is not None and ctx.mesh.size > 1


@contextlib.contextmanager
def sharded_region():
    """A context for model code under a multi-device context: plain
    tensors made inside the model (positions, masks, ``arange`` s) mix
    with DTensors as replicated ones, also in the backward pass run
    inside it.  Elsewhere, and inside an enclosing region, it does
    nothing (DTensor's ``implicit_replication`` does not nest)."""
    if not is_sharded() or _ctx.region:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    _ctx.region = True
    try:
        with implicit_replication():
            yield
    finally:
        _ctx.region = False


def unshard(x, *dims: int):
    """``x`` with tensor dims ``dims`` replicated over every mesh dim that
    shards them (a DTensor; a plain tensor is returned as it is)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        return x
    dims = {d % x.ndim for d in dims}
    pl = [Replicate() if p.is_shard() and p.dim in dims else p
          for p in x.placements]
    if tuple(pl) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def reshape(x, *shape: int):
    """``x.reshape(shape)``.  On a DTensor, the dims the reshape changes
    (between the dims it keeps at both ends) are replicated first when
    DTensor could not view them without moving data: a split of one dim
    whose first part the shard count does not divide, a merge whose dims
    beyond the first are sharded, or anything else that is sharded."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x.reshape(shape)
    shape = list(shape)
    if -1 in shape:
        known = math.prod(s for s in shape if s != -1)
        shape[shape.index(-1)] = x.numel() // max(known, 1)
    n = min(x.ndim, len(shape))
    p = 0
    while p < n and x.shape[p] == shape[p]:
        p += 1
    q = 0
    while q < n - p and x.shape[x.ndim - 1 - q] == shape[-1 - q]:
        q += 1
    ways = [1] * x.ndim
    for i, pl in enumerate(x.placements):
        if pl.is_shard():
            ways[pl.dim] *= x.device_mesh.size(i)
    mid = range(p, x.ndim - q)
    out = len(shape) - q - p
    if all(ways[d] == 1 for d in mid):
        ok = True
    elif len(mid) == 1 and out >= 1:                  # split one dim
        ok = shape[p] % ways[p] == 0
    elif out == 1:                                  # merge into one dim
        ok = all(ways[d] == 1 for d in mid if d > p) \
            and x.shape[p] % ways[p] == 0
    else:
        ok = False
    y = (x if ok else unshard(x, *mid)).reshape(shape)
    return pin(y, y)       # the gradient comes back viewable


def is_dtensor(x) -> bool:
    """True for a DTensor under a multi-device context."""
    if not is_sharded():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def logsumexp(x):
    """``torch.logsumexp(x, -1)``; on a DTensor, from a max and a sum
    that reduce across the shards of the last dim (DTensor's own
    logsumexp gathers that dim whole)."""
    if not is_dtensor(x):
        return torch.logsumexp(x, dim=-1)
    from torch.distributed.tensor import Replicate
    m = torch.amax(x, dim=-1, keepdim=True).detach()
    e = pin(torch.exp(x - m), x)
    out = torch.log(torch.sum(e, dim=-1)) + m[..., 0]
    lead = [Replicate() if p.is_shard() and p.dim == x.ndim - 1 else p
            for p in x.placements]
    return out.redistribute(x.device_mesh, lead)


def batch_local(fn):
    """``fn``, which works row by row on dim 0 (the batch), run on each
    rank's own rows under a multi-device context: every DTensor argument
    is laid out as ``("batch", None, ...)`` (the batch over its mesh
    axes, every other dim whole), ``fn`` runs on the local tensors, and
    each tensor it returns is laid out so.  Plain arguments pass as they
    are.  DTensor's own choices for the products inside (attention, the
    SSD scan) can shard one dim over several mesh dims and then fail to
    view it back in the backward pass; this keeps them out of it.
    Elsewhere it is ``fn`` itself."""
    @functools.wraps(fn)
    def run(*args):
        from torch.distributed.tensor import DTensor
        dts = [a for a in args if isinstance(a, DTensor)]
        if not dts or not is_sharded():
            return fn(*args)
        ctx = get_ctx()
        mesh = dts[0].device_mesh

        def lay(ndim):
            return ctx.placements(("batch",) + (None,) * (ndim - 1))
        local = [a.redistribute(mesh, lay(a.ndim)).to_local(
                     grad_placements=lay(a.ndim))
                 if isinstance(a, DTensor) else a for a in args]
        out = fn(*local)
        rows = dts[0].shape[0]

        def wrap(o):
            return from_local(o.contiguous(), mesh, lay(o.ndim),
                              (rows,) + tuple(o.shape[1:]))
        return (tuple(map(wrap, out)) if isinstance(out, tuple)
                else wrap(out))
    return run


def pick(x, idx):
    """``x[..., idx]`` along the last dim (``torch.gather``).  On a DTensor
    sharded on that dim each rank picks from its own shard, zero where
    the index lies elsewhere, and the result is summed across those
    shards (DTensor's own gather replicates the whole of ``x`` in the
    backward pass)."""
    if not is_dtensor(x):
        return torch.gather(x, -1, idx[..., None])[..., 0]
    from torch.distributed.tensor import Replicate
    from repro_torch.models.params import shard_bounds
    mesh, d = x.device_mesh, x.ndim - 1
    on_d = [p.is_shard() and p.dim == d for p in x.placements]
    lead = tuple(Replicate() if o else p
                 for o, p in zip(on_d, x.placements))
    il = redistribute(idx, Sharding(mesh, lead)).to_local()
    lo, hi = shard_bounds(x.shape, Sharding(mesh, x.placements))[d]
    inside = (il >= lo) & (il < hi)
    xl = x.to_local(grad_placements=x.placements)
    got = torch.gather(xl, -1, torch.where(inside, il - lo, 0)[..., None])
    got = torch.where(inside, got[..., 0], 0.0)
    return _sum_shards(got, mesh, lead, on_d, tuple(idx.shape))


def take_rows(table, idx):
    """``table[idx]`` (an embedding lookup).  On a DTensor table sharded
    on its rows each rank takes the rows it holds, zero for the others,
    and the result is summed across those shards; the table's other
    dims are gathered whole first.  (DTensor's own rules for indexing
    and ``F.embedding`` fail on such tables in some torch versions.)"""
    if not is_dtensor(table):
        return table[idx]
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from repro_torch.models.params import shard_bounds
    table = unshard(table, *range(1, table.ndim))
    mesh = table.device_mesh
    on0 = [p.is_shard() and p.dim == 0 for p in table.placements]
    lay = (idx.placements if isinstance(idx, DTensor)
           else (Replicate(),) * mesh.ndim)
    lay = tuple(Replicate() if o else p for o, p in zip(on0, lay))
    il = redistribute(idx, Sharding(mesh, lay)).to_local()
    lo, hi = shard_bounds(table.shape, Sharding(mesh, table.placements))[0]
    inside = (il >= lo) & (il < hi)
    # each rank's rows collect the gradient of its own tokens only
    tl = table.to_local(grad_placements=tuple(
        Partial() if q.is_shard() else p
        for q, p in zip(lay, table.placements)))
    got = tl[torch.where(inside, il - lo, 0)]
    got = torch.where(inside[..., None], got, torch.zeros(
        (), dtype=got.dtype, device=got.device))
    return _sum_shards(got, mesh, lay, on0,
                       tuple(idx.shape) + tuple(table.shape[1:]))


def from_local(local, mesh, placements, shape):
    """``local`` as this rank's shard of a contiguous DTensor of global
    ``shape`` laid out by ``placements`` (no communication)."""
    from torch.distributed.tensor import DTensor
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * int(shape[d + 1])
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def _sum_shards(local, mesh, lay, on0, shape):
    """The DTensor of global ``shape`` laid out as ``lay`` whose local
    value is ``local`` summed over the mesh dims ``on0`` marks (each
    rank's partial sum; the gradient passes through unchanged)."""
    out = _AllReduce.apply(local, tuple(mesh.get_group(i)
                                        for i, o in enumerate(on0) if o))
    return from_local(out, mesh, lay, shape)


class _AllReduce(torch.autograd.Function):
    """A sum over process groups whose gradient is the output's (each
    rank's part counts once in the sum every rank holds)."""

    @staticmethod
    def forward(ctx, t, groups):
        from torch.distributed import _functional_collectives as funcol
        for g in groups:
            t = funcol.wait_tensor(funcol.all_reduce(t, "sum", g))
        return t

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def pin(x, ref):
    """``x`` laid out as ``ref`` is, with its gradient laid out so too in
    the backward pass (a DTensor's redistribution sends the gradient back
    to the layout it came from); DTensor's own choice for an
    elementwise backward may gather a sharded dim whole."""
    return x.redistribute(ref.device_mesh, ref.placements)


def data_ptr(x) -> int:
    """``x.data_ptr()``, of the local shard for a DTensor."""
    from torch.distributed.tensor import DTensor
    return (x.to_local() if isinstance(x, DTensor) else x).data_ptr()


def like(x, ref):
    """``x`` laid out as ``ref`` is, when both are DTensors with
    different placements; else ``x`` itself."""
    from torch.distributed.tensor import DTensor
    if (isinstance(x, DTensor) and isinstance(ref, DTensor)
            and tuple(x.placements) != tuple(ref.placements)):
        return x.redistribute(ref.device_mesh, ref.placements)
    return x
