"""Device meshes for sharded evaluation and campaign dispatch.

A mesh here is a small plain object (:class:`Mesh`): named axes, their
shape, and the flat tuple of ``torch.device`` s it spans, in row-major
order.  Consumers partition candidate rows jointly over ALL of its axes,
so a shard is one entry of ``devices`` and ``size`` is the shard count.
Nothing collective happens across a mesh: every shard runs the unchanged
per-row fixpoint on its own contiguous block of rows, which is why the
results are bit-identical to the unsharded path.

Two named axes cover every consumer:

``eval``
    The config-batch axis (:class:`repro_torch.core.backends.mesh
    .MeshBackend`).
``design``
    The campaign axis: the hetero dispatcher packs rows design-major, so
    a ``("design", "eval")`` mesh lands contiguous design blocks on
    contiguous device groups.

Which devices a mesh uses:

* by default the first ``shards`` CUDA devices, ``cuda:0..shards-1``
  (more than ``torch.cuda.device_count()`` raises ``ValueError``);
* ``device="cpu"`` repeats the CPU ``shards`` times, the counterpart of
  the reference's host-platform device emulation;
* an explicit ``devices=`` list, which may repeat a device: ``["cuda:0"]
  * 4`` runs a 4-shard mesh on one card.

Building a mesh touches no CUDA state beyond the device count.

The production meshes (:func:`make_production_mesh`,
:func:`make_local_mesh`) place a MODEL over devices: ``("data",
"model")`` or ``("pod", "data", "model")``, one rank a device.  Such a
mesh yields its ``torch.distributed`` ``DeviceMesh``
(:meth:`Mesh.device_mesh`), built on first use over the process group
that is up, whose world size must equal the mesh's size; the row
sharding meshes above never build one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

__all__ = [
    "Mesh", "device_grid", "ensure_host_platform_devices",
    "make_campaign_mesh", "make_eval_mesh", "make_local_mesh",
    "make_production_mesh",
]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named axes over a flat, row-major tuple of torch devices."""

    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]
    devices: tuple

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"mesh axes {self.axis_names} do not match "
                             f"its shape {self.shape}")
        if math.prod(self.shape) != len(self.devices):
            raise ValueError(f"mesh shape {self.shape} needs "
                             f"{math.prod(self.shape)} devices, got "
                             f"{len(self.devices)}")

    @property
    def size(self) -> int:
        """The shard count: every axis jointly."""
        return len(self.devices)

    def device_mesh(self, groups: Optional[Sequence[Sequence[str]]] = None):
        """This mesh as a ``torch.distributed`` ``DeviceMesh``: ranks
        ``0..size-1`` in row-major order, ``mesh_dim_names`` the axis
        names, on the device type of ``devices``.  ``groups`` (runs of
        adjacent axes, in order, covering every axis) merges each run
        into one mesh dim named ``"a.b"``: the same ranks, fewer dims.
        Needs a process group whose world size is ``size``; built once
        per process group and kept on the mesh."""
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh
        if not dist.is_initialized() or dist.get_world_size() != self.size:
            have = dist.get_world_size() if dist.is_initialized() else None
            raise RuntimeError(
                f"a DeviceMesh of shape {self.shape} needs a process group "
                f"of world size {self.size} (the group that is up has "
                f"{have})")
        groups = tuple(tuple(g) for g in (
            groups if groups is not None else [(a,) for a in self.axis_names]))
        if sum(groups, ()) != tuple(self.axis_names):
            raise ValueError(f"mesh axis groups {groups} do not cover "
                             f"{self.axis_names} in order")
        world = dist.group.WORLD
        cache = self.__dict__.setdefault("_device_meshes", {})
        if groups not in cache or cache[groups][0] is not world:
            size = dict(zip(self.axis_names, self.shape))
            shape = [math.prod(size[a] for a in g) for g in groups]
            cache[groups] = (world, DeviceMesh(
                self.devices[0].type,
                torch.arange(self.size).reshape(shape),
                mesh_dim_names=tuple(".".join(g) for g in groups)))
        return cache[groups][1]


def ensure_host_platform_devices(n: int) -> bool:
    """Kept for the reference's API: a CPU mesh of any size is the CPU
    repeated (``make_eval_mesh(n, device="cpu")``), so nothing has to be
    requested before start-up.  Returns True; touches neither CUDA nor
    any environment variable."""
    return True


def device_grid(n: int) -> Tuple[int, int]:
    """Near-square 2-D factorization of ``n`` devices, ``a <= b``."""
    n = int(n)
    if n < 1:
        raise ValueError(f"need at least one device, got {n}")
    a = int(n ** 0.5)
    while n % a:
        a -= 1
    return (a, n // a)


def _require(n_devices: int, shape: Sequence[int], what: str) -> None:
    need = math.prod(shape)
    if need > n_devices:
        raise ValueError(
            f"{what}: requested mesh shape {tuple(shape)} needs {need} "
            f"devices but only {n_devices} are available "
            f"(torch.cuda.device_count()). Pass devices=[...] to place "
            f"several shards on one device (e.g. ['cuda:0'] * {need}), or "
            f"device='cpu' for a CPU mesh.")


def _pool(device, devices) -> Optional[list]:
    """The devices a mesh may take, in order; None for the CPU, which
    repeats as often as asked."""
    import torch
    if devices is not None:
        pool = [torch.device(d) for d in devices]
        if not pool:
            raise ValueError("a mesh needs at least one device")
        return pool
    if device is not None and torch.device(device).type == "cpu":
        return None
    if device is not None and torch.device(device).index is not None:
        raise ValueError(
            f"device={device!r} names one card; pass devices=[...] to "
            f"build a mesh over chosen devices")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' for a CPU "
            "mesh")
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def _take(pool: Optional[list], shape: Sequence[int], what: str) -> tuple:
    import torch
    n = math.prod(shape)
    if pool is None:
        return (torch.device("cpu"),) * n
    _require(len(pool), shape, what)
    return tuple(pool[:n])


def make_eval_mesh(shards: Optional[int] = None, device=None,
                   devices=None) -> Mesh:
    """1-D ``("eval",)`` mesh over ``shards`` devices (default: every
    device available: every CUDA device, every entry of ``devices``, or
    one CPU).  Raises ``ValueError`` when more shards are asked for than
    there are devices, and ``RuntimeError`` without a card unless
    ``device="cpu"`` or ``devices`` is given."""
    pool = _pool(device, devices)
    if shards is None:
        shards = len(pool) if pool is not None else 1
    shards = int(shards)
    if shards < 1:
        raise ValueError(f"need at least one shard, got {shards}")
    return Mesh(("eval",), (shards,), _take(pool, (shards,),
                                            "make_eval_mesh"))


def make_campaign_mesh(design_shards: Optional[int] = None,
                       eval_shards: Optional[int] = None, device=None,
                       devices=None) -> Mesh:
    """2-D ``("design", "eval")`` mesh for cross-design campaign dispatch.

    Defaults to a near-square grid over every available device (one CPU
    for ``device="cpu"``); either axis can be pinned.  The hetero
    dispatcher partitions its packed row batch over BOTH axes jointly.
    """
    pool = _pool(device, devices)
    n = len(pool) if pool is not None else 1
    what = "make_campaign_mesh"
    if design_shards is None and eval_shards is None:
        shape = device_grid(n)
    elif design_shards is None:
        if pool is not None:
            _require(n, (eval_shards,), what)
        shape = (max(1, n // int(eval_shards)), int(eval_shards))
    elif eval_shards is None:
        if pool is not None:
            _require(n, (design_shards,), what)
        shape = (int(design_shards), max(1, n // int(design_shards)))
    else:
        shape = (int(design_shards), int(eval_shards))
    return Mesh(("design", "eval"), tuple(shape), _take(pool, shape, what))


def _rank_devices(device) -> Tuple[int, Optional[list]]:
    """``(device count, devices or None for the CPU)`` for a production
    mesh: one rank a device when a process group is up (rank ``r``
    computes on ``cuda:r % cards``), else every card, or one CPU."""
    import torch
    import torch.distributed as dist
    cpu = device is not None and torch.device(device).type == "cpu"
    if dist.is_initialized():
        n = dist.get_world_size()
        if cpu:
            return n, [torch.device("cpu")] * n
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' for a CPU mesh")
        cards = torch.cuda.device_count()
        return n, [torch.device("cuda", r % cards) for r in range(n)]
    if cpu:
        return 1, None
    pool = _pool(device, None)
    return len(pool), pool


def make_production_mesh(*, multi_pod: bool = False,
                         shape: Optional[Sequence[int]] = None,
                         device=None) -> Mesh:
    """Accelerator-pod mesh, shape derived from the device count: the
    world size of the process group when one is up, else
    ``torch.cuda.device_count()`` (one CPU for ``device="cpu"``, which
    repeats as often as ``shape`` asks).

    Single pod: a near-square ``("data", "model")`` grid over every
    device (256 ranks -> 16x16).  ``multi_pod`` splits the fleet into 2
    pods first: ``("pod", "data", "model")`` with a near-square grid per
    pod (512 ranks -> 2x16x16).  Pass ``shape`` to pin an explicit
    topology; it is validated against the available device count and
    fails with a clear error.
    """
    n, pool = _rank_devices(device)
    what = "make_production_mesh"
    if shape is not None:
        axes = ("pod", "data", "model") if len(shape) == 3 \
            else ("data", "model")
        if len(shape) != len(axes):
            raise ValueError(
                f"make_production_mesh: shape must be 2-D (data, model) "
                f"or 3-D (pod, data, model), got {tuple(shape)}")
        if pool is not None:
            _require(n, shape, what)
    elif multi_pod:
        if n < 2 or n % 2:
            raise ValueError(
                f"make_production_mesh(multi_pod=True) needs an even "
                f"device count >= 2, got {n}")
        shape = (2,) + device_grid(n // 2)
        axes = ("pod", "data", "model")
    else:
        shape = device_grid(n)
        axes = ("data", "model")
    shape = tuple(int(a) for a in shape)
    return Mesh(axes, shape, _take(pool, shape, what))


def make_local_mesh(device=None) -> Mesh:
    """1x1 ``("data", "model")`` mesh over the first local device (the
    first card, or the CPU for ``device="cpu"``)."""
    return Mesh(("data", "model"), (1, 1),
                _take(_pool(device, None), (1, 1), "make_local_mesh"))
