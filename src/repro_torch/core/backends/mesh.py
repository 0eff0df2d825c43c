"""Device-mesh sharded evaluation backend.

Candidate depth rows are embarrassingly parallel — one independent
max-plus fixpoint per row — so the batched evaluators scale across
devices by pure row partitioning: pad the batch to a shard multiple by
repeating the last row, run each contiguous row block through the
unchanged per-row fixpoint on its own device, and gather the blocks back
in order.  No collectives and no replication, and therefore results
bit-identical to the solo path at every shard count.

:class:`MeshBackend` is a drop-in :class:`~repro_torch.core.backends.base
.EvalBackend` (registry name ``"mesh"``, alias ``"sharded"``): the
dispatch policy, the condensation rung cascade, UNRESOLVED-row worklist
escalation and the ConfigCache compose with it unchanged.  Select it
directly —

    BatchedEvaluator(g, EvalConfig(backend="mesh", shards=2))
    MeshBackend(mesh=make_eval_mesh(4, devices=["cuda:0"] * 4))

— or let ``backend="auto"`` race it on a host with more than one card.
With ``inner="cuda"`` (the default) every shard launches the CUDA
kernels itself: K1 on the aggressive rungs (fixpoint and certificate in
one launch per shard), K2 on the rest.
"""

from __future__ import annotations

from repro_torch.core.backends.base import register_backend
from repro_torch.core.backends.fixpoint import _ScanBackend

#: the inner fixpoints, with the reference's spelling of the kernels
_INNERS = {"cuda": "cuda", "pallas": "cuda", "fixpoint": "fixpoint"}


@register_backend
class MeshBackend(_ScanBackend):
    """Config-batch-sharded evaluation over a device mesh.

    Args:
        max_iters: fixpoint iteration cap (UNRESOLVED rows escalate as
            on every batched backend; the deep-cap K2 launch runs on the
            mesh's first device).
        mesh: an explicit :class:`repro_torch.launch.mesh.Mesh`; rows are
            partitioned jointly over ALL of its axes, so both a 1-D
            ``("eval",)`` mesh and a 2-D ``("design", "eval")`` campaign
            mesh work.
        shards: shorthand — build a 1-D eval mesh over this many devices
            (default: every CUDA device; with ``device="cpu"``, the CPU
            repeated).  Ignored when ``mesh`` is given.
        inner: ``"cuda"`` (the hand-written kernels; their plain versions
            on CPU shards) or ``"fixpoint"`` (the plain torch fixpoint);
            ``"pallas"`` is the reference's spelling of ``"cuda"``.  The
            reference's default is its jnp fixpoint; here the kernels are
            the main path, so they are the default.
        device: where a mesh built from ``shards`` lives (None = CUDA).
    """

    name = "mesh"
    aliases = ("sharded",)
    wants_bucketing = True

    def __init__(self, max_iters: int = 64, mesh=None,
                 shards: int = None, inner: str = "cuda", device=None):
        if inner not in _INNERS:
            raise ValueError(
                f"MeshBackend inner must be 'cuda' (alias 'pallas') or "
                f"'fixpoint', got {inner!r}")
        if mesh is None:
            from repro_torch.launch.mesh import make_eval_mesh
            mesh = make_eval_mesh(shards, device=device)
        super().__init__(max_iters=max_iters,
                         device=device if device is not None
                         else mesh.devices[0])
        self.mesh = mesh
        self.inner = _INNERS[inner]
        self.use_ref = self.inner == "fixpoint"

    @property
    def n_shards(self) -> int:
        return self.shard_multiple

    def spawn(self) -> "MeshBackend":
        """Same-configuration clone — keeps the condensation rung
        cascade's per-rung evaluators on the same mesh."""
        return type(self)(max_iters=self.max_iters, mesh=self.mesh,
                          inner=self.inner, device=self.device)
