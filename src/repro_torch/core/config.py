"""EvalConfig: the one frozen, serializable evaluation configuration.

The same fields as the reference package's ``EvalConfig``, so a config
dict written there (a snapshot, a campaign checkpoint) loads here
unchanged through :meth:`EvalConfig.from_dict`; the backend name
``"pallas"`` is an alias of this package's ``"cuda"`` kernel backend.

Runtime-only objects stay explicit keyword arguments on the consumers:
the torch ``device`` and per-design ``upper_bounds`` arrays on
``FifoAdvisor``, prebuilt ``CondensedGraph`` rung lists (``rungs=``) on
``BatchedEvaluator``.

The fields whose machinery is not ported yet (``shards``, ``faults``)
are kept so reference configs round-trip, but raise
``NotImplementedError`` when set.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["EvalConfig"]

#: field -> (value that means "off", ROADMAP item that ports it)
_NOT_PORTED = {
    "shards": (None, "P11 (multi-device row sharding)"),
    "faults": (None, "P12 (core/faults.py)"),
}


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """How to evaluate candidate depth configurations.

    Args:
        backend: ``"cuda"`` (alias ``"pallas"``, the hand-written
            kernels), ``"fixpoint"`` (alias ``"jax"``, the plain torch
            fixpoint) or ``"numpy"``/``"worklist"`` (CPU worklist with
            incremental re-simulation).
        max_iters: fixpoint iteration cap for the batched backends.
        condense: ``"auto"`` condenses once per design and routes
            batches through the certified rung cascade; ``None``
            disables it.
        occupancy_cap: collapse candidates above observed occupancy
            (behaviour-preserving pruning).
        local_bounds: sound per-FIFO lower bounds from task-pair
            feasibility (:mod:`repro_torch.core.prune`).
        channel_bounds: sound per-FIFO lower bounds from the analytical
            channel-bounds pass (:mod:`repro_torch.core.bounds`) —
            strictly more global than ``local_bounds`` (it follows
            transitive cross-task coupling) and free once the design is
            traced.
        certified_floor: clamp every candidate grid at the certified
            minimal deadlock-free depths (``FifoAdvisor.min_safe_depths``).
        shards, faults: reference fields, not ported yet (must stay
            off).
    """

    backend: str = "cuda"
    max_iters: int = 256
    condense: Optional[str] = "auto"
    shards: Optional[int] = None
    occupancy_cap: bool = False
    local_bounds: bool = False
    channel_bounds: bool = False
    certified_floor: bool = False
    faults: Optional[str] = None

    def __post_init__(self):
        if self.condense not in ("auto", None):
            raise ValueError(
                f"EvalConfig.condense must be 'auto' or None, got "
                f"{self.condense!r} (pass prebuilt rungs via the "
                f"evaluator's rungs= argument instead)")
        for name, (off, item) in _NOT_PORTED.items():
            if getattr(self, name) != off:
                raise NotImplementedError(
                    f"EvalConfig.{name} is not ported yet: ROADMAP {item}")
        object.__setattr__(self, "max_iters", int(self.max_iters))

    # ------------------------------------------------------ serialization
    def to_dict(self) -> dict:
        """JSON-ready dict; ``from_dict`` round-trips it exactly."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "EvalConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(
                f"unknown EvalConfig field(s) {sorted(unknown)}; "
                f"expected a subset of {sorted(known)}")
        return cls(**d)

    def replace(self, **changes) -> "EvalConfig":
        """A copy with the given fields replaced."""
        return dataclasses.replace(self, **changes)
