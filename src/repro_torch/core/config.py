"""EvalConfig: the one frozen, serializable evaluation configuration.

The same fields as the reference package's ``EvalConfig``, so a config
dict written there (a snapshot, a campaign checkpoint) loads here
unchanged through :meth:`EvalConfig.from_dict`; the backend name
``"pallas"`` is an alias of this package's ``"cuda"`` kernel backend.

Runtime-only objects stay explicit keyword arguments on the consumers:
the torch ``device`` and per-design ``upper_bounds`` arrays on
``FifoAdvisor``, prebuilt ``CondensedGraph`` rung lists (``rungs=``) on
``BatchedEvaluator``.

``faults`` carries a :class:`~repro_torch.core.faults.FaultPlan`'s JSON
(the same schedule format as the reference's).  ``shards`` selects the
row-sharded ``"mesh"`` backend over that many devices
(:mod:`repro_torch.core.backends.mesh`).

The legacy keyword spellings (``backend=``, ``max_iters=``,
``use_pallas=``, ...) still work on the service's constructors through
:func:`resolve_config`, which maps them 1:1 onto an ``EvalConfig`` and
emits a :class:`DeprecationWarning`; :func:`same_config` compares two
configs with the backend aliases mapped to their canonical names.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

__all__ = ["EvalConfig", "resolve_config", "same_config"]


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """How to evaluate candidate depth configurations.

    Args:
        backend: ``"cuda"`` (alias ``"pallas"``, the hand-written
            kernels), ``"fixpoint"`` (alias ``"jax"``, the plain torch
            fixpoint), ``"numpy"``/``"worklist"`` (CPU worklist with
            incremental re-simulation), ``"mesh"`` (alias ``"sharded"``,
            rows sharded over devices) or ``"auto"`` (one-shot
            per-design calibration probe).
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
        faults: JSON of a :class:`~repro_torch.core.faults.FaultPlan`
            to inject (chaos testing only; None = no injection).
        shards: shard batched evaluation over this many devices (forces
            the ``"mesh"`` backend; hetero campaigns and services shard
            their packed cross-design dispatch instead).  None =
            unsharded.
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
        object.__setattr__(self, "max_iters", int(self.max_iters))
        if self.shards is not None:
            object.__setattr__(self, "shards", int(self.shards))

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


#: legacy keyword -> EvalConfig field (1:1 except use_pallas)
_LEGACY_KEYS = ("backend", "max_iters", "condense", "shards",
                "occupancy_cap", "local_bounds", "certified_floor",
                "use_pallas")


def resolve_config(config: Optional[EvalConfig], legacy: dict,
                   where: str, default: Optional[EvalConfig] = None,
                   stacklevel: int = 3) -> EvalConfig:
    """Merge deprecated keyword arguments into an :class:`EvalConfig`.

    ``legacy`` is the consumer's ``**kwargs`` dict.  Unknown keys raise
    ``TypeError`` (same contract as a plain signature); known legacy
    keys emit one :class:`DeprecationWarning` and map onto a fresh
    config (``use_pallas=True`` maps to ``backend="pallas"``, the alias
    of ``"cuda"``).  Passing both ``config`` and legacy keywords is an
    error — silently merging them would hide which one wins.
    """
    unknown = [k for k in legacy if k not in _LEGACY_KEYS]
    if unknown:
        raise TypeError(
            f"{where}() got unexpected keyword argument(s) "
            f"{sorted(unknown)}")
    if not legacy:
        return config if config is not None else (default or EvalConfig())
    if config is not None:
        raise TypeError(
            f"{where}(): pass either config=EvalConfig(...) or the "
            f"deprecated keyword(s) {sorted(legacy)}, not both")
    warnings.warn(
        f"{where}({', '.join(sorted(legacy))}=...) is deprecated; pass "
        f"config=EvalConfig(...) instead (the keywords map 1:1; "
        f"use_pallas=True becomes backend='pallas')",
        DeprecationWarning, stacklevel=stacklevel)
    base = default or EvalConfig()
    fields = {k: v for k, v in legacy.items() if k != "use_pallas"}
    if legacy.get("use_pallas"):
        fields["backend"] = "pallas"
    return dataclasses.replace(base, **fields)


#: reference backend spellings -> this package's canonical names
_BACKEND_ALIASES = {"pallas": "cuda", "jax": "fixpoint"}


def same_config(a: EvalConfig, b: EvalConfig) -> bool:
    """Whether two configs mean the same evaluation: equal field by
    field once ``"pallas"`` reads ``"cuda"`` and ``"jax"`` reads
    ``"fixpoint"`` (a reference snapshot records the reference's
    spelling of the same kernel backend)."""
    def canon(c: EvalConfig) -> EvalConfig:
        return c.replace(backend=_BACKEND_ALIASES.get(c.backend, c.backend))
    return canon(a) == canon(b)
