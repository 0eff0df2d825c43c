"""Evaluation-backend protocol, registry and device resolution.

A backend turns a :class:`~repro_torch.core.simgraph.SimGraph` plus a batch
of candidate depth vectors into exact ``(latency, bram, status)`` triples:

    backend = get_backend("cuda")(max_iters=64)        # device=None: cuda
    backend.prepare(graph)                    # -> operands, built once
    lat, bram, status = backend.evaluate(depth_matrix)   # (C, F) ints

``status`` is per-row: CONVERGED rows carry an exact latency, DEADLOCK rows
are infeasible, UNRESOLVED rows hit an iteration cap and must be escalated
(see :mod:`repro_torch.core.backends.dispatch`): to K2 at
:data:`ESCALATION_ITERS` on a CUDA device, then to the worklist arbiter.

Tensor backends take ``device=None``, which means ``torch.device("cuda")``;
without a CUDA device they raise unless the caller passes ``device="cpu"``.
The numpy worklist backend ignores ``device``.
"""

from __future__ import annotations

import abc
from typing import Dict, Tuple, Type

import numpy as np

from repro_torch.core.simgraph import SimGraph

BIG = np.float32(1e9)
F32_EXACT_LIMIT = 1.5e7

# per-row status codes
CONVERGED = 0
DEADLOCK = 1
UNRESOLVED = 2

#: the iteration cap of the device escalation tier: rows UNRESOLVED at the
#: first cap (``EvalConfig.max_iters``) are relaunched through K2 from zero
#: at this cap before any reaches the worklist.  On the Stream-HLS suite
#: every such row is a deadlock that K2 proves (``max(t)`` over the bound)
#: in 721-744 iterations; 2048 leaves about 2.8x of room, and a row that
#: needs more still reaches the worklist.  A routing constant, not a
#: setting: results are exact at any cap.
ESCALATION_ITERS = 2048


def resolve_device(device=None):
    """``None`` -> ``torch.device("cuda")``; raises when the resolved
    device is CUDA and no CUDA device exists (never falls back to the
    CPU: a caller asks for the CPU by passing ``device="cpu"``)."""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "tensor backends on the CPU, or pick backend='numpy'")
    return dev


class EvalBackend(abc.ABC):
    """One evaluation strategy over a prepared simulation graph."""

    #: registry key; subclasses may also list aliases
    name: str = "abstract"
    aliases: Tuple[str, ...] = ()
    #: whether the dispatch policy should pad batches to bucket sizes so the
    #: backend sees a small, reusable set of batch shapes
    wants_bucketing: bool = False
    #: True when (prepared on a CondensedGraph) the backend fuses the
    #: exactness certificate into evaluation: it then exposes
    #: ``evaluate_certified(m) -> (lat, bram, status, cert)`` and the
    #: rung cascade skips the host-side ``verify_rows`` entirely
    fused_certificate: bool = False
    #: True when the backend runs K2 on a CUDA device: the dispatch policy
    #: then settles UNRESOLVED rows with ``escalate(m) -> (lat, status)``,
    #: one K2 launch at :data:`ESCALATION_ITERS`, before the worklist
    device_escalation: bool = False

    def __init__(self, max_iters: int = 64, device=None):
        self.max_iters = int(max_iters)
        self.device = device
        self.g: SimGraph = None

    @abc.abstractmethod
    def prepare(self, g: SimGraph):
        """Bind ``g`` and build (cached) operands; returns the operands."""

    @abc.abstractmethod
    def evaluate(self, depth_matrix: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(C, F) int depths -> (latency int64, bram int64, status int8).

        Latency entries are only meaningful on CONVERGED rows.
        """

    def spawn(self) -> "EvalBackend":
        """A fresh, unprepared instance with the same configuration (the
        condensation rung cascade prepares one evaluator per rung)."""
        return type(self)(max_iters=self.max_iters, device=self.device)


BACKENDS: Dict[str, Type[EvalBackend]] = {}


def register_backend(cls: Type[EvalBackend]) -> Type[EvalBackend]:
    """Class decorator: add ``cls`` to the registry under its ``name``
    and every alias, making it selectable as
    ``EvalConfig(backend=<name>)``.  Returns ``cls``."""
    BACKENDS[cls.name] = cls
    for alias in cls.aliases:
        BACKENDS[alias] = cls
    return cls


#: backends whose defining module is imported on first request, so the
#: numpy-only worklist path never pays the torch import
_LAZY_BACKEND_MODULES = {
    "worklist": "repro_torch.core.backends.worklist",
    "numpy": "repro_torch.core.backends.worklist",
    "fixpoint": "repro_torch.core.backends.fixpoint",
    "jax": "repro_torch.core.backends.fixpoint",
    "cuda": "repro_torch.core.backends.pallas",
    "pallas": "repro_torch.core.backends.pallas",
    "mesh": "repro_torch.core.backends.mesh",
    "sharded": "repro_torch.core.backends.mesh",
}


def available_backends() -> Tuple[str, ...]:
    """Canonical backend names of this package (the torch backends run
    on the device the caller gives them)."""
    names = {cls.name for cls in BACKENDS.values()}
    names.update({"worklist", "fixpoint", "cuda", "mesh"})
    return tuple(sorted(names))


def get_backend(name: str) -> Type[EvalBackend]:
    """Resolve a registry name (or alias) to its backend class,
    importing lazy modules on first request; raises ``ValueError`` with
    the available names on a miss."""
    if name not in BACKENDS and name in _LAZY_BACKEND_MODULES:
        import importlib
        importlib.import_module(_LAZY_BACKEND_MODULES[name])
    try:
        return BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; available: "
            f"{sorted(set(BACKENDS) | set(_LAZY_BACKEND_MODULES))}"
            ) from None
