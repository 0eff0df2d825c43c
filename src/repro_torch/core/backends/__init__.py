"""Evaluation-backend subsystem of the port.

One shared operand layer (:mod:`.operands`, torch), the
:class:`.EvalBackend` protocol with a registry, three exact
implementations (numpy worklist, plain torch fixpoint, the CUDA kernels)
and their row sharding over devices (:class:`.MeshBackend`), the
:class:`.DispatchPolicy` (bucketing + UNRESOLVED-row escalation), the
:class:`.RungCascade`, the cross-design :class:`.HeteroDispatcher`, the
vectorized :class:`.ConfigCache`, and the incremental re-simulation fast
path (:func:`.solve_delta`).

The torch-backed modules (operands, fixpoint, pallas, mesh) load on first
use, so the numpy worklist path imports without torch.
"""

import importlib

from repro_torch.core.backends.base import (BACKENDS, BIG, CONVERGED,
                                            DEADLOCK, F32_EXACT_LIMIT,
                                            UNRESOLVED, EvalBackend,
                                            available_backends, get_backend,
                                            register_backend, resolve_device)
from repro_torch.core.backends.cache import CacheStats, ConfigCache
from repro_torch.core.backends.dispatch import (BUCKETS, DispatchPolicy,
                                                HeteroDispatcher, HeteroStats,
                                                RungCascade)
from repro_torch.core.backends.worklist import (IncrementalStats,
                                                WorklistBackend,
                                                WorklistState,
                                                affected_segments,
                                                evaluate_np, solve,
                                                solve_delta)

#: names resolved on attribute access from torch-importing submodules
_LAZY_ATTRS = {
    "MeshBackend": "repro_torch.core.backends.mesh",
}


def __getattr__(name):
    module = _LAZY_ATTRS.get(name)
    if module is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(module), name)


__all__ = [
    "MeshBackend",
    "BACKENDS", "BIG", "BUCKETS", "CONVERGED", "CacheStats", "ConfigCache",
    "DEADLOCK", "DispatchPolicy", "EvalBackend", "F32_EXACT_LIMIT",
    "HeteroDispatcher", "HeteroStats", "IncrementalStats", "RungCascade",
    "UNRESOLVED", "WorklistBackend", "WorklistState", "affected_segments",
    "available_backends", "evaluate_np", "get_backend", "register_backend",
    "resolve_device",
    "solve", "solve_delta",
]
