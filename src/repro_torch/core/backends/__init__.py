"""Evaluation-backend subsystem of the port.

One shared operand layer (:mod:`.operands`, torch), the
:class:`.EvalBackend` protocol with a registry, three exact
implementations (numpy worklist, plain torch fixpoint, the CUDA kernels),
the :class:`.DispatchPolicy` (bucketing + UNRESOLVED-row escalation), the
:class:`.RungCascade`, the cross-design :class:`.HeteroDispatcher`, the
vectorized :class:`.ConfigCache`, and the incremental re-simulation fast
path (:func:`.solve_delta`).

The torch-backed modules (operands, fixpoint, pallas) load on first use,
so the numpy worklist path imports without torch.
"""

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

__all__ = [
    "BACKENDS", "BIG", "BUCKETS", "CONVERGED", "CacheStats", "ConfigCache",
    "DEADLOCK", "DispatchPolicy", "EvalBackend", "F32_EXACT_LIMIT",
    "HeteroDispatcher", "HeteroStats", "IncrementalStats", "RungCascade",
    "UNRESOLVED", "WorklistBackend", "WorklistState", "affected_segments",
    "available_backends", "evaluate_np", "get_backend", "register_backend",
    "resolve_device",
    "solve", "solve_delta",
]
