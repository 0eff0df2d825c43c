"""FIFOAdvisor core of the port: trace, event graph, condensation, batched
evaluation (numpy worklist, plain torch fixpoint, CUDA kernels), the
optimizers, deadlock certification and channel bounds, the DES oracle,
and the advisor.  Campaigns live in :mod:`repro_torch.core.campaign` and
the advisory service in :mod:`repro_torch.core.service`."""

from repro_torch.core.advisor import Baseline, DseResult, FifoAdvisor
from repro_torch.core.backends import (ConfigCache, EvalBackend,
                                       available_backends, get_backend,
                                       register_backend)
from repro_torch.core.condense import (CondensedGraph, condense,
                                       condense_auto, expand_times,
                                       verify_rows)
from repro_torch.core.config import EvalConfig, resolve_config
from repro_torch.core.deadlock import (CertificationResult, WaitForGraph,
                                       certify_min_depths, deadlock_blame,
                                       extract_wait_graph)
from repro_torch.core.design import Design, Fifo, Task
from repro_torch.core.oracle import SimResult, simulate
from repro_torch.core.simgraph import SimGraph, build_simgraph
from repro_torch.core.simulate import BatchedEvaluator, evaluate_np
from repro_torch.core.tracer import Trace, collect_trace

__all__ = [
    "Baseline", "BatchedEvaluator", "CertificationResult", "CondensedGraph",
    "ConfigCache", "Design", "DseResult", "EvalBackend", "EvalConfig", "Fifo",
    "FifoAdvisor", "SimGraph", "SimResult", "Task", "Trace", "WaitForGraph",
    "available_backends", "build_simgraph", "certify_min_depths",
    "collect_trace", "condense", "condense_auto", "deadlock_blame",
    "evaluate_np", "expand_times", "extract_wait_graph", "get_backend",
    "register_backend", "resolve_config", "simulate", "verify_rows",
]
