"""FIFOAdvisor core of the port: trace, event graph, condensation, batched
evaluation (numpy worklist, plain torch fixpoint, CUDA kernels), the
optimizers ported so far, and the advisor."""

from repro_torch.core.advisor import Baseline, DseResult, FifoAdvisor
from repro_torch.core.backends import (ConfigCache, EvalBackend,
                                       get_backend, register_backend)
from repro_torch.core.condense import (CondensedGraph, condense,
                                       condense_auto, expand_times,
                                       verify_rows)
from repro_torch.core.config import EvalConfig
from repro_torch.core.design import Design, Fifo, Task
from repro_torch.core.simgraph import SimGraph, build_simgraph
from repro_torch.core.simulate import BatchedEvaluator, evaluate_np
from repro_torch.core.tracer import Trace, collect_trace

__all__ = [
    "Baseline", "BatchedEvaluator", "CondensedGraph", "ConfigCache",
    "Design", "DseResult", "EvalBackend", "EvalConfig", "Fifo",
    "FifoAdvisor", "SimGraph", "Task", "Trace",
    "build_simgraph", "collect_trace", "condense", "condense_auto",
    "evaluate_np", "expand_times", "get_backend", "register_backend",
    "verify_rows",
]
