"""FIFOAdvisor optimizers (paper §III-D) ported so far.

The reference's ``greedy``, ``nsga2`` and ``vmap_search`` wait for ROADMAP
P7.
"""

from repro_torch.core.optimizers.base import (EvalContext, EvalRequest,
                                              Optimizer, OptResult)
from repro_torch.core.optimizers.random_search import (GroupedRandomSearch,
                                                       RandomSearch)
from repro_torch.core.optimizers.annealing import (GroupedSimulatedAnnealing,
                                                   SimulatedAnnealing)

OPTIMIZERS = {
    "random": RandomSearch,
    "grouped_random": GroupedRandomSearch,
    "sa": SimulatedAnnealing,
    "grouped_sa": GroupedSimulatedAnnealing,
}

__all__ = [
    "EvalContext", "EvalRequest", "Optimizer", "OptResult", "OPTIMIZERS",
    "RandomSearch", "GroupedRandomSearch", "SimulatedAnnealing",
    "GroupedSimulatedAnnealing",
]
