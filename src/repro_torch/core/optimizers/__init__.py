"""FIFOAdvisor optimizer zoo (paper §III-D + beyond-paper additions)."""

from repro_torch.core.optimizers.base import (EvalContext, EvalRequest,
                                              Optimizer, OptResult)
from repro_torch.core.optimizers.random_search import (GroupedRandomSearch,
                                                       RandomSearch)
from repro_torch.core.optimizers.annealing import (GroupedSimulatedAnnealing,
                                                   SimulatedAnnealing)
from repro_torch.core.optimizers.greedy import GreedySearch
from repro_torch.core.optimizers.nsga2 import NSGA2
from repro_torch.core.optimizers.vmap_search import VmapSearch

OPTIMIZERS = {
    "random": RandomSearch,
    "grouped_random": GroupedRandomSearch,
    "sa": SimulatedAnnealing,
    "grouped_sa": GroupedSimulatedAnnealing,
    "greedy": GreedySearch,
    "nsga2": NSGA2,
    "vmap_search": VmapSearch,
}

PAPER_OPTIMIZERS = ("greedy", "random", "grouped_random", "sa", "grouped_sa")

__all__ = [
    "EvalContext", "EvalRequest", "Optimizer", "OptResult", "OPTIMIZERS",
    "PAPER_OPTIMIZERS", "RandomSearch", "GroupedRandomSearch",
    "SimulatedAnnealing", "GroupedSimulatedAnnealing", "GreedySearch",
    "NSGA2", "VmapSearch",
]
