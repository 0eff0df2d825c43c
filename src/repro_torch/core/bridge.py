"""FIFOAdvisor <-> distributed-training bridge.

A pipeline-parallel LM is a dataflow design: stages are tasks, microbatch
activations/gradients flow through bounded queues, and queue capacities
trade pipeline-bubble latency against activation memory — exactly the
latency/BRAM trade-off the paper solves for HLS FIFOs.  This module
compiles a stage graph into a :class:`~repro_torch.core.design.Design` so
the UNMODIFIED FIFOAdvisor machinery (trace -> incremental sim -> Pareto DSE)
sizes the queues.

Stage costs can come from a roofline estimate (``per_layer_flops /
peak FLOP/s`` -> cycles at some clock); the reference package's
``examples/pipeline_buffer_sizing.py`` derives them from its dry-run.

The schedule modelled is GPipe-style (all-forward then all-backward per
stage, FIFO queues for both directions); the "memory" objective reuses
f_bram as a stand-in for per-queue buffer cost with ``width`` = bytes per
microbatch activation (scaled).  This is an analogy-level application of
the paper — but every number is derived, not invented.  Pure numpy and
Python: it builds a :class:`Design` and never touches a device.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

from repro_torch.core.design import Design


@dataclasses.dataclass
class PipelineStage:
    name: str
    fwd_cycles: int
    bwd_cycles: int


def pipeline_design(stages: Sequence[PipelineStage], n_microbatches: int,
                    act_width: int = 512, grad_width: int = 512,
                    stash_width: int = 4096) -> Design:
    """Build the dataflow design of a microbatched fwd/bwd pipeline.

    Per stage boundary: ``act_i`` carries stage i -> i+1 activations and
    ``grad_i`` carries i+1 -> i gradients (one element per microbatch).
    Per stage: ``stash_i`` holds the activations stage i must keep for its
    OWN backward — its depth is the pipeline-memory knob: depth
    n_microbatches reproduces GPipe (all-forward run-ahead), depth ~1
    throttles the forward sweep into a 1F1B-like schedule.  FIFOAdvisor's
    latency/memory frontier over these queues IS the microbatch-schedule
    spectrum.

    Forward tasks are declared first and backward tasks in reverse stage
    order, so the design is sequentially executable (traceable).
    """
    S = len(stages)
    d = Design(f"pipeline_{S}stage_{n_microbatches}mb")
    for i in range(S):
        d.fifo(f"stash_{i}", width=stash_width, group="stash")
    for i in range(S - 1):
        d.fifo(f"act_{i}", width=act_width, group="act")
        d.fifo(f"grad_{i}", width=grad_width, group="grad")

    def make_fwd(i: int, st: PipelineStage):
        def prog(ctx, i=i, st=st):
            for m in range(n_microbatches):
                if i > 0:
                    yield ctx.read(f"act_{i - 1}")
                yield ctx.delay(st.fwd_cycles)
                yield ctx.write(f"stash_{i}", m)
                if i < S - 1:
                    yield ctx.write(f"act_{i}", m)
        return prog

    def make_bwd(i: int, st: PipelineStage):
        def prog(ctx, i=i, st=st):
            for m in range(n_microbatches):
                if i < S - 1:
                    yield ctx.read(f"grad_{i}")
                yield ctx.read(f"stash_{i}")
                yield ctx.delay(st.bwd_cycles)
                if i > 0:
                    yield ctx.write(f"grad_{i - 1}", m)
        return prog

    for i, st in enumerate(stages):
        d.add_task(f"{st.name}_fwd", make_fwd(i, st))
    for i in reversed(range(S)):
        d.add_task(f"{stages[i].name}_bwd", make_bwd(i, stages[i]))
    return d


def stages_from_layer_cost(n_stages: int, layers_per_stage: int,
                           cycles_per_layer: int,
                           bwd_ratio: float = 2.0,
                           imbalance: Optional[Sequence[float]] = None
                           ) -> List[PipelineStage]:
    """Derive stage costs (e.g. cycles_per_layer from the dry-run's
    per-layer FLOPs / chip peak at some clock)."""
    out = []
    for i in range(n_stages):
        scale = imbalance[i] if imbalance else 1.0
        fwd = max(1, int(layers_per_stage * cycles_per_layer * scale))
        out.append(PipelineStage(f"stage{i}", fwd,
                                 max(1, int(fwd * bwd_ratio))))
    return out
