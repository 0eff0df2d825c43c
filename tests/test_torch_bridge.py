"""The port's pipeline-parallel bridge against the reference package.

``pipeline_design`` and ``stages_from_layer_cost`` build the same stage
list, the same :class:`Design` (name, FIFOs with widths and groups, tasks
in order) and, traced, the same SimGraph as the reference, array for
array; the pipeline trade-off and the advisor's frontier on it are the
reference's exactly (the port's advisor on ``backend="cuda"``,
``device="cpu"``: the kernels' plain versions)."""

import dataclasses

import numpy as np
import pytest

from repro.core import FifoAdvisor as RefAdvisor
from repro.core.bridge import pipeline_design as ref_pipeline_design
from repro.core.bridge import stages_from_layer_cost as ref_stages
from repro.core.oracle import simulate as ref_simulate
from repro.core.simgraph import build_simgraph as ref_build_simgraph

from repro_torch.core import EvalConfig, FifoAdvisor
from repro_torch.core.bridge import (PipelineStage, pipeline_design,
                                     stages_from_layer_cost)
from repro_torch.core.oracle import simulate
from repro_torch.core.simgraph import SimGraph, build_simgraph
from repro_torch.core.tracer import collect_trace

#: (n_stages, layers_per_stage, cycles_per_layer, imbalance, microbatches)
CASES = [(4, 2, 10, None, 8),
         (4, 2, 10, [1.0, 2.0, 1.0, 0.5], 16),
         (4, 2, 12, [1.0, 1.5, 0.75, 1.0], 12),
         (2, 3, 7, [1.3, 0.6], 5)]


def both(s, l, c, imb, m):
    got = pipeline_design(stages_from_layer_cost(s, l, c, imbalance=imb),
                          n_microbatches=m)
    want = ref_pipeline_design(ref_stages(s, l, c, imbalance=imb),
                               n_microbatches=m)
    return got, want


@pytest.mark.parametrize("case", CASES)
def test_design_and_simgraph_equal_reference(case):
    s, l, c, imb, m = case
    assert [dataclasses.astuple(x) for x in
            stages_from_layer_cost(s, l, c, imbalance=imb)] == \
        [dataclasses.astuple(x) for x in ref_stages(s, l, c, imbalance=imb)]
    got, want = both(*case)
    assert got.name == want.name
    assert [dataclasses.astuple(f) for f in got.fifos] == \
        [dataclasses.astuple(f) for f in want.fifos]
    assert [(t.name, t.index, t.data_dependent) for t in got.tasks] == \
        [(t.name, t.index, t.data_dependent) for t in want.tasks]
    g, rg = build_simgraph(got), ref_build_simgraph(want)
    for f in dataclasses.fields(SimGraph):
        if f.name == "design":
            continue
        x, y = getattr(g, f.name), getattr(rg, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def test_pipeline_design_traces_and_runs():
    S, M = 4, 8
    d = pipeline_design(stages_from_layer_cost(S, layers_per_stage=2,
                                               cycles_per_layer=10),
                        n_microbatches=M)
    assert collect_trace(d).n_events == M * (6 * S - 4)
    r = simulate(d, [M] * d.n_fifos)
    assert not r.deadlocked
    assert PipelineStage("x", 1, 2).bwd_cycles == 2


def test_deeper_queues_reduce_bubble_latency():
    got, want = both(4, 2, 10, [1.0, 2.0, 1.0, 0.5], 16)
    lat = {}
    for depth in (1, 16):
        r = simulate(got, [depth] * got.n_fifos)
        rr = ref_simulate(want, [depth] * want.n_fifos)
        assert (r.latency, r.deadlocked) == (rr.latency, rr.deadlocked)
        assert not r.deadlocked
        lat[depth] = r.latency
    assert lat[16] < lat[1]


def test_advisor_finds_pipeline_frontier():
    got, want = both(4, 2, 12, [1.0, 1.5, 0.75, 1.0], 12)
    r = FifoAdvisor(got, EvalConfig(backend="cuda", max_iters=64),
                    device="cpu").run("grouped_sa", budget=200, seed=0)
    rr = RefAdvisor(want).run("grouped_sa", budget=200, seed=0)
    for f in ("configs", "latency", "bram", "deadlock"):
        np.testing.assert_array_equal(getattr(r.result, f),
                                      getattr(rr.result, f))
    np.testing.assert_array_equal(r.frontier_points, rr.frontier_points)
    assert r.hypervolume() == rr.hypervolume()
    pts = r.frontier_points
    assert pts.shape[0] >= 1
    if pts.shape[0] > 1:
        assert pts[:, 0].min() < pts[:, 0].max()
