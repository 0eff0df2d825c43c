"""Parity of the port's remaining optimizers and advisor surfaces with
the reference package: ``greedy``, ``nsga2`` and ``vmap_search`` give
the reference's history (configs, latency, BRAM, deadlock flags and the
batch length of every step), frontier and hypervolume exactly, with and
without each pruning flag; ``run_all`` equals the reference's key by
key; a restored advisor equals a fresh one.

The port runs its kernel backend (``backend="cuda"`` on ``device="cpu"``:
the kernels' plain torch versions), the reference its numpy worklist."""

import json

import numpy as np
import pytest
import torch

from repro.core import EvalConfig as RefEvalConfig
from repro.core import FifoAdvisor as RefAdvisor
from repro.core.optimizers import OPTIMIZERS as REF_OPTIMIZERS
from repro.core.optimizers import PAPER_OPTIMIZERS as REF_PAPER_OPTIMIZERS
from repro.designs import flowgnn_pna as ref_flowgnn_pna
from repro.designs import make_design as ref_make_design

from repro_torch.core import DseResult, EvalConfig, FifoAdvisor
from repro_torch.core.optimizers import OPTIMIZERS, PAPER_OPTIMIZERS
from repro_torch.designs import flowgnn_pna, make_design


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain kernels run many tiny torch ops; with several test
    workers on one host, torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FLAGS = ("local_bounds", "channel_bounds", "certified_floor")
DESIGNS = {
    "gemm": (lambda: ref_make_design("gemm"), lambda: make_design("gemm")),
    "flowgnn_pna_24": (lambda: ref_flowgnn_pna(n_nodes=24, n_edges=64),
                       lambda: flowgnn_pna(n_nodes=24, n_edges=64)),
}


def _advisors(design, flags):
    ref_factory, factory = DESIGNS[design]
    kw = {f: True for f in flags}
    ref = RefAdvisor(ref_factory(), RefEvalConfig(backend="numpy", **kw))
    port = FifoAdvisor(factory(), EvalConfig(backend="cuda", **kw),
                       device="cpu")
    return port, ref


def _drive(adv, registry, name, budget, seed):
    """One search through a stepwise context: (history, DseResult)."""
    ctx = adv.make_context(seed)
    res = registry[name](ctx, budget=budget).run()
    dse = DseResult(design_name=adv.design.name, optimizer=name, result=res,
                    baseline_max=adv.baseline_max,
                    baseline_min=adv.baseline_min, trace_time_s=0.0)
    return ctx.history(), dse


def _assert_dse_equal(got, want):
    for k in ("configs", "latency", "bram", "deadlock"):
        a, b = getattr(got.result, k), getattr(want.result, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert got.result.n_evals == want.result.n_evals
    np.testing.assert_array_equal(got.frontier_points, want.frontier_points)
    np.testing.assert_array_equal(got.frontier_configs,
                                  want.frontier_configs)
    assert got.hypervolume() == want.hypervolume()
    s, r = got.summary(), want.summary()
    for k in ("runtime_s", "trace_time_s"):
        s.pop(k), r.pop(k)
    assert s == r


@pytest.mark.parametrize("flags", [(), *((f,) for f in FLAGS), FLAGS],
                         ids=["none", *FLAGS, "all"])
@pytest.mark.parametrize("design", sorted(DESIGNS))
@pytest.mark.parametrize("name", ["greedy", "nsga2", "vmap_search"])
def test_search_equals_reference(name, design, flags):
    port, ref = _advisors(design, flags)
    got_hist, got = _drive(port, OPTIMIZERS, name, budget=200, seed=1)
    want_hist, want = _drive(ref, REF_OPTIMIZERS, name, budget=200, seed=1)
    for a, b, k in zip(got_hist, want_hist,
                       ("configs", "lat", "bram", "dead", "steps")):
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    _assert_dse_equal(got, want)
    assert got.result.n_evals > 0
    if "certified_floor" in flags:
        assert not got.result.deadlock.any()


def test_registries_match_reference():
    assert sorted(OPTIMIZERS) == sorted(REF_OPTIMIZERS)
    assert PAPER_OPTIMIZERS == REF_PAPER_OPTIMIZERS
    for name, cls in OPTIMIZERS.items():
        assert cls.name == REF_OPTIMIZERS[name].name == name


def test_run_all_equals_reference():
    port, ref = _advisors("gemm", FLAGS)
    got, want = port.run_all(budget=120, seed=2), ref.run_all(budget=120,
                                                              seed=2)
    assert list(got) == list(want) == list(PAPER_OPTIMIZERS)
    for k in got:
        _assert_dse_equal(got[k], want[k])
    sub = port.run_all(["nsga2", "vmap_search"], budget=60)
    assert list(sub) == ["nsga2", "vmap_search"]


def test_advisor_certification_and_bounds_equal_reference():
    port, ref = _advisors("flowgnn_pna_24", FLAGS)
    np.testing.assert_array_equal(port.min_safe_depths(),
                                  ref.min_safe_depths())
    for k in ("depths", "start", "latency", "bram", "n_probes",
              "n_cache_hits"):
        a, b = getattr(port.certification, k), getattr(ref.certification, k)
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert port.channel_bounds().to_dict() == ref.channel_bounds().to_dict()
    np.testing.assert_array_equal(port._lb_cache, ref._lb_cache)
    for b in ("baseline_max", "baseline_min"):
        a, r = getattr(port, b), getattr(ref, b)
        assert (a.latency, a.bram, a.deadlocked) == \
            (r.latency, r.bram, r.deadlocked)
    depths = np.ones(port.graph.n_fifos, dtype=np.int64)
    assert port.explain_deadlock(depths).blame() == \
        ref.explain_deadlock(depths).blame()


def test_restored_advisor_equals_fresh():
    """A restored advisor (trace, graph, rungs, certification, bounds and
    the evaluation cache handed in) gives the fresh advisor's results, and
    re-runs of cached rows cost no evaluation."""
    fresh, _ = _advisors("gemm", FLAGS)
    first = fresh.run("grouped_sa", budget=80, seed=0)
    rungs = [cg for cg, _ in fresh.evaluator.condensation]
    restored = FifoAdvisor.restore(
        fresh.design, trace=fresh.trace, graph=fresh.graph,
        config=fresh.config, rungs=rungs, baseline_max=fresh.baseline_max,
        baseline_min=fresh.baseline_min,
        certification=fresh.certification, lb_cache=fresh._lb_cache,
        cache_data=(first.result.configs, first.result.latency,
                    first.result.bram, first.result.deadlock),
        device="cpu")
    assert restored.evaluator.condensation_info() == \
        fresh.evaluator.condensation_info()
    np.testing.assert_array_equal(restored.min_safe_depths(),
                                  fresh.min_safe_depths())
    again = restored.run("grouped_sa", budget=80, seed=0)
    for k in ("configs", "latency", "bram", "deadlock"):
        np.testing.assert_array_equal(getattr(again.result, k),
                                      getattr(first.result, k))
    assert again.hypervolume() == first.hypervolume()
    assert again.result.n_evals == 0
    assert restored.evaluator.stats.n_configs == 0
    assert restored.channel_bounds().to_dict() == \
        fresh.channel_bounds().to_dict()
    # uncached rows are evaluated as on the fresh advisor
    more = restored.run("nsga2", budget=60, seed=5)
    want = fresh.run("nsga2", budget=60, seed=5)
    for k in ("configs", "latency", "bram", "deadlock"):
        np.testing.assert_array_equal(getattr(more.result, k),
                                      getattr(want.result, k))


def test_eval_config_round_trips_with_pruning_flags():
    cfg = EvalConfig(backend="cuda", local_bounds=True, channel_bounds=True,
                     certified_floor=True)
    d = cfg.to_dict()
    assert EvalConfig.from_dict(json.loads(json.dumps(d))) == cfg
    ref = RefEvalConfig(backend="pallas", local_bounds=True,
                        channel_bounds=True, certified_floor=True)
    assert EvalConfig.from_dict(ref.to_dict()).to_dict() == ref.to_dict()
    for field, value in (("shards", 2), ("faults", "{}")):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            cfg.replace(**{field: value})
