"""Parity of the port's deadlock machinery with the reference package:
the DES oracle, the wait-for graph, channel bounds, pair pruning and
certification give exactly the reference's answers on the same designs
and depth rows (exact equality — all integers and names).

Certification runs on the port's kernel backend (``backend="cuda"`` on
``device="cpu"``: the kernels' plain torch versions behind the full
cascade) and on its plain ``fixpoint`` backend, against the reference's
numpy worklist, and on one design with a small iteration cap against the
reference's ``pallas`` (interpret mode) and ``jax`` backends, routing
counts included."""

import numpy as np
import pytest
import torch

from repro.core import EvalConfig as RefEvalConfig
from repro.core import FifoAdvisor as RefAdvisor
from repro.core.bounds import channel_bounds as ref_channel_bounds
from repro.core.deadlock import certify_min_depths as ref_certify
from repro.core.deadlock import certify_min_depths_oracle as ref_certify_oracle
from repro.core.deadlock import deadlock_blame as ref_deadlock_blame
from repro.core.deadlock import extract_wait_graph as ref_extract_wait_graph
from repro.core.deadlock import fifo_endpoints as ref_fifo_endpoints
from repro.core.optimizers import EvalContext as RefEvalContext
from repro.core.oracle import batch_simulate as ref_batch_simulate
from repro.core.oracle import simulate as ref_simulate
from repro.core.prune import local_lower_bounds as ref_local_lower_bounds
from repro.core.prune import task_pairs as ref_task_pairs
from repro.core.simgraph import build_simgraph as ref_build_simgraph
from repro.core.simulate import BatchedEvaluator as RefEvaluator
from repro.core.tracer import collect_trace as ref_collect_trace
from repro.designs import flowgnn_pna as ref_flowgnn_pna
from repro.designs import generate_design as ref_generate_design
from repro.designs import make_design as ref_make_design
from repro.designs import mult_by_2 as ref_mult_by_2

from repro_torch.core import EvalConfig, FifoAdvisor
from repro_torch.core.bounds import (DATA_DEPENDENT, INORDER_MATCHED,
                                     INORDER_MISMATCHED, REORDER,
                                     channel_bounds)
from repro_torch.core.deadlock import (certify_min_depths,
                                       certify_min_depths_oracle,
                                       deadlock_blame, extract_wait_graph,
                                       fifo_endpoints)
from repro_torch.core.optimizers import EvalContext
from repro_torch.core.oracle import batch_simulate, simulate
from repro_torch.core.prune import local_lower_bounds, task_pairs
from repro_torch.core.simgraph import build_simgraph
from repro_torch.core.simulate import BatchedEvaluator
from repro_torch.core.tracer import collect_trace
from repro_torch.designs import (flowgnn_pna, generate_design, make_design,
                                 mult_by_2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain kernels run many tiny torch ops; with several test
    workers on one host, torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Ref:
    make_design = staticmethod(ref_make_design)
    mult_by_2 = staticmethod(ref_mult_by_2)
    flowgnn_pna = staticmethod(ref_flowgnn_pna)
    generate_design = staticmethod(ref_generate_design)


class _Port:
    make_design = staticmethod(make_design)
    mult_by_2 = staticmethod(mult_by_2)
    flowgnn_pna = staticmethod(flowgnn_pna)
    generate_design = staticmethod(generate_design)


# (id, factory) of the designs every comparison runs on: the Stream-HLS
# designs the reference's own bounds and pruning tests use, the paper's
# two DDCF designs, and generated seeds (quick and full size) chosen
# among those that deadlock at depth 1
SMALL = [
    ("mult_by_2_16", lambda m: m.mult_by_2(16)),
    ("flowgnn_pna_24", lambda m: m.flowgnn_pna(n_nodes=24, n_edges=64)),
    ("gen6q", lambda m: m.generate_design(6, quick=True).design),
    ("gen17q", lambda m: m.generate_design(17, quick=True).design),
    ("gen13", lambda m: m.generate_design(13).design),
]
STREAMHLS = [(n, (lambda n: lambda m: m.make_design(n))(n))
             for n in ("gemm", "mvt", "atax", "k2mm", "FeedForward",
                       "k15mmtree")]


def _both(factory):
    return factory(_Ref), factory(_Port)


def _rows(g, n, seed):
    """All-ones, the upper bounds, and ``n`` rows drawn from
    ``np.random.default_rng(seed)`` in [1, u]."""
    rng = np.random.default_rng(seed)
    u = np.asarray(g.upper_bounds, dtype=np.int64)
    return np.stack([np.ones_like(u), u]
                    + [rng.integers(1, u + 1) for _ in range(n)])


# ------------------------------------------------------------------ oracle
@pytest.mark.parametrize("name,factory", SMALL, ids=[s[0] for s in SMALL])
def test_simulate_and_wait_graph_equal_reference(name, factory):
    ref_d, d = _both(factory)
    g = build_simgraph(d)
    rows = _rows(g, 6, seed=11)
    n_dead = 0
    for row in rows:
        got, want = simulate(d, row), ref_simulate(ref_d, row)
        assert (got.latency, got.deadlocked) == \
            (want.latency, want.deadlocked)
        assert got.blocked_tasks == want.blocked_tasks
        assert got.blocked_ops == want.blocked_ops
        assert got.results == want.results
        wg = extract_wait_graph(d, got)
        ref_wg = ref_extract_wait_graph(ref_d, want)
        assert [(e.waiter, e.holder, e.fifo, e.reason) for e in wg.edges] \
            == [(e.waiter, e.holder, e.fifo, e.reason)
                for e in ref_wg.edges]
        assert wg.cycles() == ref_wg.cycles()
        assert wg.blame() == ref_wg.blame()
        assert wg.describe() == ref_wg.describe()
        assert deadlock_blame(d, row) == ref_deadlock_blame(ref_d, row)
        n_dead += got.deadlocked
    assert n_dead > 0       # the all-ones row deadlocks on every design
    lat, dead = batch_simulate(d, rows)
    ref_lat, ref_dead = ref_batch_simulate(ref_d, rows)
    np.testing.assert_array_equal(lat, ref_lat)
    np.testing.assert_array_equal(dead, ref_dead)
    for a, b in zip(fifo_endpoints(collect_trace(d)),
                    ref_fifo_endpoints(ref_collect_trace(ref_d))):
        np.testing.assert_array_equal(a, b)


def test_undersized_mult_by_2_blames_both_channels():
    d = mult_by_2(16)
    assert deadlock_blame(d, [2, 2]) == ["x", "y"]
    assert deadlock_blame(d, [15, 1]) == []
    wg = extract_wait_graph(d, simulate(d, [3, 3]))
    assert wg.cycles() == [["consumer", "producer"]]
    adv = FifoAdvisor(d, EvalConfig(backend="cuda"), device="cpu")
    assert adv.explain_deadlock([2, 2]).blame() == ["x", "y"]
    assert adv.explain_deadlock([15, 1]).edges == []


# ----------------------------------------------------------- bounds, prune
@pytest.mark.parametrize("name,factory", STREAMHLS + SMALL,
                         ids=[s[0] for s in STREAMHLS + SMALL])
def test_bounds_and_pruning_equal_reference(name, factory):
    ref_d, d = _both(factory)
    g, ref_g = build_simgraph(d), ref_build_simgraph(ref_d)
    got, want = channel_bounds(g), ref_channel_bounds(ref_g)
    for k in ("lower", "upper", "slack"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert got.kinds == want.kinds
    assert set(got.kinds) <= {INORDER_MATCHED, INORDER_MISMATCHED, REORDER,
                              DATA_DEPENDENT}
    assert got.to_dict() == want.to_dict()
    assert task_pairs(g) == ref_task_pairs(ref_g)
    cand = EvalContext(g, BatchedEvaluator(
        g, EvalConfig(backend="numpy"))).candidates
    ref_cand = RefEvalContext(ref_g).candidates
    lb = local_lower_bounds(g, cand)
    ref_lb = ref_local_lower_bounds(ref_g, ref_cand)
    assert lb.dtype == ref_lb.dtype
    np.testing.assert_array_equal(lb, ref_lb)


def test_pruning_removes_candidates_on_k15mmtree():
    """The reorder hazard design is where pair pruning bites."""
    g = build_simgraph(make_design("k15mmtree"))
    ctx = EvalContext(g, BatchedEvaluator(g, EvalConfig(backend="numpy")))
    lb = local_lower_bounds(g, ctx.candidates)
    assert (lb > 2).any()


# ---------------------------------------------------------- certification
_RESULT = ("depths", "start", "latency", "bram", "n_probes",
           "n_cache_hits")


def _assert_cert_equal(got, want):
    for k in _RESULT:
        a, b = getattr(got, k), getattr(want, k)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            assert a == b, k


CERT_DESIGNS = [
    ("mult_by_2_24", lambda m: m.mult_by_2(24)),
    ("flowgnn_pna_24", lambda m: m.flowgnn_pna(n_nodes=24, n_edges=64)),
    ("gemm", lambda m: m.make_design("gemm")),
    ("mvt", lambda m: m.make_design("mvt")),
    ("gen14q", lambda m: m.generate_design(14, quick=True).design),
    ("gen13", lambda m: m.generate_design(13).design),
]


@pytest.mark.parametrize("backend", ["cuda", "fixpoint"])
@pytest.mark.parametrize("name,factory", CERT_DESIGNS,
                         ids=[s[0] for s in CERT_DESIGNS])
def test_certification_equals_reference(name, factory, backend):
    """Seeded (the advisor's ``min_safe_depths``, through its cache) and
    unseeded certification, and the oracle certifier."""
    ref_d, d = _both(factory)
    adv = FifoAdvisor(d, EvalConfig(backend=backend), device="cpu")
    ref = RefAdvisor(ref_d, RefEvalConfig(backend="numpy"))
    np.testing.assert_array_equal(adv.min_safe_depths(),
                                  ref.min_safe_depths())
    _assert_cert_equal(adv.certification, ref.certification)
    got = certify_min_depths(adv.graph, adv.evaluator)
    want = ref_certify(ref.graph, ref.evaluator)
    _assert_cert_equal(got, want)
    np.testing.assert_array_equal(got.depths, adv.min_safe_depths())
    if name != "gemm":        # the DES is slow on the largest design
        oracle = certify_min_depths_oracle(d)
        _assert_cert_equal(oracle, ref_certify_oracle(ref_d))
        np.testing.assert_array_equal(oracle.depths, got.depths)
        assert oracle.n_probes == got.n_probes


@pytest.mark.parametrize("cap", [2, 8])
@pytest.mark.parametrize("backend,ref_backend", [("cuda", "pallas"),
                                                 ("fixpoint", "jax")])
def test_certification_routing_counts_equal_reference(backend, ref_backend,
                                                      cap):
    """gemm certified from its declared upper bounds, seeded: the first
    probe lies inside the routing box, so it goes to the rungs.  At an
    iteration cap of 8 the aggressive rung certifies it; at 2 both rungs
    fail and rows escalate to the worklist.  Results and the evaluator's
    routing counts equal the reference's."""
    g = build_simgraph(make_design("gemm"))
    ref_g = ref_build_simgraph(ref_make_design("gemm"))
    ev = BatchedEvaluator(g, EvalConfig(backend=backend, max_iters=cap),
                          device="cpu")
    ref_ev = RefEvaluator(ref_g, RefEvalConfig(backend=ref_backend,
                                               max_iters=cap))
    u = np.asarray(g.upper_bounds, dtype=np.int64)
    got = certify_min_depths(g, ev, upper=u, bounds=channel_bounds(g))
    want = ref_certify(ref_g, ref_ev, upper=u,
                       bounds=ref_channel_bounds(ref_g))
    _assert_cert_equal(got, want)
    for k in ("n_configs", "n_fallbacks", "n_condensed", "n_cond_fail"):
        assert getattr(ev.stats, k) == getattr(ref_ev.stats, k), k
    if cap == 2:
        assert ev.stats.n_cond_fail > 0 and ev.stats.n_fallbacks > 0
    else:
        assert ev.stats.n_condensed > 0


@pytest.mark.parametrize("n", [2, 3, 8, 17, 40])
def test_mult_by_2_certifies_to_the_papers_answer(n):
    adv = FifoAdvisor(mult_by_2(n), EvalConfig(backend="cuda"),
                      device="cpu")
    assert adv.min_safe_depths().tolist() == [max(n - 1, 1), 1]
    got = certify_min_depths(adv.graph, adv.evaluator)
    assert got.depths.tolist() == [max(n - 1, 1), 1]


def test_infeasible_start_raises_as_reference():
    adv = FifoAdvisor(mult_by_2(16), EvalConfig(backend="cuda"),
                      device="cpu")
    with pytest.raises(ValueError, match="start vector deadlocks"):
        certify_min_depths(adv.graph, adv.evaluator, upper=np.array([2, 2]))
    with pytest.raises(ValueError):
        FifoAdvisor(mult_by_2(64), EvalConfig(backend="cuda",
                                              certified_floor=True),
                    upper_bounds=np.array([16, 16]), device="cpu")
