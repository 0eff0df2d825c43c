"""End-to-end parity of the port's evaluator and advisor: the kernel
backend (``backend="cuda"`` on ``device="cpu"``, i.e. the kernels' plain
torch versions behind the full cascade) equals the reference package's
evaluator row for row — results AND routing statistics — and the
``grouped_sa`` search gives the reference's history, frontier and
hypervolume exactly."""

import numpy as np
import pytest

from repro.core import FifoAdvisor as RefAdvisor
from repro.core.config import EvalConfig as RefEvalConfig
from repro.core.simgraph import build_simgraph as ref_build_simgraph
from repro.core.simulate import BatchedEvaluator as RefEvaluator
from repro.designs import make_design as ref_make_design
from repro.designs import mult_by_2 as ref_mult_by_2

from repro_torch.core import FifoAdvisor
from repro_torch.core.config import EvalConfig
from repro_torch.core.simgraph import build_simgraph
from repro_torch.core.simulate import BatchedEvaluator
from repro_torch.designs import make_design, mult_by_2

_STATS = ("n_configs", "n_fallbacks", "n_dedup", "n_condensed",
          "n_cond_fail")


def _assert_same(port_ev, ref_ev, cfgs):
    got, want = port_ev.evaluate(cfgs), ref_ev.evaluate(cfgs)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for k in _STATS:
        assert getattr(port_ev.stats, k) == getattr(ref_ev.stats, k), k


@pytest.mark.parametrize("backend,ref_backend", [
    ("cuda", "pallas"), ("fixpoint", "jax"), ("numpy", "numpy")])
def test_cascade_equals_reference_on_gemm(backend, ref_backend):
    """The rows of the reference's own cascade end-to-end test: all-1
    (deadlock), the upper bounds, and random rows in [1, u]."""
    ref_g = ref_build_simgraph(ref_make_design("gemm"))
    g = build_simgraph(make_design("gemm"))
    rng = np.random.default_rng(7)
    u = np.asarray(g.upper_bounds, dtype=np.int64)
    cfgs = np.stack([np.ones_like(u), u] +
                    [rng.integers(1, u + 1) for _ in range(6)])
    port = BatchedEvaluator(g, EvalConfig(backend=backend, max_iters=64),
                            device="cpu")
    ref = RefEvaluator(ref_g, RefEvalConfig(backend=ref_backend,
                                            max_iters=64))
    assert [cg.tag for cg, _ in port.condensation] == \
        [cg.tag for cg, _ in ref.condensation]
    _assert_same(port, ref, cfgs)


def test_raw_backstop_and_escalation_equal_reference():
    """mult_by_2's rungs reject most rows, which then take the raw K2
    path; at a cap of 2 the rows UNRESOLVED there escalate to the
    worklist, exactly as in the reference."""
    ref_g = ref_build_simgraph(ref_mult_by_2(24))
    g = build_simgraph(mult_by_2(24))
    rng = np.random.default_rng(3)
    cfgs = np.stack([rng.integers(2, 30, size=2) for _ in range(12)])
    for cap in (2, 128):
        port = BatchedEvaluator(g, EvalConfig(backend="cuda", max_iters=cap),
                                device="cpu")
        ref = RefEvaluator(ref_g, RefEvalConfig(backend="pallas",
                                                max_iters=cap))
        _assert_same(port, ref, cfgs)
        if cap == 2:
            assert port.stats.n_fallbacks > 0


def test_grouped_sa_frontier_equals_reference_on_gemm():
    port = FifoAdvisor(make_design("gemm"), EvalConfig(backend="cuda"),
                       device="cpu")
    ref = RefAdvisor(ref_make_design("gemm"),
                     RefEvalConfig(backend="numpy"))
    for b in ("baseline_max", "baseline_min"):
        a, r = getattr(port, b), getattr(ref, b)
        assert (a.latency, a.bram, a.deadlocked) == \
            (r.latency, r.bram, r.deadlocked)
    got = port.run("grouped_sa", budget=150, seed=0)
    want = ref.run("grouped_sa", budget=150, seed=0)
    np.testing.assert_array_equal(got.frontier_points, want.frontier_points)
    np.testing.assert_array_equal(got.frontier_configs,
                                  want.frontier_configs)
    assert got.hypervolume() == want.hypervolume()
    assert got.result.n_evals == want.result.n_evals
    for k in ("configs", "latency", "bram", "deadlock"):
        np.testing.assert_array_equal(getattr(got.result, k),
                                      getattr(want.result, k))
    assert port.evaluator.stats.n_configs > 0
