"""K1 parity: the port's plain torch version of the fused condensed kernel
(``fifo_eval_condensed_plain``, what the ``fifo_eval_condensed`` wrapper
runs on CPU tensors) equals the reference's Pallas kernel in interpret
mode on lanes 0, 1, 2 and 4 and on the times, for condensed graphs
carried across from the reference with ``repro_torch.core.carry``.  Its
certificate equals the host ``verify_rows``, and a fully-certifying batch
stays one dispatch with the host verifier never called."""

import glob
import importlib
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.backends import operands as ref_ops
from repro.core.condense import condense_auto as ref_condense_auto
from repro.core.simgraph import build_simgraph as ref_build_simgraph
from repro.designs import make_design as ref_make_design
from repro.designs.generate import DesignSpec, build_design
from repro.kernels.fifo_eval.condensed import (
    fifo_eval_condensed as ref_condensed_kernel)
from repro.kernels.fifo_eval.ops import (
    make_condensed_eval as ref_make_condensed_eval)

from repro_torch.core import carry
from repro_torch.core.backends import operands as ops_t
from repro_torch.core.backends.base import CONVERGED
from repro_torch.core.condense import CondensedGraph, verify_rows
from repro_torch.core.config import EvalConfig
from repro_torch.core.simulate import BatchedEvaluator
from repro_torch.kernels.fifo_eval.condensed import fifo_eval_condensed
from repro_torch.kernels.fifo_eval.ref import fifo_eval_condensed_plain
from repro_torch.kernels.fifo_eval.ops import (DISPATCH_COUNTS,
                                               make_condensed_eval)

CPU = torch.device("cpu")
CORPUS_DIR = os.path.join(os.path.dirname(__file__), "fuzz_corpus")
condense_mod = importlib.import_module("repro_torch.core.condense")


def _carried(ref_g):
    """(port raw graph, [(reference rung, port rung)]) for ``ref_g``."""
    g = carry.simgraph_from_arrays(carry.graph_fields(ref_g))
    pairs = [(ref_cg, carry.condensed_from_arrays(
        carry.graph_fields(ref_cg, CondensedGraph), raw=g))
        for ref_cg in ref_condense_auto(ref_g)]
    return g, pairs


def _rows(g, n, seed):
    """all-1 / all-2 / upper-bound corners plus in-box and random rows."""
    rng = np.random.default_rng(seed)
    u = np.asarray(g.upper_bounds, dtype=np.int64)
    rows = [np.ones_like(u), np.full_like(u, 2), u]
    rows += [np.maximum(2, (u * rng.uniform(0.5, 1.0, u.size)).astype(int))
             for _ in range(n)]
    rows += [rng.integers(1, u + 1) for _ in range(n)]
    return np.stack(rows).astype(np.int32)


def _kernel_args(ref_cg, cg, rows):
    r = ref_ops.build_operands(ref_cg)
    r_ct = ref_ops.build_cert_tables(ref_cg)
    p = ops_t.get_operands(cg, CPU)
    p_ct = ops_t.get_cert_tables(cg, CPU)

    def ref_rows(d):
        return (ref_ops.depth_operands(r, d)[:4]
                + ref_ops.cert_row_operands(r, r_ct, d))
    d = torch.as_tensor(rows)
    r_args = ((r.delta, r.seg_start, r.is_read, r.has_data, r.data_idx,
               r.end_bonus) + tuple(jax.jit(ref_rows)(jnp.asarray(rows))))
    p_args = ((p.delta, p.seg_start, p.is_read, p.has_data, p.data_idx,
               p.end_bonus) + ops_t.depth_operands(p, d)[:4]
              + ops_t.cert_row_operands(p, p_ct, d))
    return r.bound, r_args, p_args


def _check_rung(ref_cg, cg, rows, max_iters=64):
    """Plain K1 vs the reference kernel (lanes 0, 1, 2, 4 + times), the
    wrapper on CPU vs plain, and the closure's cert vs verify_rows."""
    bound, r_args, p_args = _kernel_args(ref_cg, cg, rows)
    ref_out, ref_t = ref_condensed_kernel(
        *r_args, max_iters=max_iters, bound=bound, block=rows.shape[0],
        interpret=True, with_times=True)
    out, t = fifo_eval_condensed_plain(*p_args, max_iters=max_iters,
                                       bound=bound, with_times=True)
    lanes = [0, 1, 2, 4]
    np.testing.assert_array_equal(out.numpy()[:, lanes],
                                  np.asarray(ref_out)[:, lanes])
    np.testing.assert_array_equal(t.numpy(), np.asarray(ref_t))
    w_out, w_t = fifo_eval_condensed(*p_args, max_iters=max_iters,
                                     bound=bound, with_times=True)
    assert torch.equal(w_out, out) and torch.equal(w_t, t)

    call = make_condensed_eval(cg, max_iters=max_iters, with_times=True,
                               device="cpu")
    lat, bram, status, cert, times = call(rows)
    ref_call = ref_make_condensed_eval(ref_cg, interpret=True,
                                       max_iters=max_iters, with_times=True)
    for a, b in zip((lat, bram, status, cert, times), ref_call(rows)):
        np.testing.assert_array_equal(a, np.asarray(b))
    expected = np.zeros(rows.shape[0], dtype=bool)
    conv = status == CONVERGED
    if conv.any():
        t_int = np.asarray(np.rint(times), dtype=np.int64)
        expected[conv] = verify_rows(cg, rows[conv].astype(np.int64),
                                     t_int[conv])
    np.testing.assert_array_equal(cert, expected)
    return int(cert.sum())


@pytest.mark.parametrize("name", ["gemm", "FeedForward"])
def test_plain_k1_equals_reference_on_benchmark_rungs(name):
    ref_g = ref_build_simgraph(ref_make_design(name))
    _, pairs = _carried(ref_g)
    ref_cg, cg = pairs[0]
    assert cg.tag == "aggressive" and ops_t.get_cert_tables(cg, CPU)
    n_cert = _check_rung(ref_cg, cg, _rows(cg, 3, seed=1))
    assert n_cert > 0


def test_plain_k1_equals_reference_on_corpus():
    paths = sorted(glob.glob(os.path.join(CORPUS_DIR, "*.json")))
    assert paths, "tests/fuzz_corpus/*.json missing"
    n_rungs = 0
    for path in paths:
        with open(path) as f:
            spec = DesignSpec.from_json(json.load(f)["spec"])
        ref_g = ref_build_simgraph(build_design(spec).design)
        _, pairs = _carried(ref_g)
        for ref_cg, cg in pairs:
            if ops_t.get_cert_tables(cg, CPU) is None:
                continue
            _check_rung(ref_cg, cg, _rows(cg, 2, seed=n_rungs))
            n_rungs += 1
    assert n_rungs > 0


def test_plain_k1_iteration_cap_matches_reference():
    """At max_iters=2 rows stay unconverged; lanes and times still match
    the reference's per-row freezing."""
    ref_g = ref_build_simgraph(ref_make_design("gemm"))
    _, pairs = _carried(ref_g)
    ref_cg, cg = pairs[0]
    _check_rung(ref_cg, cg, _rows(cg, 2, seed=5), max_iters=2)


def test_fully_certifying_batch_is_one_dispatch(monkeypatch):
    """When every row certifies on the aggressive rung, the whole batch
    is ONE fused dispatch and the host verifier never runs."""
    ref_g = ref_build_simgraph(ref_make_design("gemm"))
    g, _ = _carried(ref_g)
    rng = np.random.default_rng(0)
    u = np.asarray(g.upper_bounds, dtype=np.int64)
    rows = np.stack([np.maximum(2, (u * rng.uniform(0.5, 1.0, u.size))
                                .astype(int)) for _ in range(8)])
    expected = BatchedEvaluator(
        g, EvalConfig(backend="numpy", max_iters=64,
                      condense=None)).evaluate(rows)
    ev = BatchedEvaluator(g, EvalConfig(backend="cuda", max_iters=64),
                          device="cpu")
    assert any(impl.fused_certificate for _, impl in ev._cascade.rungs)

    def _boom(*a, **k):
        raise AssertionError("host verify_rows ran on the fused path")
    monkeypatch.setattr(condense_mod, "verify_rows", _boom)
    DISPATCH_COUNTS.clear()
    got = ev.evaluate(rows)
    assert dict(DISPATCH_COUNTS) == {"condensed": 1}, dict(DISPATCH_COUNTS)
    for a, b in zip(expected, got):
        np.testing.assert_array_equal(a, b)
