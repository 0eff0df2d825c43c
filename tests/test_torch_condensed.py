"""K1 parity: the port's plain torch version of the fused condensed kernel
(``fifo_eval_condensed_plain``, what the ``fifo_eval_condensed`` wrapper
runs on CPU tensors) equals the reference's Pallas kernel in interpret
mode on lanes 0, 1, 2 and 4 and on the times, for condensed graphs
carried across from the reference with ``repro_torch.core.carry``.  Its
certificate equals the host ``verify_rows``, and a fully-certifying batch
stays one dispatch with the host verifier never called.  K1's launch-shape
chooser (pure Python) gives a shape the kernel can run on every rung."""

import functools
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
from repro_torch.core.backends.dispatch import BUCKETS
from repro_torch.core.condense import (CondensedGraph, condense_auto,
                                       verify_rows)
from repro_torch.core.config import EvalConfig
from repro_torch.core.simgraph import build_simgraph
from repro_torch.core.simulate import BatchedEvaluator
from repro_torch.designs import make_design
from repro_torch.designs.streamhls import STREAMHLS_DESIGNS
from repro_torch.kernels.fifo_eval.condensed import (
    K1_EVENTS_PER_LANE, K1_MAX_E_PAD, MAX_CTA_WARPS, K1Shape,
    fifo_eval_condensed, k1_cert_slices, k1_launch_shape, k1_shapes,
    k1_splits)
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


# ---------------------------------------------------------------- K1 shape
STREAMHLS_NAMES = sorted(STREAMHLS_DESIGNS)
#: clusters of each size resident at once on a card of 132 SMs that could
#: place one CTA on every SM
ACTIVE_132 = {s: 132 // s for s in (2, 4, 8, 16)}


@functools.lru_cache(maxsize=None)
def _rung_pads(name):
    """(e_pad, v_pad) of every rung with certificate tables on ``name`` (a
    Stream-HLS design, or "corpus" for the fuzz corpus)."""
    if name == "corpus":
        rungs = []
        for path in sorted(glob.glob(os.path.join(CORPUS_DIR, "*.json"))):
            with open(path) as f:
                spec = DesignSpec.from_json(json.load(f)["spec"])
            _, pairs = _carried(ref_build_simgraph(build_design(spec).design))
            rungs += [cg for _, cg in pairs]
        assert rungs, "tests/fuzz_corpus/*.json missing"
    else:
        rungs = condense_auto(build_simgraph(make_design(name)))
    out = set()
    for cg in rungs:
        ct = ops_t.get_cert_tables(cg, CPU)
        if ct is not None:
            out.add((int(ops_t.get_operands(cg, CPU).delta.shape[1]),
                     ct.v_pad))
    return sorted(out)


def _check_k1_shape(e_pad, v_pad, shape):
    """``shape`` is one the kernel launches: at most 256 threads a CTA (its
    launch bound, within the card's 1024), at most 32 events a lane, the
    row covered, a power-of-two split, and shared memory (the row's times
    and zero cell, plus room for the static scratch) within the card's
    227 KB."""
    warps, k, split = shape
    assert shape in k1_shapes(e_pad, v_pad)
    assert split & (split - 1) == 0 and split <= 16
    assert 32 <= warps * 32 <= MAX_CTA_WARPS * 32 <= 1024
    assert k in K1_EVENTS_PER_LANE and k <= 32
    assert warps * 32 * k >= e_pad
    assert (e_pad + 4) * 4 + 2048 <= 227 * 1024


@pytest.mark.parametrize("name", STREAMHLS_NAMES + ["corpus"])
def test_k1_launch_shape_fits_every_rung(name):
    """The chooser's shape for every rung with certificate tables of a
    design, at every bucket size, on a card that holds clusters of every
    size or of none above 8, is launchable, and so is every shape it
    allows when forced."""
    pads = _rung_pads(name)
    assert pads
    for e_pad, v_pad in pads:
        for active in (ACTIVE_132, {**ACTIVE_132, 16: 0}):
            for c in BUCKETS:
                _check_k1_shape(e_pad, v_pad, k1_launch_shape(
                    c, e_pad, v_pad, active, 132))
        for shape in k1_shapes(e_pad, v_pad):
            _check_k1_shape(e_pad, v_pad, k1_launch_shape(
                8, e_pad, v_pad, ACTIVE_132, 132, shape))


def test_k1_launch_shape_spreads_only_in_one_wave():
    """The main path's 1 and 8 rows spread their slots over a cluster, but
    only while every row is resident in one wave and the CTAs fit the
    SMs, and over the largest such cluster; a size the card cannot launch
    (0 resident) drops out; 512 rows run one CTA a row."""
    rng = np.random.default_rng(0)
    for _ in range(300):
        c = int(rng.choice(BUCKETS))
        e_pad = int(rng.integers(1, 64)) * 128
        v_pad = int(rng.integers(1, 240)) * 128
        active = {s: int(rng.integers(0, 140)) for s in (2, 4, 8, 16)}
        n_sms = int(rng.integers(1, 200))
        shape = k1_launch_shape(c, e_pad, v_pad, active, n_sms)
        if shape.split > 1:
            assert c <= active[shape.split] and c * shape.split <= n_sms
        for s in k1_splits(v_pad):
            if s > shape.split:
                assert c > active[s] or c * s > n_sms
    tree = (3200, 23424)                 # k15mmtree's aggressive rung
    assert k1_launch_shape(8, *tree, ACTIVE_132, 132).split == 16
    assert k1_launch_shape(8, *tree, {**ACTIVE_132, 16: 7}, 132).split == 8
    assert k1_launch_shape(8, *tree, {**ACTIVE_132, 16: 0}, 132).split == 8
    assert k1_launch_shape(1, *tree, ACTIVE_132, 132) == K1Shape(4, 28, 16)
    assert k1_launch_shape(512, *tree, ACTIVE_132, 132) == K1Shape(4, 28, 1)
    assert k1_launch_shape(512, 256, 8064, ACTIVE_132, 132) == K1Shape(
        1, 8, 1)
    assert k1_launch_shape(37, *tree, ACTIVE_132, 132) == K1Shape(4, 28, 2)
    assert k1_launch_shape(8, *tree, {}, 132).split == 1


@pytest.mark.parametrize("v_pad", [0, 4, 100, 128, 1152, 7680, 8064, 12800,
                                   23424, 30208])
def test_k1_cert_slices_cover_each_slot_once(v_pad):
    """Every split cuts [0, v_pad) into slices of whole 16-byte groups that
    cover each slot exactly once."""
    for split in (1, 2, 4, 8, 16):
        slices = k1_cert_slices(v_pad, split)
        assert len(slices) == split
        hits = np.zeros(v_pad, dtype=int)
        for lo, hi in slices:
            assert lo % 4 == 0 and hi % 4 == 0 and lo <= hi
            hits[lo:hi] += 1
        assert (hits == 1).all()


def test_k1_launch_shape_rejects_what_the_kernel_cannot_run():
    """A shape the chooser does not allow, an e_pad beyond K1_MAX_E_PAD
    and one not a multiple of 4 raise; on CPU tensors the wrapper runs the
    plain version whatever shape it is given."""
    with pytest.raises(ValueError):
        k1_launch_shape(8, 3200, 23424, ACTIVE_132, 132,
                        K1Shape(4, 28, 32))
    with pytest.raises(ValueError):
        k1_launch_shape(8, 256, 8064, ACTIVE_132, 132, K1Shape(1, 4, 1))
    with pytest.raises(ValueError):
        k1_launch_shape(8, K1_MAX_E_PAD + 128, 8064, ACTIVE_132, 132)
    with pytest.raises(ValueError):
        k1_launch_shape(8, 130, 8064, ACTIVE_132, 132)
    ref_g = ref_build_simgraph(ref_make_design("gemm"))
    _, pairs = _carried(ref_g)
    ref_cg, cg = pairs[0]
    _, _, p_args = _kernel_args(ref_cg, cg, _rows(cg, 1, seed=2))
    bound = ops_t.get_operands(cg, CPU).bound
    want = fifo_eval_condensed_plain(*p_args, max_iters=64, bound=bound)[0]
    got = fifo_eval_condensed(*p_args, max_iters=64, bound=bound,
                              shape=K1Shape(1, 8, 8))[0]
    assert torch.equal(got, want)
