"""K2 parity: the port's plain torch version of the raw-stream kernel
(``fifo_eval_plain``, which is what the ``fifo_eval`` wrapper runs on CPU
tensors) equals the reference's jnp oracle ``fifo_eval_ref`` and its
Pallas kernel in interpret mode, on all four output lanes and the final
times — exact equality, since every time is an integer in float32."""

import functools
import glob
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.backends import operands as ref_ops
from repro.core.condense import condense_auto as ref_condense_auto
from repro.core.design import Design
from repro.core.simgraph import build_simgraph as ref_build_simgraph
from repro.designs import make_design as ref_make_design
from repro.designs.generate import DesignSpec, build_design
from repro.designs.builder import map_stage, producer, sink, streams
from repro.designs.ddcf import mult_by_2 as ref_mult_by_2
from repro.kernels.fifo_eval.fifo_eval import fifo_eval_pallas
from repro.kernels.fifo_eval.ops import make_batched_eval as ref_make_eval
from repro.kernels.fifo_eval.ref import fifo_eval_ref

from repro_torch.core import carry
from repro_torch.core.backends import operands as ops_t
from repro_torch.core.backends.base import UNRESOLVED
from repro_torch.core.backends.dispatch import BUCKETS
from repro_torch.designs.streamhls import STREAMHLS_DESIGNS
from repro_torch.kernels.fifo_eval.fifo_eval import (
    K2_EVENTS_PER_THREAD, MAX_CTA_EVENTS, MAX_E_PAD, fifo_eval,
    k2_cluster_sizes, k2_launch_shape)
from repro_torch.kernels.fifo_eval.ref import fifo_eval_plain
from repro_torch.kernels.fifo_eval.ops import make_batched_eval

CPU = torch.device("cpu")
CORPUS_DIR = os.path.join(os.path.dirname(__file__), "fuzz_corpus")


def tiny_chain(count=10, lanes=1, width=32):
    d = Design("tiny")
    a = streams(d, "a", lanes, width=width)
    b = streams(d, "b", lanes, width=width)
    producer(d, "p", a, [1.0] * count)
    map_stage(d, "m", a, b, count, ii=2, extra_delay=1)
    sink(d, "s", b, count)
    return d


TINY = [
    ("tiny_sub128", lambda: tiny_chain(count=8)),          # E < 128 (pad)
    ("tiny_odd", lambda: tiny_chain(count=23, lanes=2)),   # E % 128 != 0
    ("wide64", lambda: tiny_chain(count=40, width=64)),    # BRAM rd-lat
    ("mult_by_2", lambda: ref_mult_by_2(24)),              # deadlocks
]


def _rows(g, batch, seed):
    rng = np.random.default_rng(seed)
    u = np.asarray(g.upper_bounds, dtype=np.int64)
    rows = [u, np.full(g.n_fifos, 2)]
    rows += [rng.integers(2, np.maximum(3, u + 1))
             for _ in range(max(batch - 2, 0))]
    return np.stack(rows)[:batch].astype(np.int32)


def _operands(ref_g, rows):
    """Reference jnp operands and the port's torch operands of one batch."""
    g = carry.simgraph_from_arrays(carry.graph_fields(ref_g))
    r = ref_ops.build_operands(ref_g)
    p = ops_t.get_operands(g, CPU)
    r_rows = jax.jit(lambda d: ref_ops.depth_operands(r, d))(
        jnp.asarray(rows))[:4]
    p_rows = ops_t.depth_operands(p, torch.as_tensor(rows))[:4]
    r_args = (r.delta, r.seg_start, r.is_read, r.has_data, r.data_idx,
              r.end_bonus) + tuple(r_rows)
    p_args = (p.delta, p.seg_start, p.is_read, p.has_data, p.data_idx,
              p.end_bonus) + tuple(p_rows)
    return r, r_args, p_args, g


def _ref_oracle(r_args, max_iters, bound):
    run = jax.jit(lambda *a: fifo_eval_ref(*a, max_iters=max_iters,
                                           bound=bound))
    out, times = run(*r_args)
    return np.asarray(out), np.asarray(times)


def _check_batches(p_args, ref_out, ref_t, max_iters, bound):
    """The port at batches 1, 5 and 8 against the matching rows of the
    reference's 8-row result (rows are independent)."""
    for c in (1, 5, 8):
        rows = [a[:c] if a.shape[0] > 1 else a for a in p_args]
        out, t = fifo_eval_plain(*rows, max_iters=max_iters, bound=bound,
                                 with_times=True)
        np.testing.assert_array_equal(out.numpy(), ref_out[:c])
        np.testing.assert_array_equal(t.numpy(), ref_t[:c])
    return out, t


@pytest.mark.parametrize("name,factory", TINY)
def test_plain_k2_equals_ref_and_pallas_interpret(name, factory):
    ref_g = ref_build_simgraph(factory())
    rows = _rows(ref_g, 8, seed=len(name))
    r, r_args, p_args, _ = _operands(ref_g, rows)
    ref_out, ref_t = _ref_oracle(r_args, 128, r.bound)
    pal_out, pal_t = fifo_eval_pallas(*r_args, max_iters=128, bound=r.bound,
                                      interpret=True, with_times=True)
    np.testing.assert_array_equal(np.asarray(pal_out)[:, :4], ref_out)
    np.testing.assert_array_equal(np.asarray(pal_t), ref_t)
    out, t = _check_batches(p_args, ref_out, ref_t, 128, r.bound)
    # the wrapper runs the plain version on CPU tensors
    w_out, w_t = fifo_eval(*p_args, max_iters=128, bound=r.bound,
                           with_times=True)
    assert torch.equal(w_out, out) and torch.equal(w_t, t)
    w_out, w_none = fifo_eval(*p_args, max_iters=128, bound=r.bound)
    assert torch.equal(w_out, out) and w_none is None


def test_plain_k2_equals_ref_on_gemm():
    """A full Stream-HLS raw stream (E_pad 8192) against the jnp oracle."""
    ref_g = ref_build_simgraph(ref_make_design("gemm"))
    rng = np.random.default_rng(0)
    u = np.asarray(ref_g.upper_bounds, dtype=np.int64)
    rows = np.stack([np.ones_like(u), u] + [rng.integers(1, u + 1)
                                            for _ in range(6)])
    r, r_args, p_args, _ = _operands(ref_g, rows.astype(np.int32))
    ref_out, ref_t = _ref_oracle(r_args, 64, r.bound)
    _check_batches(p_args, ref_out, ref_t, 64, r.bound)


@pytest.mark.parametrize("max_iters", [2, 64])
def test_iteration_cap_statuses_match_row_for_row(max_iters):
    """At a small cap rows come out UNRESOLVED; the port's closure marks
    exactly the reference's rows, with the same latency and BRAM."""
    ref_g = ref_build_simgraph(ref_mult_by_2(32))
    g = carry.simgraph_from_arrays(carry.graph_fields(ref_g))
    rows = np.array([[40, 2], [2, 2], [31, 1], [64, 64], [3, 5]])
    ref_call = ref_make_eval(ref_g, use_ref=True, max_iters=max_iters)
    pal_call = ref_make_eval(ref_g, interpret=True, max_iters=max_iters)
    for use_ref in (True, False):
        call = make_batched_eval(g, use_ref=use_ref, max_iters=max_iters,
                                 device="cpu")
        lat, bram, st = call(rows)
        for ref_res in (ref_call(rows), pal_call(rows)):
            r_lat, r_bram, r_st = (np.asarray(x) for x in ref_res)
            np.testing.assert_array_equal(st, r_st)
            np.testing.assert_array_equal(bram, r_bram)
            np.testing.assert_array_equal(lat, r_lat)
        if max_iters == 2:
            assert (st == UNRESOLVED).any()


# ---------------------------------------------------------------- K2 shape
STREAMHLS_NAMES = sorted(STREAMHLS_DESIGNS)


@functools.lru_cache(maxsize=None)
def _stream_e_pads(name):
    """E_pad of every stream K2 can meet on ``name`` (a Stream-HLS design,
    or "corpus" for the fuzz corpus): the raw stream and its rungs."""
    if name == "corpus":
        graphs = []
        for path in sorted(glob.glob(os.path.join(CORPUS_DIR, "*.json"))):
            with open(path) as f:
                spec = DesignSpec.from_json(json.load(f)["spec"])
            graphs.append(ref_build_simgraph(build_design(spec).design))
        assert graphs, "tests/fuzz_corpus/*.json missing"
    else:
        graphs = [ref_build_simgraph(ref_make_design(name))]
    lanes = ops_t.LANES                  # build_operands' padding
    return sorted({max(lanes, -(-h.n_events // lanes) * lanes)
                   for g in graphs for h in [g, *ref_condense_auto(g)]})


#: clusters of each size resident at once on a card of 132 SMs that could
#: place one CTA on every SM
ACTIVE_132 = {s: 132 // s for s in (1, 2, 4, 8, 16)}


def _check_shape(c, e_pad, active, max_cluster, shape, forced=None):
    cluster, threads, k = shape
    sizes = k2_cluster_sizes(e_pad, max_cluster)
    assert cluster in sizes and cluster & (cluster - 1) == 0
    assert cluster <= max_cluster <= 16
    if forced is not None:
        assert cluster == forced
    elif cluster > sizes[0]:
        assert c <= active[cluster]      # spread only while one wave holds
    assert threads % 32 == 0 and 32 <= threads <= 1024
    assert k in K2_EVENTS_PER_THREAD
    span = threads * k                   # events a CTA owns
    assert span <= MAX_CTA_EVENTS        # its operands fit registers
    assert span * cluster >= e_pad       # the row is covered
    assert (span + 1) * 4 + 1024 <= 227 * 1024   # its t slice fits


@pytest.mark.parametrize("name", STREAMHLS_NAMES + ["corpus"])
def test_k2_launch_shape_fits_every_stream(name):
    """The chooser's shape for every stream of a design and its rungs, at
    every bucket size and both cluster caps, fits the kernel; every size
    it allows fits when forced; rows above MAX_E_PAD, or needing more
    CTAs than the cap, raise."""
    n_checked = 0
    for e_pad in _stream_e_pads(name):
        if e_pad > MAX_E_PAD:
            with pytest.raises(ValueError):
                k2_launch_shape(8, e_pad, ACTIVE_132)
            continue
        for max_cluster in (8, 16):
            if e_pad > max_cluster * MAX_CTA_EVENTS:
                with pytest.raises(ValueError):
                    k2_launch_shape(8, e_pad, ACTIVE_132, max_cluster)
                continue
            for c in BUCKETS:
                _check_shape(c, e_pad, ACTIVE_132, max_cluster,
                             k2_launch_shape(c, e_pad, ACTIVE_132,
                                             max_cluster))
                n_checked += 1
            for s in k2_cluster_sizes(e_pad, max_cluster):
                _check_shape(8, e_pad, ACTIVE_132, max_cluster,
                             k2_launch_shape(8, e_pad, ACTIVE_132,
                                             max_cluster, s),
                             forced=s)
    assert n_checked > 0


def test_k2_launch_shape_spreads_few_rows():
    """The main path's 8-row bucket spreads a long row over a cluster, but
    only as far as all 8 rows run in one wave; 512 rows use the fewest
    CTAs that hold the operands; an unknown forced size and an e_pad
    beyond MAX_E_PAD raise."""
    assert k2_launch_shape(8, 26496, ACTIVE_132, 16)[0] == 16
    assert k2_launch_shape(8, 26496, {**ACTIVE_132, 16: 7}, 16)[0] == 8
    assert k2_launch_shape(8, 26496, ACTIVE_132, 8)[0] == 8
    assert k2_launch_shape(8, 13312, ACTIVE_132, 16)[0] == 8
    assert k2_launch_shape(8, 13312, {**ACTIVE_132, 8: 7}, 16)[0] == 4
    assert k2_launch_shape(512, 26496, ACTIVE_132, 16)[0] == 8
    assert k2_launch_shape(512, 2560, ACTIVE_132, 16)[0] == 1
    assert k2_cluster_sizes(32768, 16) == (8, 16)
    assert k2_cluster_sizes(MAX_E_PAD, 16) == (16,)
    assert k2_launch_shape(8, 36864, ACTIVE_132, 16)[:2] == (16, 576)
    with pytest.raises(ValueError):
        k2_launch_shape(8, 26496, ACTIVE_132, 16, cluster=4)
    with pytest.raises(ValueError):              # a row of 33k needs 16
        k2_launch_shape(8, 32768 + 128, ACTIVE_132, 8)
    with pytest.raises(ValueError):
        k2_launch_shape(8, MAX_E_PAD + 128, ACTIVE_132, 16)
