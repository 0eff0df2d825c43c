"""Cross-design ("hetero") evaluation: the port against the reference.

* ``extend_operands`` re-pads each design to the shared envelope exactly
  as the reference does, with and without envelope growth;
* ``stack_hetero`` keeps each design's tables once, and every row's
  ``tables.<field>[table_of_row]`` equals the reference ``stack_hetero``'s
  per-row array element for element;
* ``fifo_eval_ref_hetero`` (the plain version of K2's per-design-table
  mode) and ``make_hetero_batched_eval`` on the CPU give the reference's
  rows at batch sizes 1, 5 and 37, UNRESOLVED rows at a small cap
  included;
* ``HeteroDispatcher.dispatch`` equals the reference's and the per-design
  worklist's, with equal ``HeteroStats``;
* ``pad_rows`` to ``target_rows``, the one padder of the dispatchers and
  the backends, pads as each helper it replaced did.

Exact equality throughout: every time is an integer in float32."""

import glob
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.backends import HeteroDispatcher as RefHeteroDispatcher
from repro.core.backends import operands as ref_ops
from repro.core.bram import (BRAM_READ_LATENCY, SRL_BITS, SRL_DEPTH,
                             SRL_READ_LATENCY)
from repro.core.simgraph import build_simgraph as ref_build_simgraph
from repro.designs import make_design as ref_make_design
from repro.designs.ddcf import flowgnn_pna as ref_flowgnn_pna
from repro.designs.ddcf import mult_by_2 as ref_mult_by_2
from repro.designs.generate import build_design as ref_build_design
from repro.designs.generate import load_corpus_specs as ref_load_corpus
from repro.kernels.fifo_eval.ops import \
    make_hetero_batched_eval as ref_make_hetero
from repro.kernels.fifo_eval.ref import \
    fifo_eval_ref_hetero as ref_fifo_eval_ref_hetero

from repro_torch.core.backends import (DEADLOCK, UNRESOLVED, DispatchPolicy,
                                       HeteroDispatcher)
from repro_torch.core.backends.dispatch import BUCKETS, pad_rows, target_rows
from repro_torch.core.backends import operands as ops_t
from repro_torch.core.simgraph import build_simgraph
from repro_torch.designs import flowgnn_pna, make_design, mult_by_2
from repro_torch.designs.generate import build_design, load_corpus_specs
from repro_torch.kernels.fifo_eval.fifo_eval import (check_operands,
                                                     fifo_eval_hetero)
from repro_torch.kernels.fifo_eval.ops import (DISPATCH_COUNTS,
                                               make_hetero_batched_eval)
from repro_torch.kernels.fifo_eval.ref import fifo_eval_ref_hetero

CPU = torch.device("cpu")
CORPUS = sorted(glob.glob(os.path.join(os.path.dirname(__file__),
                                       "fuzz_corpus", "*.json")))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain kernels run many tiny torch ops; with several test
    workers on one host, torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _designs():
    """{key: (reference design, port design)}: the corpus designs,
    mult_by_2(24), flowgnn_pna(12, 30) and gemm."""
    out = {}
    for path, rs, ps in zip(CORPUS, ref_load_corpus(CORPUS),
                            load_corpus_specs(CORPUS)):
        key = os.path.basename(path)[:-5]
        out[key] = (ref_build_design(rs).design, build_design(ps).design)
    out["m2"] = (ref_mult_by_2(24), mult_by_2(24))
    out["pna"] = (ref_flowgnn_pna(n_nodes=12, n_edges=30),
                  flowgnn_pna(n_nodes=12, n_edges=30))
    out["gemm"] = (ref_make_design("gemm"), make_design("gemm"))
    return out


@pytest.fixture(scope="module")
def graphs():
    """{key: (reference graph, port graph)}."""
    return {k: (ref_build_simgraph(r), build_simgraph(p))
            for k, (r, p) in _designs().items()}


def _envelope(opses):
    return (max(o.e_pad for o in opses), max(o.n_fifos for o in opses),
            max(o.n_flat_reads for o in opses))


def _extended(graphs, keys):
    """Reference and port HeteroOperands of ``keys`` in their envelope."""
    r_ops = [ref_ops.get_operands(graphs[k][0]) for k in keys]
    p_ops = [ops_t.get_operands(graphs[k][1], CPU) for k in keys]
    env = _envelope(r_ops)
    assert env == _envelope(p_ops)
    return ([ref_ops.extend_operands(o, *env) for o in r_ops],
            [ops_t.extend_operands(o, *env) for o in p_ops])


def _rows(g, c, seed):
    """``c`` depth rows: the upper bounds, all-2 (often a deadlock), then
    random rows between them."""
    rng = np.random.default_rng(seed)
    u = np.asarray(g.upper_bounds, dtype=np.int64)
    m = [np.maximum(u, 2), np.full(g.n_fifos, 2)]
    m += [np.maximum(2, (u * rng.uniform(0.1, 1.0, g.n_fifos))
                     .astype(np.int64)) for _ in range(max(c - 2, 0))]
    return np.stack(m)[:c]


@pytest.mark.parametrize("keys", [
    ("m2",), ("gemm",),                                # no growth
    ("m2", "pna", "gemm"),                             # growth
    tuple(os.path.basename(p)[:-5] for p in CORPUS) + ("m2",),
], ids=["m2", "gemm", "m2+pna+gemm", "corpus+m2"])
def test_extend_operands_equals_reference(graphs, keys):
    ref, port = _extended(graphs, keys)
    for r, p in zip(ref, port):
        for f in r.__dataclass_fields__:
            a, b = getattr(r, f), getattr(p, f)
            if isinstance(a, np.ndarray):
                assert a.dtype == b.dtype, f
                np.testing.assert_array_equal(a, b, err_msg=f)
            else:
                assert a == b, f
    # the extension region: a fresh segment at the design's own e_pad,
    # zero delta, NEG end bonus, width-1 padded FIFOs
    for key, p in zip(keys, port):
        own = ops_t.get_operands(graphs[key][1], CPU)
        if p.e_pad > own.e_pad:
            assert p.seg_start[own.e_pad] == 1.0
            assert not p.delta[own.e_pad:].any()
            assert (p.end_bonus[own.e_pad:] == ops_t.NEG).all()
        assert (p.widths[own.n_fifos:] == 1).all()


@pytest.mark.parametrize("sizes", [(1, 0, 0), (2, 2, 1), (13, 17, 7)],
                         ids=lambda s: "-".join(map(str, s)))
def test_stack_hetero_rows_equal_reference(graphs, sizes):
    keys = ("m2", "pna", "gemm")
    ref_h, port_h = _extended(graphs, keys)
    mats = [_rows(graphs[k][0], c, seed=i) for i, (k, c) in
            enumerate(zip(keys, sizes)) if c]
    hs = [i for i, c in enumerate(sizes) if c]
    want = ref_ops.stack_hetero([(ref_h[i], m) for i, m in zip(hs, mats)])
    tables, tor, depths = ops_t.stack_hetero(
        [(port_h[i], m) for i, m in zip(hs, mats)])
    assert tables.n_designs == len(hs)           # each design once
    assert tor.dtype == np.int32
    idx = torch.as_tensor(tor).long()
    for f in ops_t.HETERO_TABLES:
        got = getattr(tables, f)[idx].numpy()
        assert got.dtype == want[f].dtype, f
        np.testing.assert_array_equal(got, want[f], err_msg=f)
    for f, mine in (("bound", tables.bound), ("taskless", tables.taskless),
                    ("n_flat_reads", tables.n_flat_reads)):
        got = mine[idx].numpy()
        assert got.dtype == want[f].dtype, f
        np.testing.assert_array_equal(got, want[f], err_msg=f)
    np.testing.assert_array_equal(depths, want["depths"])
    assert depths.dtype == want["depths"].dtype


def _batch(graphs, c, seed):
    """A mixed ``c``-row batch of m2, pna and gemm rows, as the reference
    (stacked dict) and the port (tables, table_of_row, depths) hold it."""
    keys = ("m2", "pna", "gemm")
    ref_h, port_h = _extended(graphs, keys)
    split = [c // 3 + (i < c % 3) for i in range(3)]
    entries = [(i, _rows(graphs[k][0], n, seed + i))
               for i, (k, n) in enumerate(zip(keys, split)) if n]
    want = ref_ops.stack_hetero([(ref_h[i], m) for i, m in entries])
    got = ops_t.stack_hetero([(port_h[i], m) for i, m in entries])
    return want, got


@pytest.mark.parametrize("c", [1, 5, 37])
def test_hetero_depth_operands_equal_reference_gathers(graphs, c):
    """The per-row depth operands, computed one design at a time against
    that design's tables, equal the reference's per-row gathers
    (``make_hetero_batched_eval``'s ``take_along_axis``, here in numpy on
    the reference ``stack_hetero``'s rows), with the designs' rows
    interleaved."""
    want, (tables, tor, depths) = _batch(graphs, c, seed=200 + c)
    perm = np.random.default_rng(c).permutation(c)
    b = {k: v[perm] for k, v in want.items()}
    d = b["depths"].astype(np.int32)
    is_bram = ~((d <= SRL_DEPTH)
                | (d * b["widths"].astype(np.int32) <= SRL_BITS))
    fifo = b["fifo"].astype(np.int64)
    bp_pos = b["rank"].astype(np.int32) - np.take_along_axis(d, fifo, 1)
    overrun = b["is_write"] & (bp_pos >= b["evt_n_reads"])
    flat = np.clip(b["evt_read_base"] + bp_pos, 0,
                   b["n_flat_reads"][:, None] - 1)
    rd, bpi, bpv, structural, w = ops_t.hetero_depth_operands(
        tables, torch.as_tensor(tor[perm]).long(),
        torch.as_tensor(depths[perm]))
    np.testing.assert_array_equal(rd.numpy(), np.take_along_axis(
        np.where(is_bram, float(BRAM_READ_LATENCY),
                 float(SRL_READ_LATENCY)).astype(np.float32), fifo, 1))
    np.testing.assert_array_equal(bpi.numpy(), np.take_along_axis(
        b["read_evt_flat"].astype(np.int32), flat.astype(np.int64), 1))
    np.testing.assert_array_equal(bpv.numpy(), (
        b["is_write"] & (bp_pos >= 0) & ~overrun).astype(np.float32))
    np.testing.assert_array_equal(structural.numpy(), overrun.any(axis=1))
    np.testing.assert_array_equal(w.numpy(), b["widths"])
    assert (rd.dtype, bpi.dtype, bpv.dtype) == (
        torch.float32, torch.int32, torch.float32)


@pytest.mark.parametrize("max_iters", [64, 3])
@pytest.mark.parametrize("c", [1, 5, 37])
def test_fifo_eval_ref_hetero_equals_reference(graphs, c, max_iters):
    """The plain version of K2's per-design-table mode against the
    reference's jnp vmap, on the same per-row operands, and the wrapper
    on CPU tensors against the plain version."""
    want, (tables, tor, depths) = _batch(graphs, c, seed=c)
    idx = torch.as_tensor(tor).long()
    rd, bpi, bpv, structural, w = ops_t.hetero_depth_operands(
        tables, idx, torch.as_tensor(depths))
    per_row = [getattr(tables, f)[idx] for f in
               ("delta", "seg_start", "is_read", "has_data", "data_idx",
                "end_bonus")]
    bound = tables.bound[idx]
    out, t = fifo_eval_ref_hetero(*per_row, rd, bpi, bpv, bound,
                                  max_iters=max_iters, with_times=True)
    ref_out = jax.jit(lambda *a: ref_fifo_eval_ref_hetero(
        *a, max_iters=max_iters))(
        *(jnp.asarray(x.numpy()) for x in per_row + [rd, bpi, bpv, bound]))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref_out))
    if max_iters == 3 and c > 1:
        assert (out[:, 1] == 0).any()            # unconverged rows
    w_out, w_t = fifo_eval_hetero(
        tables.delta, tables.seg_start, tables.is_read, tables.has_data,
        tables.data_idx, tables.end_bonus, rd, bpi, bpv,
        table_of_row=torch.as_tensor(tor), bounds=bound,
        max_iters=max_iters, with_times=True)
    assert torch.equal(w_out, out) and torch.equal(w_t, t)


@pytest.mark.parametrize("max_iters", [64, 3])
@pytest.mark.parametrize("c", [1, 5, 37])
def test_make_hetero_batched_eval_equals_reference(graphs, c, max_iters):
    want, (tables, tor, depths) = _batch(graphs, c, seed=100 + c)
    ref = ref_make_hetero(max_iters)(want)
    before = DISPATCH_COUNTS["hetero"]
    got = make_hetero_batched_eval(max_iters, device="cpu")(
        tables, tor, depths)
    assert DISPATCH_COUNTS["hetero"] == before + 1
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    if max_iters == 3 and c > 1:
        assert (got[2] == UNRESOLVED).any()


def test_check_operands_rejects_bad_table_index():
    e = 128
    shared = {"delta": (torch.zeros((2, e)), torch.float32, (2, e))}
    row = {"table_of_row": (torch.tensor([0, 2], dtype=torch.int32),
                            torch.int32, (2,))}
    with pytest.raises(ValueError, match="outside"):
        check_operands(e, shared, row, CPU, row["table_of_row"][0])
    row["table_of_row"] = (torch.tensor([0, 1], dtype=torch.int64),
                           torch.int32, (2,))
    with pytest.raises(ValueError, match="int64"):
        check_operands(e, shared, row, CPU, row["table_of_row"][0])


def _items(graphs, keys, seed):
    rng = np.random.default_rng(seed)
    items = []
    for k in keys:
        g = graphs[k][0]
        u = g.upper_bounds
        items.append((k, np.concatenate([
            np.maximum(u, 2)[None, :], np.full((1, g.n_fifos), 2),
            np.maximum(2, (u * rng.uniform(0.1, 1.0, (6, g.n_fifos))
                           ).astype(np.int64))])))
    return items


@pytest.mark.parametrize("max_iters", [64, 3])
@pytest.mark.parametrize("grow", [False, True], ids=["built", "grown"])
def test_hetero_dispatch_equals_reference_and_worklist(graphs, max_iters,
                                                       grow):
    """Mirrors the reference's ``test_hetero_dispatch_matches_worklist``,
    also at a cap where rows escalate; ``grown`` registers the designs one
    by one, smallest first, so the envelope grows twice."""
    keys = ("m2", "pna", "gemm")
    if grow:
        ref = RefHeteroDispatcher({}, max_iters=max_iters)
        port = HeteroDispatcher({}, max_iters=max_iters, device="cpu")
        for k in keys:
            ref.add_design(k, graphs[k][0])
            port.add_design(k, graphs[k][1])
    else:
        ref = RefHeteroDispatcher({k: graphs[k][0] for k in keys},
                                  max_iters=max_iters)
        port = HeteroDispatcher({k: graphs[k][1] for k in keys},
                                max_iters=max_iters, device="cpu")
    assert (port.e_pad, port.f_max, port.r_max) == \
        (ref.e_pad, ref.f_max, ref.r_max)
    for seed in (11, 12):
        items = _items(graphs, keys, seed)
        want = ref.dispatch(items)
        got = port.dispatch(items)
        for (k, m), (lat, bram, dead), r in zip(items, got, want):
            for a, b in zip((lat, bram, dead), r):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            wlat, wbram, wstatus = port.worklists[k].evaluate(m)
            wdead = wstatus == DEADLOCK
            np.testing.assert_array_equal(dead, wdead)
            np.testing.assert_array_equal(lat, np.where(wdead, -1, wlat))
            np.testing.assert_array_equal(bram, wbram)
    for f in ("n_dispatches", "n_rows", "n_pad_rows", "n_fallbacks"):
        assert getattr(port.stats, f) == getattr(ref.stats, f), f
    if max_iters == 3:
        assert port.stats.n_fallbacks > 0


def test_hetero_sharding_names_its_roadmap_item(graphs):
    """Row sharding of the cross-design dispatch: ``shards=2`` on the CPU
    gives the unsharded dispatcher's rows, and the closure over an
    explicit 2-shard mesh (tables copied per shard) the solo closure's."""
    from repro_torch.launch.mesh import make_eval_mesh
    g = {"m2": graphs["m2"][1], "gemm": graphs["gemm"][1]}
    items = [(k, _rows(v, 5, seed=i)) for i, (k, v) in enumerate(g.items())]
    sharded = HeteroDispatcher(g, shards=2, device="cpu")
    solo = HeteroDispatcher(g, device="cpu")
    assert sharded.shard_multiple == 2 and solo.shard_multiple == 1
    for got, want in zip(sharded.dispatch(items), solo.dispatch(items)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    _, (tables, tor, depths) = _batch(graphs, 38, seed=300)
    mesh = make_eval_mesh(2, device="cpu")
    got = make_hetero_batched_eval(device="cpu", mesh=mesh)(tables, tor,
                                                           depths)
    want = make_hetero_batched_eval(device="cpu")(tables, tor, depths)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


#: (rows, buckets, shard multiple, padded rows): each padded row count is
#: what the helpers before ``target_rows`` gave, ``DispatchPolicy
#: .pad_batch``, ``HeteroDispatcher._pad_rows`` and, without buckets,
#: ``_ScanBackend._pad_shards``
PADS = {
    "no_bucket": (5, (), 1, 5),
    "bucket": (5, BUCKETS, 1, 8),
    "hetero_bucket": (5, HeteroDispatcher.BUCKETS, 1, 8),
    "shard_multiple": (5, (), 4, 8),
    "bucket_to_shard_multiple": (5, HeteroDispatcher.BUCKETS, 3, 9),
    "over_the_last_bucket": (2049, BUCKETS, 1, 2049),
    "over_the_last_bucket_sharded": (4097, HeteroDispatcher.BUCKETS, 2,
                                     4098),
    "exact": (32, BUCKETS, 2, 32),
}


@pytest.mark.parametrize("case", list(PADS))
def test_pad_rows_to_target_rows_pad_as_the_old_helpers(case):
    """The target, then every row array padded to it by repeating its
    last row (a table index beside its depth rows), untouched where it
    needs no pad; ``DispatchPolicy.pad_batch`` pads the same."""
    c, buckets, k, want = PADS[case]
    assert target_rows(c, buckets, k) == want
    tor = np.arange(c) % 3
    depths = np.arange(2 * c).reshape(c, 2)
    got_tor, got = pad_rows(want, tor, depths)
    assert got_tor.shape == (want,) and got.shape == (want, 2)
    np.testing.assert_array_equal(got_tor[:c], tor)
    np.testing.assert_array_equal(got[:c], depths)
    assert (got_tor[c:] == tor[-1]).all() and (got[c:] == depths[-1]).all()
    if want == c:
        assert got_tor is tor and got is depths
    np.testing.assert_array_equal(
        DispatchPolicy(None, buckets, k).pad_batch(depths), got)
