"""The plain versions of the two kernels around each K2 and K1 launch
(``depth_operands_plain`` and ``eval_epilogue_plain``, what
``csrc/launch_ops.cu`` computes) against the reference package, and the
evaluation closures built on them against the reference's closures: on
k15mmtree's raw stream and its rungs, a stream of MolHIV-shaped molecules
through FlowGNN's PNA engine, and a design with a FIFO written more often
than it is read (structural deadlock).  The rows sit on the edges of the
SRL/BRAM rule: depth SRL_DEPTH and one above, depth x width at SRL_BITS
and one FIFO-depth above."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.backends import operands as ref_ops
from repro.core.bram import bram_count_np
from repro.core.condense import condense_auto as ref_condense_auto
from repro.core.design import Design as RefDesign
from repro.core.simgraph import SimGraph as RefSimGraph
from repro.core.simgraph import build_simgraph as ref_build_simgraph
from repro.designs import make_design as ref_make_design
from repro.kernels.fifo_eval.ops import make_batched_eval as ref_make_eval

from repro_torch import obs
from repro_torch.core import carry
from repro_torch.core.backends import operands as ops_t
from repro_torch.core.backends.base import CONVERGED, DEADLOCK, UNRESOLVED
from repro_torch.core.bram import SRL_BITS, SRL_DEPTH
from repro_torch.core.condense import CondensedGraph
from repro_torch.core.simgraph import build_simgraph
from repro_torch.designs import flowgnn_pna_stream, molhiv_stream
from repro_torch.kernels.fifo_eval import launch_ops, ops
from repro_torch.kernels.fifo_eval.condensed import fifo_eval_condensed
from repro_torch.kernels.fifo_eval.ref import fifo_eval_plain
from repro_torch.launch.mesh import make_eval_mesh

CPU = torch.device("cpu")
OPERANDS = ("rd_lat_e", "bp_idx", "bp_valid", "bp_base", "structural")


def _leftover():
    """One FIFO written 6 times and read twice, beside a balanced one: it
    deadlocks structurally below depth 4 (the writer cannot park the
    surplus), whatever the other FIFO's depth."""
    d = RefDesign("leftover")
    d.fifo("x")
    d.fifo("y", width=64)

    @d.task("w")
    def w(ctx):
        for i in range(6):
            yield ctx.write("x", i)
            yield ctx.write("y", i)

    @d.task("r")
    def r(ctx):
        for _ in range(2):
            yield ctx.read("x")
        for _ in range(6):
            yield ctx.read("y")
    return d


@functools.lru_cache(maxsize=None)
def _graphs():
    """{label: (reference graph, port graph)}."""
    ref_g = ref_build_simgraph(ref_make_design("k15mmtree"))
    g = carry.simgraph_from_arrays(carry.graph_fields(ref_g))
    out = {"k15mmtree/raw": (ref_g, g)}
    for ref_cg in ref_condense_auto(ref_g):
        out[f"k15mmtree/{ref_cg.tag}"] = (ref_cg, carry.condensed_from_arrays(
            carry.graph_fields(ref_cg, CondensedGraph), raw=g))
    flow = build_simgraph(flowgnn_pna_stream(molhiv_stream(32, 23), seed=23))
    out["flowgnn_pna_stream"] = (
        RefSimGraph(**carry.graph_fields(flow), design=None), flow)
    ref_l = ref_build_simgraph(_leftover())
    out["leftover"] = (ref_l, carry.simgraph_from_arrays(
        carry.graph_fields(ref_l)))
    return out


GRAPHS = ["k15mmtree/raw", "k15mmtree/aggressive", "k15mmtree/safe",
          "flowgnn_pna_stream", "leftover"]


def _edge_rows(g, seed=0, extra=3):
    """Depth rows on the rule's edges: 1, SRL_DEPTH, SRL_DEPTH + 1, the
    deepest shift register of each FIFO's width (depth x width at most
    SRL_BITS, equal where the width divides it) and one deeper, the upper
    bounds, then ``extra`` random rows; an even count (the mesh of 2)."""
    u = np.asarray(g.upper_bounds, dtype=np.int64)
    w = np.asarray(g.widths, dtype=np.int64)
    srl = np.maximum(1, SRL_BITS // w)
    rng = np.random.default_rng(seed)
    rows = [np.ones_like(u), np.full_like(u, SRL_DEPTH),
            np.full_like(u, SRL_DEPTH + 1), srl, srl + 1, u]
    rows += [rng.integers(1, u + 1) for _ in range(extra)]
    rows = rows[: len(rows) // 2 * 2]
    return np.stack(rows).astype(np.int32)


def test_edge_rows_cover_the_rule_and_structural_deadlock():
    for label in GRAPHS:
        g = _graphs()[label][1]
        rows = _edge_rows(g)
        w = np.asarray(g.widths)
        bits = rows * w[None, :]
        assert (rows == SRL_DEPTH).any() and (rows == SRL_DEPTH + 1).any()
        if (SRL_BITS % w == 0).any():
            assert (bits == SRL_BITS).any(), label
        assert (bits > SRL_BITS).any(), label
    g = _graphs()["leftover"][1]
    structural = ops_t.depth_operands_plain(
        ops_t.get_operands(g, CPU), torch.as_tensor(_edge_rows(g)))[4]
    assert structural.any() and not structural.all()


@pytest.mark.parametrize("max_iters", [2, 64])
@pytest.mark.parametrize("label", GRAPHS)
def test_plain_operands_and_epilogue_equal_the_reference(label, max_iters):
    """``depth_operands_plain`` equals the reference's ``depth_operands``
    and ``depth_operands`` runs it on CPU tensors; the plain epilogue's
    packed lanes equal the reference closure's latency, BRAM count and
    status (at max_iters 2 some rows are UNRESOLVED), and the kernel's
    iteration lane."""
    ref_g, g = _graphs()[label]
    rows = _edge_rows(g, seed=max_iters)
    p = ops_t.get_operands(g, CPU)
    depths = torch.as_tensor(rows)
    plain = ops_t.depth_operands_plain(p, depths)
    r = ref_ops.build_operands(ref_g)
    want = jax.jit(lambda d: ref_ops.depth_operands(r, d))(jnp.asarray(rows))
    for what, a, b in zip(OPERANDS, plain, want):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, what
        np.testing.assert_array_equal(a.numpy(), b, err_msg=what)
    for a, b in zip(ops_t.depth_operands(p, depths), plain):
        assert torch.equal(a, b)

    out, _ = fifo_eval_plain(p.delta, p.seg_start, p.is_read, p.has_data,
                             p.data_idx, p.end_bonus, *plain[:4],
                             max_iters=max_iters, bound=p.bound)
    packed = launch_ops.eval_epilogue(out, plain[4], depths, p.widths,
                                      p.taskless_lat)
    assert packed.dtype == torch.int32 and packed.shape == (len(rows), 4)
    assert torch.equal(packed, launch_ops.eval_epilogue_plain(
        out, plain[4], depths, p.widths, p.taskless_lat))
    lat, bram, status, iters, cert = launch_ops.unpack(packed.numpy())
    assert cert is None
    assert (lat.dtype, bram.dtype, status.dtype, iters.dtype) == (
        np.float32, np.int32, np.int8, np.float32)
    r_lat, r_bram, r_st = (np.asarray(x) for x in ref_make_eval(
        ref_g, use_ref=True, max_iters=max_iters)(rows))
    np.testing.assert_array_equal(lat, r_lat)
    np.testing.assert_array_equal(bram, r_bram)
    np.testing.assert_array_equal(status, r_st)
    np.testing.assert_array_equal(
        bram, bram_count_np(rows, np.asarray(g.widths)[None, :]).sum(1))
    np.testing.assert_array_equal(iters, out[:, 3].numpy())
    np.testing.assert_array_equal(
        lat, np.maximum(out[:, 0].numpy(), np.float32(p.taskless_lat)))
    if label == "leftover":
        assert (status[plain[4].numpy()] == DEADLOCK).all()
    if max_iters == 2 and label != "leftover":
        assert (status == UNRESOLVED).any()


@functools.lru_cache(maxsize=None)
def _ref_answer(label, with_times):
    """The reference closure's answer on :func:`_edge_rows` (seed 7) at
    max_iters 64, as numpy (computed once for the variants that share
    it)."""
    ref_g, g = _graphs()[label]
    return tuple(np.asarray(x) for x in ref_make_eval(
        ref_g, use_ref=True, max_iters=64, with_times=with_times)(
            _edge_rows(g, seed=7)))


VARIANTS = {
    "plain": dict(),
    "use_ref": dict(use_ref=True),
    "with_times": dict(with_times=True),
    "mesh2": dict(mesh=2),
    "mesh2_times": dict(mesh=2, with_times=True),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("label", ["k15mmtree/raw", "k15mmtree/safe",
                                   "flowgnn_pna_stream", "leftover"])
def test_closure_variants_return_the_tuples_of_before(label, variant):
    """Each variant of the K2 closure (K2 or the plain fixpoint, with or
    without times, on one device or staged over a mesh of 2) returns the
    reference closure's tuple: its length, dtypes and values."""
    g = _graphs()[label][1]
    kw = dict(VARIANTS[variant])
    if "mesh" in kw:
        kw["mesh"] = make_eval_mesh(kw["mesh"], device="cpu")
    call = ops.make_batched_eval(g, max_iters=64, device="cpu", **kw)
    got = call(_edge_rows(g, seed=7))
    want = _ref_answer(label, kw.get("with_times", False))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_k1_closure_returns_the_tuple_of_before():
    """K1's closure, its certificate lane from the epilogue, against the
    plain K1 with the clamp, the status rule, the BRAM count and the
    certificate rule as separate steps."""
    _, cg = _graphs()["k15mmtree/aggressive"]
    rows = _edge_rows(cg, seed=3, extra=7)
    call = ops.make_condensed_eval(cg, max_iters=64, with_times=True,
                                   device="cpu")
    lat, bram, status, cert, times = call(rows)
    p = ops_t.get_operands(cg, CPU)
    ct = ops_t.get_cert_tables(cg, CPU)
    d = torch.as_tensor(rows)
    rd, bpi, bpv, bpb, structural = ops_t.depth_operands_plain(p, d)
    out, t = fifo_eval_condensed(
        p.delta, p.seg_start, p.is_read, p.has_data, p.data_idx,
        p.end_bonus, rd, bpi, bpv, bpb, *ops_t.cert_row_operands(p, ct, d),
        max_iters=64, bound=p.bound, with_times=True)
    st = launch_ops._status(out, structural)
    want = (torch.clamp(out[:, 0], min=p.taskless_lat),
            ops_t.bram_count_torch(d, p.widths[None, :]).sum(
                dim=1, dtype=torch.int32), st,
            (out[:, 4] > 0) & (st == CONVERGED), t)
    for a, b in zip((lat, bram, status, cert, times), want):
        assert a.dtype == b.numpy().dtype
        np.testing.assert_array_equal(a, b.numpy())
    assert cert.any() and (status == CONVERGED).any()


def test_launch_spans_say_where_the_operands_were_built():
    """``launch.k2`` and ``launch.k1`` carry ``device_operands``: 0 on the
    CPU, where the plain versions build them."""
    _, cg = _graphs()["k15mmtree/aggressive"]
    k2 = ops.make_batched_eval(cg.raw, max_iters=8, device="cpu")
    k1 = ops.make_condensed_eval(cg, max_iters=8, device="cpu")
    rows = _edge_rows(cg)
    obs.clear()
    obs.enable()
    try:
        k2(rows)
        k1(rows)
    finally:
        obs.disable()
    summ = obs.summary()
    obs.clear()
    for name in ("launch.k2", "launch.k1"):
        assert summ[name]["count"] == 1
        assert summ[name]["attrs"]["device_operands"] == 0


@pytest.mark.parametrize("skip_one", [False, True])
@pytest.mark.parametrize("shards", [None, 2])
def test_span_attribute_counts_the_operand_kernel_launches(monkeypatch,
                                                           shards, skip_one):
    """``device_operands`` reads the depth-operand kernel's launch count:
    1 where it rose once for each operand build of the call (once a
    shard), 0 where one build went another way.  A stand-in for the
    kernel (the plain operands, counted as a launch) plays the card."""
    _, cg = _graphs()["k15mmtree/aggressive"]
    mesh = None if shards is None else make_eval_mesh(shards, device="cpu")
    k2 = ops.make_batched_eval(cg.raw, max_iters=8, device="cpu", mesh=mesh)
    k1 = ops.make_condensed_eval(cg, max_iters=8, device="cpu", mesh=mesh)
    rows = _edge_rows(cg)[:2]
    per_call = shards or 1
    builds = []

    def counted(p, depths):
        first_of_call = len(builds) % per_call == 0
        builds.append(depths.shape[0])
        if not (skip_one and first_of_call):
            launch_ops.depth_operands_device.launches += 1
        return ops_t.depth_operands_plain(p, depths)

    monkeypatch.setattr(ops, "depth_operands", counted)
    obs.clear()
    obs.enable()
    try:
        k2(rows)
        k1(rows)
    finally:
        obs.disable()
    summ = obs.summary()
    obs.clear()
    assert len(builds) == 2 * per_call
    for name in ("launch.k2", "launch.k1"):
        assert summ[name]["count"] == 1
        assert summ[name]["attrs"]["device_operands"] == int(not skip_one)
