"""Port operand layer parity: every GraphOperands tensor, depth_operands
output, BRAM count and certificate slot of ``repro_torch`` equals the
reference package's jnp arrays element by element, on raw graphs and on
both condensation rungs (the graphs are carried across with
``repro_torch.core.carry`` so both packages see the same graph)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.backends import operands as ref_ops
from repro.core.bram import bram_count_np
from repro.core.condense import condense_auto as ref_condense_auto
from repro.core.simgraph import build_simgraph as ref_build_simgraph
from repro.designs import make_design as ref_make_design
from repro.designs import mult_by_2 as ref_mult_by_2

from repro_torch.core import carry
from repro_torch.core.backends import operands as ops_t
from repro_torch.core.condense import CondensedGraph

CPU = torch.device("cpu")


def _graphs(name):
    """[(label, reference graph, port graph)] for the raw graph and each
    condensation rung of design ``name``."""
    ref_d = ref_mult_by_2(24) if name == "mult_by_2" else ref_make_design(
        name)
    ref_g = ref_build_simgraph(ref_d)
    g = carry.simgraph_from_arrays(carry.graph_fields(ref_g))
    out = [("raw", ref_g, g)]
    for ref_cg in ref_condense_auto(ref_g):
        cg = carry.condensed_from_arrays(
            carry.graph_fields(ref_cg, CondensedGraph), raw=g)
        out.append((ref_cg.tag, ref_cg, cg))
    return out


def _rows(g, n, seed):
    rng = np.random.default_rng(seed)
    u = np.asarray(g.upper_bounds, dtype=np.int64)
    rows = [np.ones_like(u), np.full_like(u, 2), u]
    rows += [rng.integers(1, u + 1) for _ in range(n)]
    return np.stack(rows).astype(np.int32)


def _eq(port, ref, what):
    ref = np.asarray(ref)
    port = port.cpu().numpy() if isinstance(port, torch.Tensor) else port
    assert port.dtype == ref.dtype, (what, port.dtype, ref.dtype)
    np.testing.assert_array_equal(port, ref, err_msg=what)


@pytest.mark.parametrize("name", ["gemm", "FeedForward", "mult_by_2"])
def test_graph_and_depth_operands_equal_reference(name):
    for label, ref_g, g in _graphs(name):
        r = ref_ops.build_operands(ref_g)
        p = ops_t.get_operands(g, CPU)
        for f in dataclasses.fields(ref_ops.GraphOperands):
            a, b = getattr(p, f.name), getattr(r, f.name)
            if isinstance(b, (int, float)):
                assert a == b and type(a) is type(b), f"{label}.{f.name}"
            else:
                _eq(a, b, f"{label}.{f.name}")
        rows = _rows(g, 6, seed=len(label))
        ref_out = jax.jit(lambda d: ref_ops.depth_operands(r, d))(
            jnp.asarray(rows))
        port_out = ops_t.depth_operands(p, torch.as_tensor(rows))
        for what, a, b in zip(("rd_lat_e", "bp_idx", "bp_valid", "bp_base",
                               "structural"), port_out, ref_out):
            _eq(a, b, f"{label}.{what}")


@pytest.mark.parametrize("name", ["gemm", "FeedForward", "mult_by_2"])
def test_cert_tables_and_row_operands_equal_reference(name):
    n_tables = 0
    for label, ref_cg, cg in _graphs(name)[1:]:
        r_ct = ref_ops.build_cert_tables(ref_cg)
        p_ct = ops_t.get_cert_tables(cg, CPU)
        assert (r_ct is None) == (p_ct is None)
        if r_ct is None:
            continue
        n_tables += 1
        for f in dataclasses.fields(ref_ops.CertTables):
            a, b = getattr(p_ct, f.name), getattr(r_ct, f.name)
            if isinstance(b, int):
                assert a == b, f.name
            else:
                _eq(a, b, f"{label}.{f.name}")
        rows = _rows(cg, 6, seed=3)
        r = ref_ops.build_operands(ref_cg)
        ref_slots = jax.jit(lambda d: ref_ops.cert_row_operands(r, r_ct, d))(
            jnp.asarray(rows))
        port_slots = ops_t.cert_row_operands(
            ops_t.get_operands(cg, CPU), p_ct, torch.as_tensor(rows))
        for what, a, b in zip(("src", "dst", "thr", "valid"), port_slots,
                              ref_slots):
            _eq(a, b, f"{label}.cert_{what}")
    if name != "mult_by_2":
        assert n_tables > 0


def test_cert_tables_none_exactly_where_reference():
    """A folded read without a data source has no gather-slot form: both
    packages return None for it (and tables for the untouched graph)."""
    ref_g = ref_build_simgraph(ref_make_design("gemm"))
    ref_cg = ref_condense_auto(ref_g)[0]
    fields = carry.graph_fields(ref_cg, CondensedGraph)
    g = carry.simgraph_from_arrays(carry.graph_fields(ref_g))
    assert fields["vr_src"].size
    fields["vr_src"][0] = -1
    broken = carry.condensed_from_arrays(fields, raw=g)
    ref_cg.vr_src = fields["vr_src"].copy()
    assert ref_ops.build_cert_tables(ref_cg) is None
    assert ops_t.build_cert_tables(broken, CPU) is None


def test_gather_indices_are_range_checked():
    ref_g = ref_build_simgraph(ref_make_design("gemm"))
    fields = carry.graph_fields(ref_g)
    fields["read_evt_flat"][0] = 10 ** 6
    with pytest.raises(ValueError, match="out of"):
        ops_t.build_operands(carry.simgraph_from_arrays(fields), CPU)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bram_count_equals_reference(seed):
    rng = np.random.default_rng(seed)
    widths = rng.choice([1, 8, 16, 18, 32, 36, 64, 72, 100, 512], size=40)
    depths = rng.integers(1, 70000, size=(16, 40))
    depths[0] = 1
    depths[1] = 2
    depths[2] = rng.choice([512, 1024, 2048, 4096, 16384], size=40)
    ref = jax.jit(ref_ops.bram_count_jnp)(
        jnp.asarray(depths, dtype=jnp.int32),
        jnp.asarray(widths[None, :], dtype=jnp.int32))
    port = ops_t.bram_count_torch(
        torch.as_tensor(depths, dtype=torch.int32),
        torch.as_tensor(widths[None, :], dtype=torch.int32))
    _eq(port, ref, "bram")
    np.testing.assert_array_equal(port.numpy(),
                                  bram_count_np(depths, widths[None, :]))
