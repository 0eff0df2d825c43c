"""Port front-end parity: the trace, every SimGraph array, the condensed
graphs and the EvalConfig of ``repro_torch`` equal the reference package's
on the same designs (exact equality — these are integer tables)."""

import dataclasses
import json

import numpy as np
import pytest

from repro.core.condense import condense_auto as ref_condense_auto
from repro.core.config import EvalConfig as RefEvalConfig
from repro.core.simgraph import build_simgraph as ref_build_simgraph
from repro.core.tracer import collect_trace as ref_collect_trace
from repro.designs import make_design as ref_make_design
from repro.designs import mult_by_2 as ref_mult_by_2

from repro_torch.core import carry
from repro_torch.core.condense import CondensedGraph, condense_auto
from repro_torch.core.config import EvalConfig
from repro_torch.core.simgraph import SimGraph, build_simgraph
from repro_torch.core.tracer import collect_trace
from repro_torch.designs import make_design, mult_by_2

DESIGNS = [
    ("gemm", lambda m: m.make_design("gemm")),
    ("FeedForward", lambda m: m.make_design("FeedForward")),
    ("mvt", lambda m: m.make_design("mvt")),
    ("k15mmseq", lambda m: m.make_design("k15mmseq")),
    ("mult_by_2_24", lambda m: m.mult_by_2(24)),
]


class _Ref:
    make_design = staticmethod(ref_make_design)
    mult_by_2 = staticmethod(ref_mult_by_2)


class _Port:
    make_design = staticmethod(make_design)
    mult_by_2 = staticmethod(mult_by_2)


def _assert_fields_equal(a, b, cls):
    for f in dataclasses.fields(cls):
        if f.name in ("design", "raw"):
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == np.asarray(y).dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


@pytest.mark.parametrize("name,factory", DESIGNS)
def test_trace_and_simgraph_equal_reference(name, factory):
    ref_d, port_d = factory(_Ref), factory(_Port)
    ref_tr, port_tr = ref_collect_trace(ref_d), collect_trace(port_d)
    assert len(ref_tr.tasks) == len(port_tr.tasks)
    for a, b in zip(ref_tr.tasks, port_tr.tasks):
        assert a.task == b.task and a.end_delay == b.end_delay
        for k in ("kinds", "fifos", "deltas"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    np.testing.assert_array_equal(ref_tr.write_counts, port_tr.write_counts)
    np.testing.assert_array_equal(ref_tr.read_counts, port_tr.read_counts)
    ref_g = ref_build_simgraph(ref_d, ref_tr)
    port_g = build_simgraph(port_d, port_tr)
    _assert_fields_equal(port_g, ref_g, SimGraph)
    assert port_g.latency_upper_bound() == ref_g.latency_upper_bound()
    assert port_g.groups() == ref_g.groups()


@pytest.mark.parametrize("name", ["gemm", "k15mmseq"])
def test_condensed_rungs_equal_reference(name):
    ref_cgs = ref_condense_auto(ref_build_simgraph(ref_make_design(name)))
    port_cgs = condense_auto(build_simgraph(make_design(name)))
    assert [c.tag for c in port_cgs] == [c.tag for c in ref_cgs]
    for a, b in zip(port_cgs, ref_cgs):
        _assert_fields_equal(a, b, CondensedGraph)


def test_carry_rebuilds_reference_graphs():
    ref_g = ref_build_simgraph(ref_make_design("gemm"))
    g = carry.simgraph_from_arrays(carry.graph_fields(ref_g))
    _assert_fields_equal(g, ref_g, SimGraph)
    ref_cg = ref_condense_auto(ref_g)[0]
    cg = carry.condensed_from_arrays(
        carry.graph_fields(ref_cg, CondensedGraph), raw=g)
    _assert_fields_equal(cg, ref_cg, CondensedGraph)
    assert cg.compression == ref_cg.compression
    assert cg.latency_upper_bound() == ref_cg.latency_upper_bound()
    with pytest.raises(ValueError, match="missing"):
        carry.simgraph_from_arrays({"kind": ref_g.kind})


def test_eval_config_round_trips():
    cfg = EvalConfig(backend="fixpoint", max_iters=99, condense=None,
                     occupancy_cap=True)
    d = cfg.to_dict()
    assert EvalConfig.from_dict(json.loads(json.dumps(d))) == cfg
    assert set(d) == {f.name for f in dataclasses.fields(RefEvalConfig)}
    # a reference config dict (backend "pallas") loads unchanged
    ref = RefEvalConfig(backend="pallas", max_iters=77, condense=None,
                        occupancy_cap=True)
    port = EvalConfig.from_dict(ref.to_dict())
    assert port.to_dict() == ref.to_dict()
    assert EvalConfig().backend == "cuda"


@pytest.mark.parametrize("field,value", [("shards", 2), ("faults", "{}")])
def test_eval_config_unported_flags_raise(field, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        EvalConfig(**{field: value})
