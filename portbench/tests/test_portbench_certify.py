"""``certify.launches``: the evaluator calls a certification makes, read
from the ``launches`` attribute of the program's ``certify`` spans.  A
traced CPU run of the routed cell searches row by row, so it reads the
probe count; spans without the attribute (a program that does not count
them) read nothing.  On the card the routed cell's certification
bisects three levels a launch, and must equal the CPU's one-row search
in everything but its wall time."""

import dataclasses

import pytest

from portbench import harness
from repro_torch import obs
from test_portbench_moe import run_tiny

METRIC = "certify.launches"
#: the routed cell's stream, as its warm-up builds it
STREAM = dict(n_tokens=1024, block=256, pes=8, seed=23)
#: evaluator calls a certification of that stream may make on the card:
#: its ~500 bisection steps fall in ~195 three-level trees (counted on
#: the CPU), plus the start, shortcut and final probes
MAX_LAUNCHES = 210


def test_reads_the_launches_attribute_and_nothing_without_it():
    reader = harness.metric_reader(METRIC)
    obs.clear()
    assert reader.read(None) is None
    obs.enable()
    try:
        with obs.span("certify") as s:
            s.set(probes=4, cache_hits=1)
        assert reader.read(None) is None
        obs.clear()
        for n in (3, 6):
            with obs.span("certify") as s:
                s.set(probes=9, launches=n, spec_rows=1)
    finally:
        obs.disable()
    assert reader.read(None) == 4.5
    obs.clear()


def test_traced_cpu_run_of_the_routed_cell_launches_once_a_probe():
    obs.clear()
    run, state, out = run_tiny(trace=True)
    assert out["correct"], out["checks"]
    assert METRIC in {m["name"] for m in run.cell.per_layer}
    got = out["metrics"]
    assert got[METRIC]["value"] == got["certify.probes"]["value"] >= 1
    obs.clear()


@pytest.mark.chip
def test_card_certification_equals_the_cpu_one_row_search(cuda):
    from repro_torch.core import EvalConfig, FifoAdvisor
    from repro_torch.designs import dsv2_lite_moe_stream
    design = dsv2_lite_moe_stream(**STREAM)
    cfg = dict(local_bounds=True, channel_bounds=True, certified_floor=True)
    want = FifoAdvisor(design, EvalConfig(backend="numpy", **cfg),
                       device="cpu").certification
    obs.clear()
    obs.enable()
    try:
        got = FifoAdvisor(design, EvalConfig(backend="cuda", **cfg),
                          device=cuda).certification
        attrs = obs.summary()["certify"]["attrs"]
    finally:
        obs.disable()
        obs.clear()
    for f in dataclasses.fields(want):
        if f.name == "wall_s":
            continue
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert type(a) is type(b), f.name
        assert getattr(a, "dtype", None) == getattr(b, "dtype", None), f.name
        assert (a == b).all() if hasattr(b, "shape") else a == b, f.name
    assert attrs["probes"] == want.n_probes
    assert attrs["launches"] <= MAX_LAUNCHES, attrs
