"""``launch.device_operands_share``: the share of K2 and K1 launches whose
depth operands the program built with its depth-operand kernel.  A traced
CPU run reads 0 (the plain versions build them there), a traced run on
the card reads 1, and spans that carry no such attribute (a program
without the kernel) read nothing."""

import pytest

from portbench import harness
from repro_torch import obs
from test_portbench_jobs import SEED, TINY, run_tiny, tiny

METRIC = "launch.device_operands_share"


@pytest.mark.parametrize("name", list(TINY))
def test_traced_cpu_run_reads_zero(name):
    obs.clear()
    run, out = run_tiny(name, trace=True)
    assert out["correct"], out["checks"]
    assert METRIC in {m["name"] for m in run.cell.per_layer}
    assert out["metrics"][METRIC]["value"] == 0.0


def test_spans_without_the_attribute_read_nothing():
    reader = harness.metric_reader(METRIC)
    obs.clear()
    assert reader.read(None) is None
    obs.enable()
    try:
        with obs.span("launch.k2", rows=1) as s:
            s.set(iters=1)
        with obs.span("launch.k2_hetero", rows=1) as s:
            s.set(iters=1)
    finally:
        obs.disable()
    assert reader.read(None) is None
    obs.clear()


@pytest.mark.chip
@pytest.mark.parametrize("name", list(TINY))
def test_traced_card_run_reads_one(cuda, name):
    obs.clear()
    run, state = harness.measure(tiny(name), SEED, 3.0, True, cuda)
    assert harness.metric_reader(METRIC).read(run) == 1.0
