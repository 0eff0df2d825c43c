"""The front end's spans count their work: ``construct.trace`` and
``construct.simgraph`` record ``events`` (the raw events) and
``construct`` records ``fifos``; the benchmark's per-layer metrics
``trace.us_per_event`` and ``simgraph.us_per_event`` read them, and read
None where a program's spans carry no such attribute."""

import importlib.util
import os

import pytest

from repro_torch import obs
from repro_torch.core import EvalConfig, FifoAdvisor
from repro_torch.designs import make_design, mult_by_2

METRICS = {"trace.us_per_event": "construct.trace",
           "simgraph.us_per_event": "construct.simgraph"}


@pytest.fixture(autouse=True)
def _fresh():
    obs.disable()
    obs.clear()
    yield
    obs.disable()
    obs.clear()


def _reader(name: str):
    path = os.path.join(os.path.dirname(__file__), "..", "portbench",
                        "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _advisors():
    obs.enable()
    try:
        return [FifoAdvisor(d, EvalConfig(backend="numpy"))
                for d in (make_design("gemm"), mult_by_2(16))]
    finally:
        obs.disable()


def test_construction_spans_count_raw_events_and_fifos():
    advs = _advisors()
    summ = obs.summary()
    events = sum(a.trace.n_events for a in advs)
    assert events == sum(a.graph.n_events for a in advs) > 0
    assert summ["construct.trace"]["attrs"] == {"events": events}
    assert summ["construct.simgraph"]["attrs"] == {"events": events}
    assert summ["construct"]["attrs"] == {
        "fifos": sum(a.design.n_fifos for a in advs)}
    assert summ["construct"]["count"] == 2


@pytest.mark.parametrize("name", sorted(METRICS))
def test_front_end_metric_reads_seconds_an_event(name):
    advs = _advisors()
    span = obs.summary()[METRICS[name]]
    events = sum(a.trace.n_events for a in advs)
    got = _reader(name)(None)
    assert got == pytest.approx(1e6 * span["total_s"] / events)
    assert got > 0


@pytest.mark.parametrize("name", sorted(METRICS))
def test_front_end_metric_reads_none_without_events(name):
    read = _reader(name)
    assert read(None) is None              # nothing recorded
    obs.enable()
    with obs.span(METRICS[name]):          # a program without the attribute
        pass
    obs.disable()
    assert obs.summary()[METRICS[name]]["count"] == 1
    assert read(None) is None
