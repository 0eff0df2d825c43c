"""The per-layer metrics that read the program's own spans
(``repro_torch.obs``): a tiny traced run of each cell reads every one of
them, an untraced run records nothing, and on the card every K2 launch
the profiler saw lies inside the program's span of that launch."""

import bisect
import math

import pytest

from portbench import harness, probe
from repro_torch import obs
from test_portbench_jobs import SEED, TINY, run_tiny, tiny

#: the metrics that read the program's spans
SPAN_METRICS = ("escalation.ms_per_row", "escalation.window_share",
                "launch.host_us", "k2.iters_per_row",
                "optimizer.host_ms_per_row")
#: the program's spans of a K2 launch
K2_SPANS = ("launch.k2", "launch.k2_hetero")


def _read(run):
    return {m: harness.metric_reader(m).read(run) for m in SPAN_METRICS}


@pytest.mark.parametrize("name", list(TINY))
def test_traced_run_reads_the_program_spans(name):
    obs.clear()
    run, out = run_tiny(name, trace=True)
    assert out["correct"], out["checks"]
    got = _read(run)
    for m in SPAN_METRICS:
        assert m in {x["name"] for x in run.cell.per_layer}
        if m == "escalation.ms_per_row" and got[m] is None:
            # a tiny run may escalate no row: nothing to divide by
            assert got["escalation.window_share"] == 0
            continue
        assert got[m] is not None and math.isfinite(got[m]), (m, got[m])
        assert got[m] >= 0
        assert out["metrics"][m]["value"] == got[m]
    assert got["escalation.window_share"] <= 1
    assert got["k2.iters_per_row"] >= 1


@pytest.mark.parametrize("name", list(TINY))
def test_untraced_run_records_no_span(name):
    obs.clear()
    run, out = run_tiny(name, trace=False)
    assert out["correct"]
    assert obs.records() == []
    assert not set(SPAN_METRICS) & set(out["metrics"])
    assert all(v is None for v in _read(run).values())


@pytest.mark.chip
@pytest.mark.parametrize("name", list(TINY))
def test_every_k2_device_event_lies_in_its_launch_span(cuda, name,
                                                        monkeypatch):
    """The program's spans and the profiler's device events share one
    clock: each K2 kernel of a traced window ran inside the host span of
    the launch that enqueued it and read it back."""
    seen = []

    def events(prof):
        got = orig(prof)
        seen.extend(got)
        return got
    orig = probe.device_events
    monkeypatch.setattr(probe, "device_events", events)
    obs.clear()
    run, _ = harness.measure(tiny(name), SEED, 3.0, True, cuda)
    spans = sorted((s, e) for n, s, e, _, _ in obs.records()
                   if n in K2_SPANS and e is not None)
    starts = [s for s, _ in spans]
    k2 = [(s, e) for n, s, e in seen
          if probe.KERNEL_NAMES["k2"] in n]
    assert k2 and spans
    for s, e in k2:
        i = bisect.bisect_right(starts, s) - 1
        assert i >= 0 and spans[i][0] <= s <= e <= spans[i][1], (s, e)
