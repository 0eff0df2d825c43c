"""The program's device escalation tier on the card: a traced tiny window
of each cell on k15mmtree, whose rows escalate, answers row for row as
the same window with the worklist alone; the tier settled the escalated
rows (``escalation.device_share``); and every K2 device event of the
window, the tier's launches included, lies inside the program's span of
the launch that enqueued it, up to a shift of the profiler's device clock
that its neighbouring launches share (:func:`clock_shifts`)."""

import numpy as np
import pytest

from portbench import harness, probe
from repro_torch import obs
from test_portbench_jobs import SEED
from test_portbench_program_spans import K2_SPANS

#: tiny versions of each cell's traffic in which k15mmtree rows escalate
#: (the fast_campaign cell's escalated rows are all k15mmtree's)
TIER_TINY = {
    "streamhls.k15mmtree_sa": {"design": "k15mmtree", "budget": 200,
                               "check": {"jobs": 1, "random": 4}},
    "streamhls.fast_campaign": {"designs": ["k15mmtree", "gemm"],
                                "budget": 100,
                                "check": {"jobs": 1, "tasks": 4,
                                          "random": 4}},
}


#: the profiler's device clock against the host's, on the H100: in most
#: windows every kernel fits its span under shifts of about -0.6 to +1.0
#: ms, but in some the device clock drifts ~1 ms a second, so that late
#: in a 3 s window kernels start up to ~4 ms before their launch began
MAX_SHIFT_NS = 10_000_000
#: launches around each one that must share its clock shift
NEIGHBOURS = 16


def clock_shifts(spans, kernels, width: int = NEIGHBOURS):
    """For the ``i``-th launch, the shifts of the device's clock (ns, an
    interval ``(lo, hi)``, empty where ``lo > hi``) under which each
    kernel of the ``width + 1`` launches around it lies inside the span
    of its own launch: one launch, one kernel, in the order of one
    stream."""
    lo = [s0 - s for (s0, _), (s, _) in zip(spans, kernels)]
    hi = [e0 - e for (_, e0), (_, e) in zip(spans, kernels)]
    h = width // 2
    return [(max(lo[max(0, i - h):i + h + 1]),
             min(hi[max(0, i - h):i + h + 1])) for i in range(len(lo))]


def _cell(name: str):
    cell = harness.find_cell(name)
    cell.traffic.update(TIER_TINY[name])
    return cell


def _window(name: str, trace: bool, device: str, monkeypatch):
    """A 3 s window: the run, its answers and judgement, the program's
    spans and (traced) the profiler's device events.  An untraced window
    records the spans with ``obs.enable()``."""
    seen = []
    orig = probe.device_events

    def events(prof):
        got = orig(prof)
        seen.extend(got)
        return got
    monkeypatch.setattr(probe, "device_events", events)
    obs.clear()
    if not trace:
        obs.enable()
    try:
        run, state = harness.measure(_cell(name), SEED, 3.0, trace, device)
    finally:
        obs.disable()
    out = harness.result(run, harness.check(run, state))
    return run, state, out, obs.records(), seen


def _rows_of(job):
    """Every answer of a job, task by task for a campaign."""
    for task in job.get("tasks", [job]):
        yield from (task[k] for k in ("configs", "lat", "bram", "dead",
                                      "frontier", "frontier_configs"))
        yield np.asarray([task["hv"]])
        for b in task["baselines"]:
            yield from (np.asarray(x) for x in b)


def _tier_launches(recs):
    return [r for r in recs if r[0] in K2_SPANS and r[3] is not None
            and recs[r[3]][0] == "escalation"]


@pytest.mark.chip
@pytest.mark.parametrize("name", list(TIER_TINY))
def test_tier_settles_escalated_rows_as_the_worklist_does(cuda, name,
                                                          monkeypatch):
    from repro_torch.core.backends.dispatch import HeteroDispatcher
    from repro_torch.core.backends.pallas import CudaBackend
    run, state, out, recs, seen = _window(name, True, cuda, monkeypatch)
    assert out["correct"], out["checks"]
    share = harness.metric_reader("escalation.device_share").read(run)
    assert share is not None and share > 0.9, share
    assert out["metrics"]["escalation.device_share"]["value"] == share
    assert _tier_launches(recs)

    # every K2 kernel ran inside the host span of the launch that
    # enqueued it and read it back, the tier's launches among them
    spans = sorted((s, e) for n, s, e, _, _ in recs
                   if n in K2_SPANS and e is not None)
    k2 = sorted((s, e) for n, s, e in seen
                if probe.KERNEL_NAMES["k2"] in n)
    assert k2 and len(k2) == len(spans), (len(k2), len(spans))
    for i, (lo, hi) in enumerate(clock_shifts(spans, k2)):
        assert lo <= hi and lo <= MAX_SHIFT_NS and hi >= -MAX_SHIFT_NS, \
            (i, lo, hi)

    # the same window with the worklist alone: the same answers
    for cls in (CudaBackend, HeteroDispatcher):
        monkeypatch.setattr(cls, "device_escalation", False)
    run0, state0, out0, recs0, _ = _window(name, False, cuda, monkeypatch)
    assert out0["correct"], out0["checks"]
    assert any(r[0] == "escalation" for r in recs0)
    assert not _tier_launches(recs0)
    jobs = list(zip(state["jobs"], state0["jobs"]))
    assert jobs
    for a, b in jobs:
        assert a["seed"] == b["seed"]
        for x, y in zip(_rows_of(a), _rows_of(b), strict=True):
            np.testing.assert_array_equal(x, y)
    for key in ("batch_stats", "hetero_stats"):    # routing kept
        for a, b in zip(run.counters.get(key, []),
                        run0.counters.get(key, [])):
            assert a.n_fallbacks == b.n_fallbacks
