"""The port's span recorder (:mod:`repro_torch.obs`): off unless a
profiler runs or it is enabled, nested and per-thread parents, self time,
the cap, no torch at import, the clock ``torch.profiler`` stamps its
events with, and a program that answers the same with it on as off while
its spans count what the program's own counters count."""

import dataclasses
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.core import EvalConfig, FifoAdvisor
from repro_torch.core.campaign import Campaign, CampaignSpec
from repro_torch.designs import make_design
from repro_torch.kernels.fifo_eval import ops

#: a cap low enough that the kernels leave rows UNRESOLVED to escalate
MAX_ITERS = 4
#: the spans of one launch of each closure kind, by its dispatch count
LAUNCHES = {"launch.k2": "batched", "launch.k1": "condensed",
            "launch.k2_hetero": "hetero"}
#: each kernel function the closures call, by the span of its launch
KERNELS = {"launch.k2": "fifo_eval", "launch.k1": "fifo_eval_condensed",
           "launch.k2_hetero": "fifo_eval_hetero"}


@pytest.fixture(autouse=True)
def _fresh():
    obs.disable()
    obs.clear()
    yield
    obs.disable()
    obs.clear()


def _names():
    return [r[0] for r in obs.records()]


def test_off_by_default_records_nothing():
    with obs.span("a", rows=3) as s:
        assert not s
        s.set(rows=4)
        with obs.span("b"):
            pass
    assert obs.span("a") is obs.span("b")      # one shared no-op
    assert obs.records() == [] and obs.summary() == {}


def test_records_exactly_while_a_profiler_runs():
    """The rule reads torch's own flag: this pins its name and meaning."""
    flags = sys.modules["torch.autograd.profiler"]
    assert flags._is_profiler_enabled is False
    with obs.span("before"):
        pass
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        assert flags._is_profiler_enabled is True
        with obs.span("started", rows=1):
            pass
    finally:
        prof.stop()
    assert flags._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.span("inside"):
            pass
    with obs.span("after"):
        pass
    assert _names() == ["started", "inside"]


def test_records_between_enable_and_disable():
    obs.enable()
    with obs.span("on") as s:
        assert s
    obs.disable()
    with obs.span("off"):
        pass
    assert _names() == ["on"]


def test_parents_self_time_and_attributes():
    obs.enable()
    with obs.span("outer"):
        with obs.span("inner", rows=2) as s:
            s.set(hits=1)
            with obs.span("leaf"):
                pass
        with obs.span("inner", rows=3):
            pass
    with obs.span("open"):
        recs = obs.records()
        summ = obs.summary()
    assert [(r[0], r[3]) for r in recs] == [
        ("outer", None), ("inner", 0), ("leaf", 1), ("inner", 0),
        ("open", None)]
    assert recs[-1][2] is None and "open" not in summ
    dur = [e - s for _, s, e, _, _ in recs[:4]]
    assert all(d >= 0 for d in dur)
    assert summ["outer"]["total_s"] == dur[0] / 1e9
    assert summ["outer"]["self_s"] == (dur[0] - dur[1] - dur[3]) / 1e9
    assert summ["inner"]["self_s"] == (dur[1] - dur[2] + dur[3]) / 1e9
    assert summ["inner"]["count"] == 2
    assert summ["inner"]["attrs"] == {"rows": 5, "hits": 1}
    assert summ["leaf"]["self_s"] == summ["leaf"]["total_s"]
    for (_, s, e, p, _) in recs[1:4]:          # children inside parents
        assert recs[p][1] <= s <= e <= recs[p][2]


def test_threads_keep_their_own_parents():
    obs.enable()
    gate = threading.Barrier(2, timeout=30)

    def work(tag):
        with obs.span(f"{tag}.outer"):
            gate.wait()                  # both outers open at once
            with obs.span(f"{tag}.inner"):
                gate.wait()
    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    recs = obs.records()
    index = {r[0]: i for i, r in enumerate(recs)}
    assert len(index) == 4
    for tag in "ab":
        assert recs[index[f"{tag}.outer"]][3] is None
        assert recs[index[f"{tag}.inner"]][3] == index[f"{tag}.outer"]


def test_cap_counts_drops(monkeypatch):
    monkeypatch.setattr(obs, "CAP", 3)
    obs.enable()
    with obs.span("a"):
        with obs.span("b"):
            pass
    with obs.span("c"):
        with obs.span("d") as s:         # over the cap: not recorded
            assert not s
            s.set(rows=1)
    with obs.span("e"):
        pass
    assert _names() == ["a", "b", "c"] and obs.dropped() == 2
    assert obs.records()[2][2] is not None
    obs.clear()
    assert obs.dropped() == 0 and obs.records() == []


def test_import_loads_no_torch():
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    code = ("import sys, repro_torch.obs as o\n"
            "with o.span('x') as s: assert not s\n"
            "assert 'torch' not in sys.modules, 'torch loaded'\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": src})
    assert p.returncode == 0, p.stderr


def test_profiler_events_fall_inside_the_span_around_them():
    """The shared clock: an aten op's kineto event lies inside the
    ``time.time_ns`` span of the call that made it."""
    x = torch.ones(64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("op"):
            x.add_(1)
    (_, start, end, _, _), = obs.records()
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "aten::add_"]
    assert events
    for e in events:
        assert start <= e.start_ns() <= e.end_ns() <= end


# ------------------------------------------------ the program, on and off
def _kernel_log(monkeypatch):
    """Wrap the kernel functions the closures call: each launch's rows
    and the iterations they ran (lane 3 of the output)."""
    seen = {name: [] for name in KERNELS}
    for name, attr in KERNELS.items():
        def make(orig, log):
            def wrapped(*args, **kwargs):
                out, times = orig(*args, **kwargs)
                log.append((int(args[6].shape[0]),
                            int(out[:, ops.ITERS_LANE].sum())))
                return out, times
            return wrapped
        monkeypatch.setattr(ops, attr, make(getattr(ops, attr), seen[name]))
    return seen


def _dse():
    adv = FifoAdvisor(make_design("gemm"),
                      EvalConfig(backend="cuda", max_iters=MAX_ITERS),
                      device="cpu")
    return adv, adv.run("grouped_sa", budget=60, seed=3)


def _campaign():
    camp = Campaign(CampaignSpec(
        designs=("gemm", "atax"), optimizers=("grouped_sa",), budget=40,
        seed=1, hetero=True,
        eval=EvalConfig(backend="cuda", max_iters=MAX_ITERS)),
        device="cpu")
    return camp, camp.run()


def _recorded(job, monkeypatch):
    """``job()`` with the recorder off, then on: both results, the spans'
    summary and records, the kernel log and the dispatch counts of the
    run that recorded."""
    off = job()
    seen = _kernel_log(monkeypatch)
    before = dict(ops.DISPATCH_COUNTS)
    obs.enable()
    try:
        on = job()
    finally:
        obs.disable()
    counts = {k: ops.DISPATCH_COUNTS[k] - before.get(k, 0)
              for k in LAUNCHES.values()}
    return off, on, obs.summary(), obs.records(), seen, counts


def _assert_same_result(a, b):
    for f in ("configs", "latency", "bram", "deadlock"):
        x, y = getattr(a.result, f), getattr(b.result, f)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.frontier_points, b.frontier_points)
    np.testing.assert_array_equal(a.frontier_configs, b.frontier_configs)
    assert a.hypervolume() == b.hypervolume()
    assert a.result.n_evals == b.result.n_evals


def _assert_launches(summ, recs, seen, counts):
    """One ``launch.*`` span a dispatch; its rows and iterations are
    those the kernel launched; its children are the launch's phases."""
    for name, kind in LAUNCHES.items():
        got = summ.get(name, {"count": 0, "attrs": {}})
        assert got["count"] == counts[kind] == len(seen[name]), name
        if seen[name]:
            assert got["attrs"]["rows"] == sum(r for r, _ in seen[name])
            assert got["attrs"]["iters"] == sum(i for _, i in seen[name])
    for n, _, _, p, _ in recs:
        if n in ("launch.operands", "launch.kernel", "launch.readback"):
            assert recs[p][0] in LAUNCHES, n


def test_dse_answers_alike_and_spans_count_its_work(monkeypatch):
    (adv0, off), (adv1, on), summ, recs, seen, counts = _recorded(
        _dse, monkeypatch)
    _assert_same_result(off, on)
    assert dataclasses.asdict(adv0.evaluator.stats) == \
        dataclasses.asdict(adv1.evaluator.stats)
    stats = adv1.evaluator.stats
    assert stats.n_fallbacks > 0
    assert summ["escalation"]["attrs"]["rows"] == stats.n_fallbacks
    # one worklist solve an escalated row (condensation solves probes too)
    assert sum(1 for n, _, _, p, _ in recs if n == "worklist.solve"
               and recs[p][0] == "escalation") == stats.n_fallbacks
    assert summ["evaluate"]["attrs"]["rows"] == stats.n_configs
    assert summ["construct"]["count"] == 1
    for phase in ("trace", "simgraph", "evaluator", "baselines"):
        assert summ[f"construct.{phase}"]["count"] == 1
    assert summ["optimizer.step"]["attrs"]["rows"] == \
        summ["fulfill"]["attrs"]["rows"] == on.result.configs.shape[0]
    assert summ["fulfill"]["attrs"]["misses"] == on.result.n_evals
    assert counts["batched"] > 0 and counts["condensed"] > 0
    _assert_launches(summ, recs, seen, counts)


def test_hetero_campaign_answers_alike_and_spans_count_its_work(
        monkeypatch):
    (c0, off), (c1, on), summ, recs, seen, counts = _recorded(
        _campaign, monkeypatch)
    assert list(off.keys()) == list(on.keys())
    for k in off.keys():
        _assert_same_result(off[k], on[k])
    for f in ("n_dispatches", "n_rows", "n_pad_rows", "n_fallbacks"):
        assert getattr(c0.hetero.stats, f) == getattr(c1.hetero.stats, f)
    for k in c0.designs:
        assert dataclasses.asdict(c0.designs[k].evaluator.stats) == \
            dataclasses.asdict(c1.designs[k].evaluator.stats)
    fallbacks = c1.hetero.stats.n_fallbacks + sum(
        d.evaluator.stats.n_fallbacks for d in c1.designs.values())
    assert c1.hetero.stats.n_fallbacks > 0
    assert summ["escalation"]["attrs"]["rows"] == fallbacks
    assert summ["campaign.construct"]["count"] == 1
    assert summ["construct"]["count"] == len(c1.designs)
    assert summ["campaign.round"]["count"] == c1.round
    assert summ["hetero.stack"]["count"] == c1.hetero.stats.n_dispatches
    assert counts["hetero"] == c1.hetero.stats.n_dispatches
    assert summ["launch.k2_hetero"]["attrs"]["rows"] == \
        c1.hetero.stats.n_rows + c1.hetero.stats.n_pad_rows
    _assert_launches(summ, recs, seen, counts)


def _certified_advisor():
    from repro_torch.designs import flowgnn_pna_stream, molhiv_stream
    d = flowgnn_pna_stream(molhiv_stream(4, 5), seed=5)
    return FifoAdvisor(d, EvalConfig(backend="cuda", local_bounds=True,
                                     channel_bounds=True,
                                     certified_floor=True), device="cpu")


def test_bounds_and_certification_spans_nest_under_the_baselines():
    obs.enable()
    adv = _certified_advisor()
    obs.disable()
    recs = obs.records()
    summ = obs.summary()
    cert, bounds = adv.certification, adv.channel_bounds()
    for name in ("local_bounds", "bounds", "certify"):
        assert summ[name]["count"] == 1, name
        (i,) = [k for k, r in enumerate(recs) if r[0] == name]
        assert recs[recs[i][3]][0] == "construct.baselines", name
    F = adv.graph.n_fifos
    assert summ["local_bounds"]["attrs"] == {"fifos": F}
    assert summ["bounds"]["attrs"] == {
        "fifos": F, "tight": int(np.sum(bounds.lower == bounds.upper))}
    assert summ["certify"]["attrs"] == {
        "probes": cert.n_probes, "cache_hits": cert.n_cache_hits,
        "pinned": int(np.sum(cert.depths > 1))}
    assert cert.n_probes >= 1 and summ["certify"]["attrs"]["pinned"] >= 1


def test_bounds_and_certification_record_nothing_while_off():
    adv = _certified_advisor()
    assert adv.certification is not None
    assert obs.records() == []
