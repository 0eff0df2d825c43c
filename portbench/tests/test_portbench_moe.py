"""The ``dsv2_lite_moe.routed_certify_sa`` cell at a CPU size (the small
engine: hidden 64, 8 experts, top-2, 2 PEs, blocks of 16, 64 tokens, on
the numpy backend, since the kernels' plain versions take seconds a
certification here): a sound run is correct and reads the front end's
metrics, the frozen design is the program's, and a stream one token
short, two experts' routes swapped and an unsafe certificate are judged
incorrect."""

import numpy as np
import pytest

from portbench import harness
from portbench.inputs import moe

CELL = "dsv2_lite_moe.routed_certify_sa"
SEED = 2 ** 31 + 54321
SMALL = dict(n_tokens=64, block=16, pes=2, hidden=64, n_experts=8,
             top_k=2, inter=44, n_shared=2)
TINY_BUDGET = 60


def tiny():
    cell = harness.find_cell(CELL)
    cell.config["designs"]["dsv2_lite_moe"] = {
        "factory": "moe.routed_moe_stream", "args": {**SMALL, "seed": 0}}
    cell.traffic["budget"] = TINY_BUDGET
    cell.traffic["eval"]["backend"] = "numpy"
    return cell


def run_tiny(trace: bool = False, seconds: float = 1.0):
    run, state = harness.measure(tiny(), SEED, seconds, trace, "cpu")
    return run, state, harness.result(run, harness.check(run, state))


def test_traced_sound_run_is_correct_and_reads_the_front_end():
    run, state, out = run_tiny(trace=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert all(j["certified"] is not None for j in state["jobs"])
    got = out["metrics"]
    for name in ("trace.us_per_event", "simgraph.us_per_event",
                 "bounds.ms_per_job", "certify.ms_per_job"):
        assert got[name]["value"] > 0, name
    assert got["certify.probes"]["value"] >= 1
    # a CPU run writes no number under a device metric
    assert "idle_share.jobs" not in got and "k2_roofline" not in got


@pytest.mark.parametrize("seed", [0, 7, SEED])
def test_frozen_design_is_the_programs(seed):
    from repro_torch.core.simgraph import build_simgraph
    from repro_torch.core.tracer import collect_trace
    from repro_torch.designs import dsv2_lite_moe_stream
    ours = moe.dsv2_lite_moe_stream(seed=seed)
    prog = dsv2_lite_moe_stream(seed=seed)
    assert [(f.name, f.width, f.group, f.depth) for f in ours.fifos] == \
        [(f.name, f.width, f.group, f.depth) for f in prog.fifos]
    assert [(t.name, t.data_dependent) for t in ours.tasks] == \
        [(t.name, t.data_dependent) for t in prog.tasks]
    np.testing.assert_equal(ours.args, prog.args)
    t0, t1 = collect_trace(ours), collect_trace(prog)
    g0, g1 = build_simgraph(ours, t0), build_simgraph(prog, t1)
    assert g0.n_events == g1.n_events == 33_344
    for field in ("kind", "fifo", "delta", "seg_start", "rank", "data_src",
                  "end_delay"):
        np.testing.assert_array_equal(getattr(g0, field),
                                      getattr(g1, field), err_msg=field)
    assert t0.results == t1.results


def _program_sees(monkeypatch, alter):
    """The program sizes ``alter(args)``'s engine in place of the job's."""
    from repro_torch.core import advisor
    orig = advisor.FifoAdvisor.__init__

    def init(self, design, *args, **kwargs):
        a = design.args
        states, gate = alter(a["states"].copy(), a["gate"].copy())
        design = moe.moe_engine(states, gate, block=a["block"],
                                pes=a["pes"], top_k=a["top_k"],
                                inter=SMALL["inter"],
                                n_shared=SMALL["n_shared"])
        orig(self, design, *args, **kwargs)
    monkeypatch.setattr(advisor.FifoAdvisor, "__init__", init)


def _swap_two_experts(states, gate):
    gate[[2, 5]] = gate[[5, 2]]
    return states, gate


@pytest.mark.parametrize("alter", [lambda s, g: (s[:-1], g),
                                   _swap_two_experts],
                         ids=["one_token_short", "two_experts_swapped"])
def test_a_stream_the_program_saw_altered_is_judged_incorrect(
        monkeypatch, alter):
    _program_sees(monkeypatch, alter)
    _, _, out = run_tiny()
    assert out["failed"] == 0
    assert not out["correct"], out["checks"]


def test_an_unsafe_certificate_is_judged_incorrect(monkeypatch):
    from repro_torch.core import deadlock
    orig = deadlock.certify_min_depths

    def certify(*args, **kwargs):
        res = orig(*args, **kwargs)
        f = int(np.flatnonzero(res.depths > 1)[0])
        res.depths[f] -= 1
        return res
    monkeypatch.setattr(deadlock, "certify_min_depths", certify)
    _, _, out = run_tiny()
    assert out["failed"] == 0
    assert not out["correct"], out["checks"]
