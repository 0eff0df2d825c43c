"""The ``flowgnn_pna.certify_sa`` cell at a CPU size (the kernels' plain
versions): a sound run is correct, the frozen design is the program's,
an unsafe or non-minimal certificate and a stream the program saw short
are judged incorrect, and the new per-layer metrics read numbers."""

import numpy as np
import pytest

from portbench import harness
from portbench.inputs import ddcf

CELL = "flowgnn_pna.certify_sa"
SEED = 2 ** 31 + 12345
#: what the CPU runs in seconds: 4 molecules a job, a small budget
TINY_MOLECULES = 4
TINY_BUDGET = 60


def tiny():
    cell = harness.find_cell(CELL)
    cell.config["designs"]["molhiv_pna"]["args"]["n_molecules"] = \
        TINY_MOLECULES
    cell.traffic["budget"] = TINY_BUDGET
    return cell


def run_tiny(trace: bool = False, seconds: float = 2.0):
    run, state = harness.measure(tiny(), SEED, seconds, trace, "cpu")
    return run, state, harness.result(run, harness.check(run, state))


def test_sound_run_is_correct():
    run, state, out = run_tiny()
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"job_s", "setup_s"}
    assert len({j["seed"] for j in state["jobs"]}) == len(state["jobs"])
    assert all(j["certified"] is not None for j in state["jobs"])


@pytest.mark.parametrize("seed", [0, 7, SEED])
def test_frozen_design_is_the_programs(seed):
    from repro_torch.core.simgraph import build_simgraph
    from repro_torch.core.tracer import collect_trace
    from repro_torch.designs import flowgnn_pna_stream, molhiv_stream
    ours = ddcf.molhiv_pna(n_molecules=6, lanes=4, seed=seed)
    prog = flowgnn_pna_stream(molhiv_stream(6, seed), lanes=4, seed=seed)
    assert [(f.name, f.width, f.group, f.depth) for f in ours.fifos] == \
        [(f.name, f.width, f.group, f.depth) for f in prog.fifos]
    assert [(t.name, t.data_dependent) for t in ours.tasks] == \
        [(t.name, t.data_dependent) for t in prog.tasks]
    np.testing.assert_equal(ours.args, prog.args)
    t0, t1 = collect_trace(ours), collect_trace(prog)
    g0, g1 = build_simgraph(ours, t0), build_simgraph(prog, t1)
    for field in ("kind", "fifo", "delta", "seg_start", "rank", "data_src",
                  "end_delay"):
        np.testing.assert_array_equal(getattr(g0, field),
                                      getattr(g1, field), err_msg=field)
    np.testing.assert_equal(t0.results, t1.results)


def _certificate_altered(monkeypatch, step: int):
    from repro_torch.core import deadlock
    orig = deadlock.certify_min_depths

    def certify(*args, **kwargs):
        res = orig(*args, **kwargs)
        f = int(np.flatnonzero(res.depths > 1)[0])
        res.depths[f] += step
        return res
    monkeypatch.setattr(deadlock, "certify_min_depths", certify)


@pytest.mark.parametrize("step", [-1, 1], ids=["unsafe", "not_minimal"])
def test_altered_certificate_is_judged_incorrect(monkeypatch, step):
    _certificate_altered(monkeypatch, step)
    _, _, out = run_tiny()
    assert out["failed"] == 0
    assert not out["correct"], out["checks"]


def test_a_stream_seen_short_is_judged_incorrect(monkeypatch):
    from repro_torch.core import advisor
    orig = advisor.FifoAdvisor.__init__

    def init(self, design, *args, **kwargs):  # one molecule dropped
        a = design.args
        design = ddcf.flowgnn_pna_stream(a["graphs"][1:], lanes=a["lanes"],
                                         seed=a["seed"])
        orig(self, design, *args, **kwargs)
    monkeypatch.setattr(advisor.FifoAdvisor, "__init__", init)
    _, _, out = run_tiny()
    assert out["failed"] == 0
    assert not out["correct"], out["checks"]


def test_traced_run_reads_the_new_metrics():
    run, _, out = run_tiny(trace=True)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    assert got["bounds.ms_per_job"]["value"] > 0
    assert got["certify.ms_per_job"]["value"] > 0
    assert got["certify.probes"]["value"] >= 1
    # a CPU run writes no number under a device metric
    assert "idle_share.jobs" not in got and "k2_roofline" not in got
    assert "k1_roofline" not in [m["name"] for m in run.cell.per_layer]
