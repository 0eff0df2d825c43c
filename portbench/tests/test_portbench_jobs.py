"""A job of each kind at a tiny budget on the CPU (the kernels' plain
versions): the frozen reference agrees with the program, and a run whose
timed path is broken underneath, or whose answers come from the control,
is judged incorrect."""

import os
import subprocess
import sys

import pytest

from portbench import harness

#: tiny versions of each cell's traffic: what the CPU can run in seconds
TINY = {
    "streamhls.k15mmtree_sa": {"design": "gemm", "budget": 40,
                               "check": {"jobs": 2, "random": 5}},
    "streamhls.fast_campaign": {"designs": ["gemm", "atax"], "budget": 20,
                                "check": {"jobs": 1, "tasks": 4,
                                          "random": 4}},
}
SEED = 2 ** 31 + 12345


def tiny(name: str):
    cell = harness.find_cell(name)
    cell.traffic.update(TINY[name])
    return cell


def run_tiny(name: str, seconds: float = 2.0, trace: bool = False,
             control: bool = False):
    cell = tiny(name)
    run, state = harness.measure(cell, SEED, seconds, trace, "cpu")
    return run, harness.result(run, harness.check(run, state, control))


@pytest.mark.parametrize("name", list(TINY))
def test_sound_run_is_correct(name):
    run, out = run_tiny(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in run.cell.end_to_end}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert list(out)[-1] == "checks"


def test_traced_run_reads_the_counters():
    run, out = run_tiny("streamhls.k15mmtree_sa", trace=True)
    assert out["correct"]
    got = out["metrics"]
    assert got["advisor.rows_per_call"]["value"] >= 1
    assert got["advisor.construct_s"]["value"] > 0
    assert 0 <= got["evaluator.escalated_share"]["value"] <= 1
    # a CPU run writes no number under a device metric
    assert "idle_share.jobs" not in got and "k2_roofline" not in got
    assert run.kernels.launches


def test_untraced_run_installs_no_probe():
    """The measured window of an untraced run calls the program's own
    functions: nothing of the benchmark wraps them."""
    import importlib
    advisor, simulate, ops = (importlib.import_module(m) for m in (
        "repro_torch.core.advisor", "repro_torch.core.simulate",
        "repro_torch.kernels.fifo_eval.ops"))
    before = (ops.fifo_eval, advisor.FifoAdvisor.__init__,
              simulate.BatchedEvaluator.evaluate)
    cell = tiny("streamhls.k15mmtree_sa")
    seen = []
    orig = cell.kind.window

    def window(run, state):
        seen.append((ops.fifo_eval, advisor.FifoAdvisor.__init__,
                     simulate.BatchedEvaluator.evaluate))
        return orig(run, state)
    cell.kind.window = window
    try:
        harness.measure(cell, SEED, 0.5, False, "cpu")
    finally:
        cell.kind.window = orig
    assert seen == [before]


def test_control_is_judged_incorrect():
    run, out = run_tiny("streamhls.k15mmtree_sa", control=True)
    assert not out["correct"]
    assert out["checks"]["lat_gap"]["value"] > 0


def _altered(orig):
    def k2(*args, **kwargs):
        out, times = orig(*args, **kwargs)
        out = out.clone()
        out[:, 0] += 1.0                     # every latency one cycle late
        return out, times
    return k2


def _half(orig):
    def k2(*args, **kwargs):
        out, times = orig(*args, **kwargs)
        c = out.shape[0]
        if c > 1:                            # the second half left out
            out = out.clone()
            out[c // 2:] = out[:c - c // 2].flip(0)
        return out, times
    return k2


def _stale(orig):
    last = {}

    def k2(*args, **kwargs):                 # the previous launch's state
        out, times = orig(*args, **kwargs)
        prev = last.get(out.shape[0])
        last[out.shape[0]] = out
        return (out if prev is None else prev), times
    return k2


@pytest.mark.parametrize("name,fault", [
    ("streamhls.k15mmtree_sa", _altered), ("streamhls.k15mmtree_sa", _half),
    ("streamhls.k15mmtree_sa", _stale)])
def test_broken_k2_is_judged_incorrect(monkeypatch, name, fault):
    from repro_torch.kernels.fifo_eval import ops
    monkeypatch.setattr(ops, "fifo_eval", fault(ops.fifo_eval))
    _, out = run_tiny(name)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", [_altered, _half])
def test_broken_cross_design_dispatch_is_judged_incorrect(monkeypatch,
                                                           fault):
    from repro_torch.kernels.fifo_eval import ops
    monkeypatch.setattr(ops, "fifo_eval_hetero",
                        fault(ops.fifo_eval_hetero))
    _, out = run_tiny("streamhls.fast_campaign")
    assert not out["correct"], out["checks"]


@pytest.mark.chip
def test_a_cell_runs_on_the_card(cuda, tmp_path):
    """One short run of the first cell through the command, on the card."""
    import json
    cell = harness.benchmark()["workloads"][0]["name"]
    p = subprocess.run([sys.executable, str(harness.ROOT / "portbench/run.py"),
                        "--workload", cell, "--seed", str(SEED),
                        "--seconds", "3", "--trace", "0"],
                       capture_output=True, text=True, timeout=1200,
                       env={**os.environ, "TMPDIR": str(tmp_path)})
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"


def test_a_job_that_fails_is_judged_incorrect(monkeypatch):
    from repro_torch.core import advisor
    orig, calls = advisor.FifoAdvisor.run, []

    def run(self, *args, **kwargs):          # the warm-up and then a fault
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("lost")
        return orig(self, *args, **kwargs)
    monkeypatch.setattr(advisor.FifoAdvisor, "run", run)
    _, out = run_tiny("streamhls.k15mmtree_sa")
    assert out["failed"] == 1
    assert not out["correct"] and out["checks"]["wrong"]["value"] >= 1
