"""The port's fault plan and the pool recovery it exercises, against the
reference package.

A :class:`FaultPlan` has the reference's JSON format, kinds, precedence
(``EvalConfig.faults`` over ``REPRO_FAULTS``) and seeded schedules, so
one plan file drives both packages.  Under every pool fault — worker
crashes, hangs past the receive deadline, a lane death in the middle of
``submit``, inline escalation after the retries, a wedged worker at
``close`` — the pooled results are bit-identical to the fault-free
evaluation (the port's numpy evaluator and the reference's), and no
worker outlives the pool.  The service's kinds wait for ROADMAP P12."""

import multiprocessing as mp
import threading

import numpy as np
import pytest

from repro.core import EvalConfig as RefEvalConfig
from repro.core.faults import FAULT_KINDS as REF_FAULT_KINDS
from repro.core.faults import FaultPlan as RefFaultPlan
from repro.core.faults import resolve_plan as ref_resolve_plan
from repro.core.simgraph import build_simgraph as ref_build_simgraph
from repro.core.simulate import BatchedEvaluator as RefEvaluator
from repro.designs import make_design as ref_make_design

from repro_torch.core import BatchedEvaluator, EvalConfig
from repro_torch.core.campaign import Campaign, CampaignSpec
from repro_torch.core.campaign.pool import MAX_OUTSTANDING, WorkerPool
from repro_torch.core.faults import (FAULT_KINDS, Fault, FaultPlan,
                                     check_worker_faults, resolve_plan)
from repro_torch.core.simgraph import build_simgraph
from repro_torch.designs import make_design

BUDGET = 40


# ----------------------------------------------------------- plan basics
def test_fault_plan_json_roundtrips_with_the_reference():
    plan = FaultPlan([Fault("crash_worker", at=1, lane=0),
                      Fault("hang_eval", at=2, target="gemm", value=0.5),
                      Fault("delay_dispatch", at=3, value=0.01)])
    ref = RefFaultPlan.from_json(plan.to_json())
    assert ref.to_json() == plan.to_json()
    assert [f.to_dict() for f in ref.faults] == \
        [f.to_dict() for f in plan.faults]
    back = FaultPlan.from_json(ref.to_json())
    assert back.faults == plan.faults
    assert back.n_fired == 0 and len(back) == 3
    with pytest.raises(ValueError, match="unknown fault kind"):
        Fault("segfault_everything")
    assert FAULT_KINDS == REF_FAULT_KINDS


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_random_plan_equals_the_reference(seed):
    got = FaultPlan.random(seed, n_lanes=3, n_jobs=4)
    want = RefFaultPlan.random(seed, n_lanes=3, n_jobs=4)
    assert got.to_json() == want.to_json()


def test_take_is_fire_once_with_wildcards():
    plan = FaultPlan([Fault("delay_dispatch", at=3, lane=-1, value=0.01),
                      Fault("crash_worker", at=0, lane=1),
                      Fault("hang_worker", at=2, lane=1, value=1.0)])
    assert plan.take("delay_dispatch", lane=7, at=0) is None
    f = plan.take("delay_dispatch", lane=7, at=3)
    assert f is not None and f.value == 0.01
    assert plan.take("delay_dispatch", lane=7, at=3) is None  # fire-once
    assert plan.worker_payload(0) == []
    assert [d["kind"] for d in plan.worker_payload(1)] == [
        "crash_worker", "hang_worker"]
    assert plan.consume_worker_fault(1).kind == "crash_worker"
    assert [d["kind"] for d in plan.worker_payload(1)] == ["hang_worker"]
    assert plan.consume_worker_fault(1).kind == "hang_worker"
    assert plan.consume_worker_fault(1) is None
    assert plan.n_fired == 3 and plan.all_fired


def test_resolve_plan_config_beats_env(tmp_path):
    cfg_json = FaultPlan([Fault("crash_save", at=0)]).to_json()
    env_json = FaultPlan([Fault("drop_conn", at=5)]).to_json()
    for resolve, cfg in ((resolve_plan, EvalConfig(faults=cfg_json)),
                         (ref_resolve_plan, RefEvalConfig(faults=cfg_json))):
        plan = resolve(cfg, env={"REPRO_FAULTS": env_json})
        assert plan.faults[0].kind == "crash_save"
        plan = resolve(None, env={"REPRO_FAULTS": env_json})
        assert plan.faults[0].kind == "drop_conn"
        path = tmp_path / "plan.json"
        path.write_text(env_json)
        plan = resolve(None, env={"REPRO_FAULTS": f"@{path}"})
        assert plan.faults[0].at == 5
        assert resolve(None, env={}) is None
    # one plan file drives both packages
    assert resolve_plan(None, env={"REPRO_FAULTS": f"@{path}"}).to_json() \
        == ref_resolve_plan(None, env={"REPRO_FAULTS": f"@{path}"}) \
        .to_json()
    assert EvalConfig(backend="numpy", faults=cfg_json).to_dict() == \
        RefEvalConfig(backend="numpy", faults=cfg_json).to_dict()


def test_worker_faults_ignore_other_jobs():
    check_worker_faults([{"kind": "crash_worker", "at": 3, "lane": 0,
                          "target": "", "value": 0.0}], job_index=0)


# ---------------------------------------------------- pool fault tolerance
@pytest.fixture(scope="module")
def gemm_jobs():
    """A gemm graph, a depth matrix, and the fault-free results (equal in
    the port's and the reference's numpy evaluators)."""
    g = build_simgraph(make_design("gemm"))
    u = g.upper_bounds
    rng = np.random.default_rng(0)
    m = np.concatenate([
        np.maximum(u, 2)[None, :],
        np.full((1, g.n_fifos), 2),
        np.maximum(2, (u * rng.uniform(0.1, 1.0, (6, g.n_fifos))
                       ).astype(np.int64))])
    ref = BatchedEvaluator(
        g, EvalConfig(backend="numpy", max_iters=64)).evaluate(m)
    want = RefEvaluator(ref_build_simgraph(ref_make_design("gemm")),
                        RefEvalConfig(backend="numpy", max_iters=64)
                        ).evaluate(m)
    for a, b in zip(ref, want):
        np.testing.assert_array_equal(a, b)
    return g, m, ref


def _pool_jobs(m, n_lanes):
    chunks = np.array_split(m, 4, axis=0)
    return [(j % n_lanes, "gemm", c, None) for j, c in enumerate(chunks)]


def _concat(results):
    return tuple(np.concatenate([r[k] for r in results]) for k in range(3))


def _assert_equal(results, ref):
    for a, b in zip(_concat(results), ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_pool_fault_free_equals_inline(gemm_jobs):
    g, m, ref = gemm_jobs
    with WorkerPool(2, max_iters=64, graphs={"gemm": g}) as pool:
        _assert_equal(pool.run_jobs(_pool_jobs(m, 2)), ref)
        assert pool.stats["respawns"] == 0
    assert mp.active_children() == []


def test_pool_crash_respawn_bit_identical(gemm_jobs):
    g, m, ref = gemm_jobs
    plan = FaultPlan([Fault("crash_worker", at=0, lane=0),
                      Fault("crash_worker", at=0, lane=1)])
    with WorkerPool(2, max_iters=64, graphs={"gemm": g}, faults=plan,
                    recv_timeout_s=5.0) as pool:
        results = pool.run_jobs(_pool_jobs(m, 2))
        stats = dict(pool.stats)
    _assert_equal(results, ref)
    assert stats["respawns"] >= 2 and stats["requeued"] >= 2
    assert plan.all_fired
    assert mp.active_children() == []


def test_pool_hang_detected_and_requeued(gemm_jobs):
    g, m, ref = gemm_jobs
    plan = FaultPlan([Fault("hang_worker", at=0, lane=0, value=30.0),
                      Fault("delay_dispatch", at=1, value=0.01)])
    with WorkerPool(1, max_iters=64, graphs={"gemm": g}, faults=plan,
                    recv_timeout_s=0.3) as pool:
        results = pool.run_jobs(_pool_jobs(m, 1))
        stats = dict(pool.stats)
    _assert_equal(results, ref)
    assert stats["respawns"] >= 1 and stats["requeued"] >= 1
    assert plan.all_fired
    assert mp.active_children() == []


def test_submit_backpressure_survives_lane_death(gemm_jobs):
    g, m, ref = gemm_jobs
    plan = FaultPlan([Fault("hang_worker", at=0, lane=0, value=30.0)])
    jobs = [(0, "gemm", m[i % len(m)][None, :], None)
            for i in range(MAX_OUTSTANDING + 4)]
    done = {}

    def run():
        with WorkerPool(1, max_iters=64, graphs={"gemm": g}, faults=plan,
                        recv_timeout_s=0.5) as pool:
            done["results"] = pool.run_jobs(jobs)
            done["stats"] = dict(pool.stats)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=90)
    assert not t.is_alive(), \
        "submit() backpressure wait hung after a lane death"
    assert done["stats"]["respawns"] >= 1
    for i, (lat, bram, dead, _) in enumerate(done["results"]):
        assert lat[0] == ref[0][i % len(m)]
        assert bram[0] == ref[1][i % len(m)]
        assert dead[0] == ref[2][i % len(m)]
    assert mp.active_children() == []


def test_pool_inline_escalation_after_max_retries(gemm_jobs):
    g, m, ref = gemm_jobs
    plan = FaultPlan([Fault("crash_worker", at=0, lane=0)] * 3)
    with WorkerPool(1, max_iters=64, graphs={"gemm": g}, faults=plan,
                    recv_timeout_s=5.0, max_retries=1) as pool:
        results = pool.run_jobs(_pool_jobs(m, 1))
        stats = dict(pool.stats)
    _assert_equal(results, ref)
    assert stats["escalated"] >= 1
    assert mp.active_children() == []


def test_pool_close_escalates_on_wedged_worker(gemm_jobs):
    g, m, _ = gemm_jobs
    plan = FaultPlan([Fault("hang_worker", at=0, lane=0, value=60.0)])
    pool = WorkerPool(1, max_iters=64, graphs={"gemm": g}, faults=plan,
                      recv_timeout_s=30.0)
    pool.join_timeout_s = 0.2
    pool.submit(_pool_jobs(m, 1))   # lane is now asleep mid-"evaluation"
    pool.close()                    # join times out -> terminate -> kill
    assert mp.active_children() == []


def test_campaign_frontiers_identical_under_crashes():
    """Two tasks, so one lands on lane 1 — the pool worker (lane 0 is
    the parent process itself); the plan rides in ``EvalConfig``."""
    spec = dict(designs=("gemm",),
                optimizers=("grouped_sa", "grouped_random"),
                budget=BUDGET, seed=0)
    inline = Campaign(CampaignSpec(workers=0,
                                   eval=EvalConfig(backend="numpy"),
                                   **spec), device="cpu").run()
    plan_json = FaultPlan([Fault("crash_worker", at=0)]).to_json()
    camp = Campaign(CampaignSpec(workers=1,
                                 eval=EvalConfig(backend="numpy",
                                                 faults=plan_json),
                                 **spec), device="cpu")
    chaotic = camp.run()
    for k in inline.keys():
        np.testing.assert_array_equal(chaotic[k].frontier_points,
                                      inline[k].frontier_points)
        np.testing.assert_array_equal(chaotic[k].result.latency,
                                      inline[k].result.latency)
        np.testing.assert_array_equal(chaotic[k].result.configs,
                                      inline[k].result.configs)
    assert camp.pool_stats["respawns"] >= 1
    assert camp.faults.all_fired
    assert mp.active_children() == []
