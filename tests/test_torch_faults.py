"""The port's fault plan and the pool recovery it exercises, against the
reference package.

A :class:`FaultPlan` has the reference's JSON format, kinds, precedence
(``EvalConfig.faults`` over ``REPRO_FAULTS``) and seeded schedules, so
one plan file drives both packages.  Under every pool fault — worker
crashes, hangs past the receive deadline, a lane death in the middle of
``submit``, inline escalation after the retries, a wedged worker at
``close`` — the pooled results are bit-identical to the fault-free
evaluation (the port's numpy evaluator and the reference's), and no
worker outlives the pool.  The service's kinds behave as the
reference's, on the port's service (``backend="cuda"`` on
``device="cpu"``, the kernels' plain versions): ``hang_eval`` fails only
the victim session with ``E_TIMEOUT`` and leaves its peers
bit-identical; ``attach`` replays the exact event suffix, also after a
``drop_conn`` closed the connection; ``crash_save`` leaves the previous
snapshot loadable and ``corrupt_snapshot`` quarantines only the damaged
design.  Without a CUDA device, the service, the registry and the serve
CLI raise unless asked for the CPU."""

import multiprocessing as mp
import threading

import numpy as np
import pytest

from repro.core import EvalConfig as RefEvalConfig
from repro.core.faults import FAULT_KINDS as REF_FAULT_KINDS
from repro.core.faults import FaultPlan as RefFaultPlan
from repro.core.faults import resolve_plan as ref_resolve_plan
from repro.core.simgraph import build_simgraph as ref_build_simgraph
from repro.core import FifoAdvisor as RefAdvisor
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


# ------------------------------------------------------ service deadlines
SERVICE_CFG = EvalConfig(backend="cuda", max_iters=64)


def _service(**kw):
    from repro_torch.core.service import AdvisoryService
    return AdvisoryService(config=SERVICE_CFG, device="cpu", **kw)


def _strip_wall(events):
    wall = ("eval_s", "wall_s", "trace_time_s", "runtime_s")
    return [{k: v for k, v in e.items() if k not in wall} for e in events]


def test_deadline_times_out_victim_and_isolates_peer():
    from repro.core.service import AdvisoryService as RefService
    out = {}
    for name, make, plan_cls, fault in (
            ("port", _service, FaultPlan, Fault),
            ("ref", RefService, RefFaultPlan, None)):
        if fault is None:
            from repro.core.faults import Fault as fault
        plan = plan_cls([fault("hang_eval", at=1, target="gemm",
                               value=0.2)])
        with make(faults=plan) as svc:
            victim = svc.open_session("gemm", optimizer="grouped_sa",
                                      budget=BUDGET, seed=0,
                                      deadline_s=0.05)
            peer = svc.open_session("FeedForward", optimizer="grouped_sa",
                                    budget=BUDGET, seed=1)
            svc.run_until_idle()
            assert victim.state == "failed"
            assert victim.error_code == "E_TIMEOUT"
            assert victim.rounds == 2
            assert victim.dse_result().frontier_points.shape[0] >= 1
            assert peer.state == "done"
            out[name] = (victim.dse_result(), peer.dse_result(),
                         _strip_wall(svc.drain_events()))
        assert plan.all_fired
    solo = RefAdvisor(ref_make_design("FeedForward")).run(
        "grouped_sa", budget=BUDGET, seed=1)
    port, ref = out["port"], out["ref"]
    np.testing.assert_array_equal(port[1].frontier_points,
                                  solo.frontier_points)
    for got, want in zip(port[:2], ref[:2]):
        np.testing.assert_array_equal(got.result.configs,
                                      want.result.configs)
        np.testing.assert_array_equal(got.result.latency,
                                      want.result.latency)
        np.testing.assert_array_equal(got.frontier_points,
                                      want.frontier_points)
    assert port[2] == ref[2]


def test_timeout_surfaces_in_events_and_status():
    plan = FaultPlan([Fault("hang_eval", at=0, target="gemm", value=0.2)])
    with _service(faults=plan) as svc:
        sess = svc.open_session("gemm", budget=BUDGET, seed=0,
                                deadline_s=0.05)
        svc.run_until_idle()
        events = sess.drain_events()
        assert events[-1]["event"] == "failed"
        assert events[-1]["code"] == "E_TIMEOUT"
        assert sess.status()["code"] == "E_TIMEOUT"
        assert sess.status()["deadline_s"] == 0.05


# ---------------------------------------------------- reconnect + replay
def test_attach_replays_exact_event_suffix():
    from repro_torch.core.service import ProtocolHandler
    with _service() as svc:
        handler = ProtocolHandler(svc)
        sess = svc.open_session("gemm", budget=BUDGET, seed=0,
                                request_id="open-77")
        svc.run_until_idle(max_rounds=2)
        seen = sess.drain_events()
        last_seq = seen[-1]["seq"] if seen else -1
        again = svc.open_session("gemm", budget=BUDGET, seed=0,
                                 request_id="open-77")
        assert again is sess
        svc.run_until_idle()
        out = handler.handle({"op": "attach", "session": sess.id,
                              "after_seq": last_seq})
        assert out["ok"] and out["replay_complete"]
        stream = seen + out["events"]
        assert [e["seq"] for e in stream] == list(range(len(stream)))
        assert stream[-1]["event"] == "done"
        assert sess.drain_events() == []
        svc.release(sess.id)
        assert "open-77" not in svc._open_requests
        fresh = svc.open_session("gemm", budget=BUDGET, seed=0,
                                 request_id="open-77")
        assert fresh is not sess
    from repro.core.service import AdvisoryService as RefService
    with RefService() as ref:
        rs = ref.open_session("gemm", budget=BUDGET, seed=0)
        ref.run_until_idle()
        assert _strip_wall(rs.events_after(-1)) == _strip_wall(stream)


def test_drop_conn_then_attach_replays_the_stream():
    """``drop_conn`` closes the connection after the server's second
    frame; the client reconnects and ``attach`` replays the session's
    whole event stream — the reference server's, frame for frame."""
    import asyncio
    import json

    from repro.launch.serve import AdvisoryServer as RefServer
    from repro_torch.launch.serve import AdvisoryServer

    async def scenario(server):
        tcp = await server.serve_tcp("127.0.0.1", 0)
        port = tcp.sockets[0].getsockname()[1]

        async def connect():
            return await asyncio.open_connection("127.0.0.1", port)

        async def rpc(reader, writer, msg):
            try:
                writer.write((json.dumps(msg) + "\n").encode())
                await writer.drain()
                while True:
                    line = await asyncio.wait_for(reader.readline(), 30)
                    if not line:
                        return None           # the server hung up
                    frame = json.loads(line)
                    if "event" not in frame:
                        return frame
            except ConnectionError:
                return None                   # the server hung up

        reader, writer = await connect()
        opened = await rpc(reader, writer, {
            "op": "open", "design": "gemm", "optimizer": "grouped_random",
            "budget": BUDGET, "seed": 0})
        sid = opened["session"]
        dropped = None
        for _ in range(4):
            dropped = await rpc(reader, writer,
                                {"op": "status", "session": sid})
            if dropped is None:
                break
        assert dropped is None, "drop_conn never fired"
        writer.close()
        reader, writer = await connect()
        for _ in range(2000):
            st = await rpc(reader, writer, {"op": "status",
                                            "session": sid})
            if st["state"] == "done":
                break
            await asyncio.sleep(0.005)
        out = await rpc(reader, writer, {"op": "attach", "session": sid,
                                         "after_seq": -1})
        await rpc(reader, writer, {"op": "shutdown"})
        writer.close()
        tcp.close()
        await tcp.wait_closed()
        await server.aclose()
        return out

    got = asyncio.run(asyncio.wait_for(scenario(AdvisoryServer(
        idle_sleep_s=0.001, config=SERVICE_CFG, device="cpu",
        faults=FaultPlan([Fault("drop_conn", at=2)]))), timeout=120))
    from repro.core.faults import Fault as RefFault
    want = asyncio.run(asyncio.wait_for(scenario(RefServer(
        idle_sleep_s=0.001,
        faults=RefFaultPlan([RefFault("drop_conn", at=2)]))), timeout=120))
    assert got["ok"] and got["replay_complete"]
    assert got["events"][-1]["event"] == "done"
    assert _strip_wall(got["events"]) == _strip_wall(want["events"])


# ------------------------------------------------- snapshot crash + torn
def _warm_registry(designs, budget=30):
    from repro_torch.core.service import DesignRegistry
    reg = DesignRegistry(SERVICE_CFG, device="cpu")
    runs = {}
    for name in designs:
        runs[name] = reg.register(name).run("grouped_sa", budget=budget,
                                            seed=0)
    return reg, runs


def test_crash_mid_save_preserves_previous_snapshot(tmp_path):
    from repro_torch.core.faults import InjectedFault
    from repro_torch.core.service import (DesignRegistry, load_snapshot,
                                          save_snapshot)
    reg, runs = _warm_registry(["gemm"])
    save_snapshot(reg, str(tmp_path))
    for at in (0, 1):   # before member 0 / before the manifest replace
        with pytest.raises(InjectedFault):
            save_snapshot(reg, str(tmp_path),
                          faults=FaultPlan([Fault("crash_save", at=at)]))
    reg2 = load_snapshot(str(tmp_path),
                         registry=DesignRegistry(SERVICE_CFG, device="cpu"),
                         strict=True)
    assert reg2.names() == ["gemm"]
    dse = reg2["gemm"].run("grouped_sa", budget=30, seed=0)
    assert dse.result.n_evals == 0
    np.testing.assert_array_equal(dse.frontier_points,
                                  runs["gemm"].frontier_points)


def test_torn_write_quarantines_only_the_damaged_design(tmp_path):
    from repro_torch.core.service import (DesignRegistry, SnapshotError,
                                          load_snapshot, save_snapshot)
    reg, runs = _warm_registry(["FeedForward", "gemm"])
    victim = "FeedForward"
    idx = reg.names().index(victim)
    save_snapshot(reg, str(tmp_path), faults=FaultPlan(
        [Fault("corrupt_snapshot", at=idx, target=victim, value=100)]))
    with pytest.raises(SnapshotError, match="checksum"):
        load_snapshot(str(tmp_path), registry=DesignRegistry(
            SERVICE_CFG, device="cpu"), strict=True)
    reg2 = load_snapshot(str(tmp_path), registry=DesignRegistry(
        SERVICE_CFG, device="cpu"))
    rep = reg2.restore_report
    assert sorted(rep["quarantined"]) == [victim]
    assert "checksum" in rep["quarantined"][victim]
    assert rep["restored"] == ["gemm"]
    dse = reg2["gemm"].run("grouped_sa", budget=30, seed=0)
    assert dse.result.n_evals == 0
    np.testing.assert_array_equal(dse.frontier_points,
                                  runs["gemm"].frontier_points)


# -------------------------------------------------------- without a card
@pytest.fixture
def no_cuda(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_service_needs_the_card_unless_asked_for_the_cpu(no_cuda, tmp_path):
    from repro_torch.core.service import (AdvisoryService, DesignRegistry,
                                          load_snapshot, save_snapshot)
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AdvisoryService()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DesignRegistry().register("gemm")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AdvisoryService(config=EvalConfig(backend="numpy"), hetero=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--stdio"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--stdio", "--backend", "numpy"])
    reg = DesignRegistry(SERVICE_CFG, device="cpu")
    reg.register("gemm")
    save_snapshot(reg, str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_snapshot(str(tmp_path))
    assert load_snapshot(str(tmp_path), device="cpu").names() == ["gemm"]
    with AdvisoryService(hetero=True, device="cpu") as svc:
        svc.open_session("gemm", budget=10)
        svc.run_until_idle()
        assert svc.batcher.router.hetero.device.type == "cpu"
