"""The port's advisory service against the reference package.

Every test drives the reference service and the port's on the same
designs, optimizers and seeds; the port runs ``backend="cuda"`` on
``device="cpu"`` (the kernels' plain torch versions; ``max_iters=64``
keeps the plain fixpoint cheap on the CPU, and rows still unresolved at
the cap are settled exactly by the worklist).  Batching is
routing only, so the two give identical histories, frontiers,
hypervolumes and progress events, session for session — also under
forced hetero packing, a mid-run cancel and a design that arrives after
the first rounds — and both equal solo ``FifoAdvisor.run()`` calls.  The
wire protocol v2 gives identical transcripts and error codes, once the
wall-clock fields (:data:`WALL_KEYS`) are left out.
"""

import asyncio
import functools
import json
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from repro.core import FifoAdvisor as RefAdvisor
from repro.core.service import AdvisorClient as RefClient
from repro.core.service import AdvisoryService as RefService
from repro.core.service import ProtocolError as RefProtocolError
from repro.core.service import ProtocolHandler as RefHandler
from repro.designs import make_design as ref_make_design

from repro_torch.core import (EvalConfig, FifoAdvisor, available_backends,
                              resolve_config)
from repro_torch.core.campaign.router import RoundRouter
from repro_torch.core.service import (ERROR_CODES, AdvisorClient,
                                      AdvisoryService, DesignRegistry,
                                      ProtocolError, ProtocolHandler,
                                      SessionHandle, adapt_v1)
from repro_torch.core.service.protocol import (E_BAD_DESIGN,
                                               E_BAD_OPTIMIZER,
                                               E_BAD_REQUEST, E_BAD_SESSION,
                                               E_OVERLOADED, E_PROTO, PROTO,
                                               SUPPORTED_PROTOS)
from repro_torch.designs import make_design

DESIGNS = ("gemm", "FeedForward")
BUDGET = 60
CUDA = EvalConfig(backend="cuda", max_iters=64)

#: (design, optimizer, seed) mix over 2 designs and 2 optimizers (the
#: reference's mix, with ``grouped_sa`` in place of FeedForward's
#: ``grouped_random``, whose rows are the slowest on the plain fixpoint)
SESSIONS = [("gemm", "grouped_sa", 0), ("gemm", "grouped_random", 3),
            ("FeedForward", "grouped_sa", 1),
            ("FeedForward", "grouped_sa", 0)]

#: fields that carry wall-clock seconds: they differ between any two
#: runs, so transcript comparisons leave them (and only them) out
WALL_KEYS = frozenset({"retry_after_s", "eval_s", "wall_s", "trace_time_s",
                       "runtime_s", "round_ewma_s"})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain kernels run many tiny torch ops; with several test
    workers on one host, torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def service(**kw) -> AdvisoryService:
    kw.setdefault("config", CUDA)
    return AdvisoryService(device="cpu", **kw)


def client(**kw) -> AdvisorClient:
    kw.setdefault("config", CUDA)
    return AdvisorClient(device="cpu", **kw)


@functools.lru_cache(maxsize=None)
def solo_run(design, optimizer, seed, budget=BUDGET):
    """The reference's solo run (numpy backend)."""
    return RefAdvisor(ref_make_design(design)).run(optimizer, budget=budget,
                                                   seed=seed)


def assert_identical(dse, ref, key=""):
    for f in ("configs", "latency", "bram", "deadlock"):
        a, b = getattr(dse.result, f), getattr(ref.result, f)
        assert a.dtype == b.dtype, (key, f)
        np.testing.assert_array_equal(a, b, err_msg=f"{key} {f}")
    np.testing.assert_array_equal(dse.frontier_points, ref.frontier_points)
    assert dse.hypervolume() == ref.hypervolume(), key


def strip(obj):
    """``obj`` without the wall-clock fields, at any depth."""
    if isinstance(obj, dict):
        return {k: strip(v) for k, v in obj.items() if k not in WALL_KEYS}
    if isinstance(obj, (list, tuple)):
        return [strip(v) for v in obj]
    return obj


def same_frames(got, want):
    """Two frame lists equal once the wall-clock fields are left out (a
    JSON round trip makes tuples and lists alike)."""
    assert json.loads(json.dumps(strip(got))) == \
        json.loads(json.dumps(strip(want)))


def run_mix(svc, sessions, budget=BUDGET):
    ids = [svc.open_session(d, optimizer=o, budget=budget, seed=s).id
           for d, o, s in sessions]
    svc.run_until_idle()
    return ids


@pytest.fixture(scope="module")
def reference_mix():
    """The reference service over :data:`SESSIONS`: (results, events,
    rounds)."""
    with RefService() as ref:
        ids = run_mix(ref, SESSIONS)
        return ([ref.result(i) for i in ids], ref.drain_events(),
                ref.batcher.rounds)


# --------------------------------------------------------------- batching
def test_concurrent_sessions_bit_identical_to_solo(reference_mix):
    """2 designs x 2 optimizers batched together == 4 solo runs, and the
    port's sessions stream the reference service's events."""
    results, events, rounds = reference_mix
    with service() as svc:
        ids = run_mix(svc, SESSIONS)
        for sid, want, (d, o, s) in zip(ids, results, SESSIONS):
            assert_identical(svc.result(sid), solo_run(d, o, s),
                             f"{d}:{o}:s{s}")
            assert_identical(svc.result(sid), want)
        same_frames(svc.drain_events(), events)
        assert svc.batcher.rounds == rounds


def test_forced_hetero_packing_bit_identical(reference_mix):
    """hetero=True packs every full-solve row of a round, across
    designs, into one dispatch (the plain per-design-table fixpoint on
    the CPU) and still reproduces every solo run and the reference
    service's events exactly."""
    results, events, rounds = reference_mix
    with service(hetero=True) as svc:
        ids = [svc.open_session(d, optimizer=o, budget=BUDGET, seed=s).id
               for d, o, s in SESSIONS]
        before = {k: svc.registry[k].evaluator.stats.n_configs
                  for k in DESIGNS}
        svc.run_until_idle()
        disp = svc.batcher.router.hetero
        assert disp is not None and disp.stats.n_dispatches > 0
        # both designs share each round's dispatch: never more
        # dispatches than rounds
        assert disp.stats.n_dispatches <= svc.batcher.rounds == rounds
        assert set(disp.worklists) == set(DESIGNS)
        assert disp.device == torch.device("cpu")
        # the cuda backend never prefers the incremental path: after the
        # baselines, no row reached a per-design evaluator
        assert {k: svc.registry[k].evaluator.stats.n_configs
                for k in DESIGNS} == before
        for sid, want, (d, o, s) in zip(ids, results, SESSIONS):
            assert_identical(svc.result(sid), solo_run(d, o, s),
                             f"hetero {d}:{o}:s{s}")
            assert_identical(svc.result(sid), want)
        same_frames(svc.drain_events(), events)


def test_late_longer_design_grows_the_hetero_envelope():
    """A design opened after the first rounds, longer than every design
    before it, re-pads the dispatcher's tables before the round that
    first routes it; every session still equals its solo run."""
    with service(hetero=True) as svc:
        first = svc.open_session("gemm", optimizer="grouped_sa",
                                 budget=BUDGET, seed=0)
        svc.step()
        svc.step()
        disp = svc.batcher.router.hetero
        e_before = disp.e_pad
        late = svc.open_session("FeedForward", optimizer="grouped_sa",
                                budget=BUDGET, seed=0)
        assert disp.e_pad > e_before
        assert set(disp.worklists) == set(DESIGNS)
        svc.run_until_idle()
        assert_identical(first.dse_result(),
                         solo_run("gemm", "grouped_sa", 0))
        assert_identical(late.dse_result(),
                         solo_run("FeedForward", "grouped_sa", 0))


def test_mid_run_cancel_keeps_prefix_and_peers_exact():
    """Cancelling one session mid-run yields its history prefix (the
    reference's, to the row) and leaves every other session
    bit-identical to its solo run."""
    def scenario(svc):
        victim = svc.open_session("gemm", optimizer="grouped_sa",
                                  budget=400, seed=5)
        peers = [svc.open_session(d, optimizer=o, budget=BUDGET,
                                  seed=s).id for d, o, s in SESSIONS[1:3]]
        for _ in range(3):
            svc.step()
        svc.cancel(victim.id)
        assert victim.state == "cancelled"
        svc.run_until_idle()
        return victim, peers

    with RefService() as ref, service() as svc:
        victim, peers = scenario(svc)
        ref_victim, _ = scenario(ref)
        part = svc.result(victim.id)
        n = part.result.configs.shape[0]
        assert 0 < n
        full = solo_run("gemm", "grouped_sa", 5, budget=400)
        assert n < full.result.configs.shape[0]
        np.testing.assert_array_equal(part.result.configs,
                                      full.result.configs[:n])
        np.testing.assert_array_equal(part.result.latency,
                                      full.result.latency[:n])
        assert_identical(part, ref.result(ref_victim.id))
        events = victim.drain_events()
        assert events and events[-1]["event"] == "cancelled"
        same_frames(events, ref_victim.drain_events())
        before = victim.rounds
        svc.step()
        assert victim.rounds == before
        for sid, (d, o, s) in zip(peers, SESSIONS[1:3]):
            assert_identical(svc.result(sid), solo_run(d, o, s),
                             f"peer {d}:{o}:s{s}")


def test_progress_events_stream_frontier_deltas():
    def events(svc):
        sess = svc.open_session("gemm", optimizer="grouped_random",
                                budget=BUDGET, seed=0)
        svc.run_until_idle()
        return sess.drain_events()

    with RefService() as ref, service() as svc:
        got = events(svc)
        same_frames(got, events(ref))
    assert got[-1]["event"] == "done"
    progress = [e for e in got if e["event"] == "progress"]
    assert progress, "no progress events streamed"
    hv = 0.0
    for e in progress:
        assert e["hv_delta"] == pytest.approx(e["hypervolume"] - hv)
        assert e["hypervolume"] >= hv
        hv = e["hypervolume"]
    assert got[-1]["hypervolume"] == pytest.approx(hv)


def _tiny_design(make):
    d = make("qs")
    d.fifo("a", width=32)

    @d.task("src")
    def src(ctx):
        for i in range(64):
            yield ctx.delay(1)
            yield ctx.write("a", i)

    @d.task("sink")
    def sink(ctx):
        for _ in range(64):
            yield ctx.read("a")
            yield ctx.delay(2)

    return d


def test_pooled_service_handles_late_and_custom_designs():
    """Worker-pool mode (fork: no CUDA context here): a design opened
    after the pool exists rebuilds it, and a custom Design object is
    pinned inline; all equal the reference's solo runs."""
    from repro.core.design import Design as RefDesign
    from repro_torch.core.design import Design

    with service(workers=1) as svc:
        first = svc.open_session("gemm", optimizer="grouped_random",
                                 budget=40, seed=0)
        late = svc.open_session("FeedForward", optimizer="grouped_sa",
                                budget=40, seed=1)       # pool rebuild
        custom = svc.open_session("qs", design_obj=_tiny_design(Design),
                                  optimizer="grouped_random",
                                  budget=40, seed=2)     # inline-only
        assert "qs" in svc.batcher.router.inline_only
        assert svc.batcher.router.pool is not None
        assert svc.batcher.router.pool.start_method == "fork"
        svc.run_until_idle()
        assert {s.state for s in (first, late, custom)} == {"done"}
        assert_identical(svc.result(first.id),
                         solo_run("gemm", "grouped_random", 0, 40))
        assert_identical(svc.result(late.id),
                         solo_run("FeedForward", "grouped_sa", 1, 40))
        ref_custom = RefAdvisor(_tiny_design(RefDesign)).run(
            "grouped_random", budget=40, seed=2)
        assert_identical(svc.result(custom.id), ref_custom)


# --------------------------------------------------------------- registry
def test_registry_traces_each_design_once():
    reg = DesignRegistry(CUDA, device="cpu")
    a1 = reg.register("gemm")
    assert reg.register("gemm") is a1
    assert reg.names() == ["gemm"]
    assert a1.evaluator.device == torch.device("cpu")
    with AdvisoryService(registry=reg) as svc:
        s1 = svc.open_session("gemm", budget=20, seed=0)
        svc.run_until_idle()
        assert s1.ctx.n_evals > 0
        s2 = svc.open_session("gemm", budget=20, seed=0)
        assert s2.advisor is a1
        svc.run_until_idle()
        assert s2.ctx.n_evals == 0
        np.testing.assert_array_equal(s1.ctx.history()[0],
                                      s2.ctx.history()[0])
    stats = reg.stats()["gemm"]
    assert stats["cache"]["hits"] > 0
    ref = RefService()
    for _ in range(2):
        ref.open_session("gemm", budget=20, seed=0)
        ref.run_until_idle()
    want = ref.registry.stats()["gemm"]
    assert strip(stats) == strip(want)


def test_service_and_campaign_share_the_router():
    from repro_torch.core.campaign import Campaign, CampaignSpec
    camp = Campaign(CampaignSpec(designs=("gemm",),
                                 optimizers=("grouped_random",), budget=20,
                                 eval=CUDA, workers=0), device="cpu")
    with service() as svc:
        assert type(camp.router) is type(svc.batcher.router) is RoundRouter
    camp.close()


def test_resolve_config_maps_legacy_keywords():
    """The deprecated keyword spellings map 1:1 (``use_pallas=True`` is
    the ``"pallas"`` alias of ``"cuda"``) with a DeprecationWarning, as
    in the reference; both forms at once, or an unknown keyword, is a
    TypeError."""
    from repro.core.config import resolve_config as ref_resolve
    assert resolve_config(None, {}, "X") == EvalConfig()
    assert EvalConfig().backend == "cuda"
    with pytest.warns(DeprecationWarning, match="use_pallas"):
        cfg = resolve_config(None, {"use_pallas": True, "max_iters": 32},
                             "X")
    with pytest.warns(DeprecationWarning):
        want = ref_resolve(None, {"use_pallas": True, "max_iters": 32}, "X")
    assert cfg.to_dict() == want.to_dict()
    assert cfg.backend == "pallas" and cfg.max_iters == 32
    with pytest.raises(TypeError, match="not both"):
        resolve_config(CUDA, {"max_iters": 8}, "X")
    with pytest.raises(TypeError, match="unexpected"):
        resolve_config(None, {"no_such_knob": 1}, "X")
    with pytest.warns(DeprecationWarning, match="DesignRegistry"):
        reg = DesignRegistry(max_iters=48, device="cpu")
    assert reg.config == EvalConfig(max_iters=48)
    with pytest.raises(TypeError, match="not both"):
        AdvisoryService(config=CUDA, max_iters=8, device="cpu")
    assert "cuda" in available_backends()


# --------------------------------------------------------------- protocol
def _handlers():
    return ProtocolHandler(service()), RefHandler(RefService())


def _transcript(handler, msgs):
    out = [handler.handle(dict(m)) for m in msgs]
    return out, handler.poll_events()


def test_protocol_roundtrip_and_errors():
    msgs = [{"op": "hello", "proto": 2},
            {"op": "open", "design": "gemm", "optimizer": "grouped_random",
             "budget": 30, "id": "req-1"},
            {"op": "status", "session": "s0"},
            {"op": "run"},
            {"op": "result", "session": "s0"},
            {"op": "designs"},
            {"op": "nope"}, {"op": "open"},
            {"op": "status", "session": "s99"},
            {"op": "cancel", "id": 7}]
    port, ref = _handlers()
    got, events = _transcript(port, msgs)
    want, ref_events = _transcript(ref, msgs)
    same_frames(got, want)
    same_frames(events, ref_events)
    assert got[1]["ok"] and got[1]["id"] == "req-1"
    assert got[2]["state"] == "running"
    assert got[3]["ok"] and got[3]["running"] == 0
    res = got[4]
    assert res["ok"] and res["state"] == "done"
    assert res["result"]["frontier"] and res["result"]["n_evals"] > 0
    assert events and events[-1]["event"] == "done"
    assert [f["ok"] for f in got[6:]] == [False] * 4
    assert got[-1]["id"] == 7


def test_error_frames_carry_stable_codes():
    cases = [
        ({"op": "nope"}, E_PROTO),
        ({"op": "hello", "proto": 99}, E_PROTO),
        ({"op": "open"}, E_BAD_REQUEST),
        ({"op": "status"}, E_BAD_REQUEST),
        ({"op": "open", "design": "no_such_design"}, E_BAD_DESIGN),
        ({"op": "open", "design": "gemm",
          "optimizer": "no_such_optimizer"}, E_BAD_OPTIMIZER),
        ({"op": "status", "session": "s99"}, E_BAD_SESSION),
        ({"op": "snapshot"}, E_BAD_REQUEST),
    ]
    from repro.core.service import ERROR_CODES as REF_CODES
    assert ERROR_CODES == REF_CODES
    port, ref = _handlers()
    for msg, code in cases:
        out = port.handle(msg)
        assert not out["ok"] and out["code"] == code, (msg, out)
        assert out["error"]
        same_frames([out], [ref.handle(msg)])


def test_hello_negotiates_proto_and_advertises_ops():
    with client() as c, RefClient() as rc:
        assert c.proto == PROTO == rc.proto
        for proto in SUPPORTED_PROTOS:
            hello = c.request({"op": "hello", "proto": proto})
            assert hello == rc.request({"op": "hello", "proto": proto})
            assert hello["proto"] == proto
            assert "release" in hello["ops"] and "close" not in hello["ops"]
        with pytest.raises(ProtocolError) as err:
            c.request({"op": "hello", "proto": 3})
        assert err.value.code == E_PROTO


def test_v1_messages_round_trip_through_adapter():
    assert adapt_v1({"op": "close", "session": "s0"})["op"] == "release"
    assert adapt_v1({"op": "status", "session": "s0"})["op"] == "status"
    msgs = [{"op": "open", "design": "gemm", "optimizer": "grouped_random",
             "budget": 20, "id": "v1-1"}]
    msgs += [dict(m, id=f"v1-{m['op']}") for m in (
        {"op": "status", "session": "s0"}, {"op": "step"}, {"op": "run"},
        {"op": "result", "session": "s0"}, {"op": "designs"},
        {"op": "stats"}, {"op": "cancel", "session": "s0"},
        {"op": "close", "session": "s0"}, {"op": "shutdown"})]
    msgs.append({"op": "status", "session": "s0"})
    port, ref = _handlers()
    got, events = _transcript(port, msgs)
    want, ref_events = _transcript(ref, msgs)
    same_frames(got, want)
    same_frames(events, ref_events)
    assert all(f["ok"] and f["id"] == m["id"]
               for f, m in zip(got[:-1], msgs))
    assert not got[-1]["ok"]          # the closed session is really gone


def test_session_handle_stream_and_context_manager():
    def stream(c):
        with c.open("gemm", optimizer="grouped_random", budget=30,
                    progress=True) as h:
            assert isinstance(h, str)
            assert json.dumps({"session": h})
            events = list(h.stream())
            assert h.status()["state"] == "done"
            assert h.result().result.configs.shape[0] > 0
            assert h.result_json()["design"] == "gemm"
        assert c.service.sessions == {}
        with pytest.raises((ProtocolError, RefProtocolError)) as err:
            h.status()
        assert err.value.code == E_BAD_SESSION
        return h, events

    with client() as c, RefClient() as rc:
        h, events = stream(c)
        assert isinstance(h, SessionHandle)
        same_frames(events, stream(rc)[1])
    assert events[-1]["event"] == "done"
    assert any(e["event"] == "progress" for e in events)


def test_deprecated_sid_methods_still_work_and_warn():
    with client() as c:
        h = c.open("gemm", optimizer="grouped_random", budget=20)
        c.drive()
        sid = str(h)
        with pytest.warns(DeprecationWarning, match="status"):
            assert c.status(sid)["state"] == "done"
        with pytest.warns(DeprecationWarning, match="result"):
            assert_identical(c.result(sid),
                             solo_run("gemm", "grouped_random", 0, 20))
        with pytest.warns(DeprecationWarning, match="result_json"):
            assert c.result_json(sid)["design"] == "gemm"
        with pytest.warns(DeprecationWarning, match="release"):
            rel = c.release(sid)
        assert rel["released"] and rel["state"] == "done"


def test_overload_sheds_with_retry_after():
    """At the session cap, ``open`` fails fast with E_OVERLOADED and a
    positive ``retry_after_s``; the rest of the frame is the
    reference's."""
    with client(max_sessions=2) as c, RefClient(max_sessions=2) as rc:
        frames = []
        for cl in (c, rc):
            h1 = cl.open("gemm", optimizer="grouped_random", budget=20)
            h2 = cl.open("gemm", optimizer="grouped_random", budget=20,
                         seed=1)
            with pytest.raises((ProtocolError, RefProtocolError)) as err:
                cl.open("gemm", optimizer="grouped_random", budget=20,
                        seed=2)
            assert err.value.code == E_OVERLOADED
            assert err.value.extra["retry_after_s"] > 0
            assert err.value.extra["max_sessions"] == 2
            assert len(cl.service.running) <= 2
            assert cl.service.stats()["rejected"] == 1
            frames.append(cl.handler.handle(
                {"op": "open", "design": "gemm", "id": 9}))
            cl.drive()
            h1.release()
            h2.release()
            h3 = cl.open("gemm", optimizer="grouped_random", budget=20,
                         seed=2)
            cl.drive()
            assert h3.status()["state"] == "done"
        assert "retry_after_s" in frames[0]
        same_frames(frames[:1], frames[1:])
        assert_identical(h3.result(),
                         solo_run("gemm", "grouped_random", 2, 20))


def test_release_evicts_session_and_hetero_ignores_workers():
    with client() as c:
        h = c.open("gemm", optimizer="grouped_random", budget=20)
        c.drive()
        assert h.result().result.configs.shape[0] > 0
        rel = h.release()
        assert rel["released"] and rel["state"] == "done"
        with pytest.raises(ProtocolError):
            h.status()
        assert c.service.sessions == {}
    with service(hetero=True, workers=4) as svc:
        assert svc.batcher.workers == 0


def test_optimizer_close_is_public_and_terminal():
    from repro_torch.core.optimizers import OPTIMIZERS
    adv = FifoAdvisor(make_design("gemm"), CUDA, device="cpu")
    opt = OPTIMIZERS["grouped_random"](adv.make_context(seed=0),
                                       budget=500)
    assert opt.propose() is not None
    opt.close()
    assert opt.done and opt.propose() is None


def test_advisor_client_run_matches_solo():
    with client() as c:
        dse = c.run("gemm", optimizer="grouped_sa", budget=BUDGET, seed=2)
        assert_identical(dse, solo_run("gemm", "grouped_sa", 2))
        h = c.open("gemm", optimizer="grouped_sa", budget=BUDGET, seed=2)
        c.drive()
        assert_identical(h.result(), solo_run("gemm", "grouped_sa", 2))
        payload = h.result_json()
        assert payload["design"] == "gemm" and json.dumps(payload)
        with pytest.raises(ProtocolError):
            c.request({"op": "result", "session": "s42"})


# ----------------------------------------------------------------- server
def test_tcp_server_round_trip():
    """Full wire path: TCP connect, open, events, result, shutdown."""
    from repro_torch.launch.serve import AdvisoryServer

    async def scenario():
        server = AdvisoryServer(idle_sleep_s=0.001, config=CUDA,
                                device="cpu")
        tcp = await server.serve_tcp("127.0.0.1", 0)
        port = tcp.sockets[0].getsockname()[1]
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        frames = []

        async def rpc(msg):
            writer.write((json.dumps(msg) + "\n").encode())
            await writer.drain()
            while True:
                frame = json.loads(await reader.readline())
                if "event" in frame:
                    frames.append(frame)
                    continue
                return frame

        opened = await rpc({"op": "open", "design": "gemm",
                            "optimizer": "grouped_random", "budget": 40,
                            "id": 1})
        assert opened["ok"] and opened["id"] == 1
        sid = opened["session"]
        for _ in range(400):
            status = await rpc({"op": "status", "session": sid})
            if status["state"] == "done":
                break
            await asyncio.sleep(0.01)
        assert status["state"] == "done"
        result = await rpc({"op": "result", "session": sid})
        assert result["ok"] and result["result"]["frontier"]
        for _ in range(100):
            if any(f["event"] == "done" for f in frames):
                break
            line = await asyncio.wait_for(reader.readline(), timeout=5)
            frames.append(json.loads(line))
        assert any(f["event"] == "done" for f in frames)
        assert (await rpc({"op": "shutdown"}))["ok"]
        writer.close()
        tcp.close()
        await tcp.wait_closed()
        await server.aclose()
        return result

    result = asyncio.run(asyncio.wait_for(scenario(), timeout=120))
    want = solo_run("gemm", "grouped_random", 0, 40)
    assert result["result"]["frontier"] == want.frontier_points.tolist()


def _serve(module, args, lines, cwd):
    """``python -m MODULE --stdio ARGS`` in ``cwd`` (made here), fed
    ``lines``: (frames, stderr)."""
    import os
    cwd.mkdir(exist_ok=True)
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    # one intra-op thread, as in this process (see _one_torch_thread)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (src, os.environ.get("PYTHONPATH")) if p),
        JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", module, "--stdio", *args],
                       input="".join(json.dumps(m) + "\n" for m in lines),
                       capture_output=True, text=True, timeout=300,
                       env=env, cwd=str(cwd))
    assert r.returncode == 0, r.stderr
    return [json.loads(x) for x in r.stdout.splitlines()], r.stderr


SCRIPT = [{"op": "hello", "proto": 2},
          {"op": "open", "design": "gemm", "optimizer": "grouped_sa",
           "budget": 40, "seed": 0},
          {"op": "open", "design": "FeedForward",
           "optimizer": "grouped_sa", "budget": 40, "seed": 1},
          {"op": "run"},
          {"op": "result", "session": "s0"},
          {"op": "result", "session": "s1"},
          {"op": "snapshot"},
          {"op": "shutdown"}]


def test_serve_cli_stdio_transcript_equals_reference(tmp_path):
    """``python -m repro_torch.launch.serve --stdio --hetero --device
    cpu`` answers the scripted transcript exactly as the reference's
    server on its numpy default; a second start on the same snapshot
    directory is warm and answers from the restored cache.  Each server
    runs in a directory of its own with ``--snapshot-dir snap``."""
    port_args = ["--hetero", "--device", "cpu", "--snapshot-dir", "snap"]
    got, err = _serve("repro_torch.launch.serve", port_args, SCRIPT,
                      tmp_path / "port")
    want, _ = _serve("repro.launch.serve", ["--snapshot-dir", "snap"],
                     SCRIPT, tmp_path / "ref")
    assert "(cold)" in err and "kernels" not in err   # no build on a CPU
    same_frames(got, want)
    replies = [f for f in got if "event" not in f]
    assert [f["ok"] for f in replies] == [True] * len(SCRIPT)
    assert replies[6]["designs"] == ["FeedForward", "gemm"]
    again, err = _serve("repro_torch.launch.serve", port_args,
                        SCRIPT[:2] + [SCRIPT[3], SCRIPT[4], SCRIPT[-1]],
                        tmp_path / "port")
    assert "warm, 2 restored" in err
    again = [f for f in again if "event" not in f]
    assert again[3]["result"]["n_evals"] == 0
    assert again[3]["result"]["frontier"] == \
        replies[4]["result"]["frontier"]


def test_serve_shards_names_its_roadmap_item():
    from repro_torch.launch import serve
    with pytest.raises(NotImplementedError, match="ROADMAP P11"):
        serve.main(["--stdio", "--device", "cpu", "--shards", "2"])


def test_no_warnings_on_the_default_paths():
    """The service's non-deprecated spellings emit no warning."""
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with service() as svc:
            svc.open_session("gemm", optimizer="grouped_random", budget=10)
            svc.run_until_idle()
