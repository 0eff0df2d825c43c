"""Campaigns in the port against the reference package.

Every routing mode of the port's campaign — inline, hetero (every
full-solve row through one cross-design dispatch), pooled under ``fork``
and under ``spawn`` — gives the reference campaign's per-task histories,
frontiers and hypervolumes exactly, on ``device="cpu"`` (the kernels'
plain versions).  A checkpoint killed mid-run resumes byte-identically,
also one the reference wrote; ``backend="auto"`` calibrates between the
numpy worklist and the plain torch fixpoint on the CPU and gives the
reference's results."""

import json
import multiprocessing as mp
import warnings

import numpy as np
import pytest
import torch

from repro.core import FifoAdvisor as RefAdvisor
from repro.core.campaign import Campaign as RefCampaign
from repro.core.campaign import CampaignSpec as RefCampaignSpec
from repro.designs import make_design as ref_make_design

from repro_torch.core import BatchedEvaluator, EvalConfig, FifoAdvisor
from repro_torch.core.campaign import (Campaign, CampaignSpec,
                                       CheckpointMismatch, ResultStore,
                                       load_checkpoint)
from repro_torch.core.campaign import pool as pool_mod
from repro_torch.core.simgraph import build_simgraph
from repro_torch.designs import make_design
from repro_torch.launch import campaign as campaign_cli

DESIGNS = ("gemm", "FeedForward")
OPTIMIZERS = ("grouped_sa", "grouped_random")
BUDGET = 60


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain kernels run many tiny torch ops; with several test
    workers on one host, torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec(**kw):
    base = dict(designs=DESIGNS, optimizers=OPTIMIZERS, budget=BUDGET,
                seed=0, workers=0)
    base.update(kw)
    return CampaignSpec(**base)


@pytest.fixture(scope="module")
def reference():
    """The reference campaign (numpy worklist, inline)."""
    return RefCampaign(RefCampaignSpec(
        designs=DESIGNS, optimizers=OPTIMIZERS, budget=BUDGET, seed=0,
        workers=0)).run()


def _assert_store_equal(got, want):
    assert list(got.keys()) == list(want.keys())
    for k in want.keys():
        a, b = got[k], want[k]
        for f in ("configs", "latency", "bram", "deadlock"):
            x, y = getattr(a.result, f), getattr(b.result, f)
            assert x.dtype == y.dtype, (k, f)
            np.testing.assert_array_equal(x, y, err_msg=f"{k} {f}")
        assert a.result.n_evals == b.result.n_evals, k
        np.testing.assert_array_equal(a.frontier_points, b.frontier_points)
        np.testing.assert_array_equal(a.frontier_configs,
                                      b.frontier_configs)
        assert a.hypervolume() == b.hypervolume(), k


@pytest.mark.parametrize("backend", ["cuda", "numpy"])
def test_inline_campaign_equals_reference(reference, backend):
    camp = Campaign(_spec(eval=EvalConfig(backend=backend)), device="cpu")
    _assert_store_equal(camp.run(), reference)
    assert camp.finished and camp.pool is None


def test_hetero_campaign_equals_reference(reference):
    """Every full-solve row of every round goes through the cross-design
    dispatch (the cuda backend never prefers the incremental path): the
    per-design evaluators see no row after their baselines."""
    camp = Campaign(_spec(hetero=True, eval=EvalConfig(backend="cuda")),
                    device="cpu")
    before = {k: d.evaluator.stats.n_configs
              for k, d in camp.designs.items()}
    store = camp.run()
    _assert_store_equal(store, reference)
    assert {k: d.evaluator.stats.n_configs
            for k, d in camp.designs.items()} == before
    st = camp.hetero.stats
    misses = sum(sum(t.step_miss) for t in camp.tasks)
    assert 0 < st.n_dispatches < camp.round
    assert 0 < st.n_rows <= misses


def test_pooled_campaign_fork_equals_reference(reference):
    assert pool_mod.pick_start_method() == "fork"
    camp = Campaign(_spec(workers=2, eval=EvalConfig(backend="numpy")),
                    device="cpu")
    _assert_store_equal(camp.run(), reference)
    assert camp.pool_stats is not None
    assert mp.active_children() == []


def test_pooled_campaign_spawn_equals_reference(reference, monkeypatch):
    """Spawned workers re-import the package and rebuild their designs by
    name; the main process keeps its cuda-backend advisors (plain
    versions on the CPU)."""
    monkeypatch.setattr(pool_mod, "pick_start_method", lambda: "spawn")
    camp = Campaign(_spec(designs=("gemm",), workers=2), device="cpu")
    assert camp.pool.start_method == "spawn"
    got = camp.run()
    want = RefCampaign(RefCampaignSpec(
        designs=("gemm",), optimizers=OPTIMIZERS, budget=BUDGET, seed=0,
        workers=0)).run()
    _assert_store_equal(got, want)
    assert mp.active_children() == []


def test_start_method_spawns_once_cuda_is_initialised(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert pool_mod.pick_start_method() == "spawn"
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert pool_mod.pick_start_method() == "fork"


def test_checkpoint_resume_byte_identical(tmp_path):
    """Kill mid-run; resume must equal the uninterrupted run exactly."""
    spec = _spec(designs=("gemm",), checkpoint_every=2,
                 eval=EvalConfig(backend="numpy"))
    uninterrupted = Campaign(spec, device="cpu").run()
    path = str(tmp_path / "camp.npz")
    camp = Campaign(spec, checkpoint_path=path, device="cpu")
    camp.run(max_rounds=3)          # simulated kill
    assert not camp.finished
    resumed = Campaign.resume(path, device="cpu")
    store = resumed.run()
    assert resumed.finished
    _assert_store_equal(store, uninterrupted)


def test_checkpoint_rng_state_roundtrip_and_tamper(tmp_path):
    path = str(tmp_path / "camp.npz")
    camp = Campaign(_spec(designs=("gemm",), checkpoint_every=1,
                          eval=EvalConfig(backend="numpy")),
                    checkpoint_path=path, device="cpu")
    camp.run(max_rounds=2)
    data = load_checkpoint(path)
    states = [t["rng_state"] for t in data["tasks"]]
    assert all(s["bit_generator"] == "PCG64" for s in states)
    resumed = Campaign.resume(path, device="cpu")
    for task, saved in zip(resumed.tasks, states):
        assert task.ctx.rng.bit_generator.state == saved
    z = np.load(path, allow_pickle=False)
    arrays = {k: z[k].copy() for k in z.files}
    arrays["t0_configs"][0, 0] += 1      # corrupt the recorded history
    np.savez_compressed(path, **arrays)
    with pytest.raises(CheckpointMismatch):
        Campaign.resume(path, device="cpu")


def test_reference_checkpoint_resumes_in_port(tmp_path, reference):
    """A checkpoint the reference wrote mid-run resumes in the port (on
    the numpy backend it names) to the reference's final store."""
    path = str(tmp_path / "ref.npz")
    ref = RefCampaign(RefCampaignSpec(
        designs=DESIGNS, optimizers=OPTIMIZERS, budget=BUDGET, seed=0,
        workers=0, checkpoint_every=2), checkpoint_path=path)
    ref.run(max_rounds=3)
    assert not ref.finished
    resumed = Campaign.resume(path, device="cpu")
    assert resumed.spec.eval.backend == "numpy"
    _assert_store_equal(resumed.run(), reference)


def test_pallas_alias_checkpoint_resumes_like_cuda(tmp_path):
    """``"pallas"`` (the reference's kernel backend name) and ``"cuda"``
    are one backend: a checkpoint naming either resumes alike."""
    spec = _spec(designs=("gemm",), checkpoint_every=1,
                 eval=EvalConfig(backend="pallas"))
    path = str(tmp_path / "p.npz")
    Campaign(spec, checkpoint_path=path, device="cpu").run(max_rounds=2)
    assert load_checkpoint(path)["spec"]["eval"]["backend"] == "pallas"
    got = Campaign.resume(path, device="cpu").run()
    want = Campaign(_spec(designs=("gemm",),
                          eval=EvalConfig(backend="cuda")),
                    device="cpu").run()
    _assert_store_equal(got, want)


def test_auto_backend_calibrates_on_cpu():
    g = build_simgraph(make_design("gemm"))
    ev = BatchedEvaluator(g, EvalConfig(backend="auto"), device="cpu")
    cal = ev.calibration
    assert cal["chosen"] in ("numpy", "fixpoint")
    assert set(cal["probe_s"]) == {"numpy", "fixpoint"}
    assert ev.config.backend == cal["chosen"] == ev.backend
    adv = FifoAdvisor(make_design("gemm"), EvalConfig(backend="auto"),
                      device="cpu")
    assert adv.evaluator.config.backend in ("numpy", "fixpoint")
    got = adv.run("grouped_sa", budget=BUDGET, seed=0)
    want = RefAdvisor(ref_make_design("gemm")).run("grouped_sa",
                                                   budget=BUDGET, seed=0)
    for f in ("configs", "latency", "bram", "deadlock"):
        np.testing.assert_array_equal(getattr(got.result, f),
                                      getattr(want.result, f))
    assert got.hypervolume() == want.hypervolume()


def test_spec_deprecation_shims():
    with pytest.warns(DeprecationWarning):
        spec = CampaignSpec(designs=("gemm",), optimizers=("sa",),
                            backend="numpy", max_iters=32)
    assert spec.eval == EvalConfig(backend="numpy", max_iters=32)
    assert (spec.backend, spec.max_iters, spec.shards) == ("numpy", 32,
                                                           None)
    with pytest.raises(TypeError):
        CampaignSpec(designs=("gemm",), optimizers=("sa",),
                     backend="numpy", eval=EvalConfig())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        spec = CampaignSpec(designs=("gemm",), optimizers=("sa",),
                            shards=2)
    assert spec.shards == spec.eval.shards == 2


def test_result_store_summary_roundtrip(tmp_path):
    store = Campaign(_spec(designs=("gemm",), budget=40,
                           eval=EvalConfig(backend="numpy")),
                     device="cpu").run()
    assert isinstance(store, ResultStore)
    out = store.summary()
    assert out["n_tasks"] == 2
    assert set(out["tasks"]) == {"gemm:grouped_sa:s0",
                                 "gemm:grouped_random:s0"}
    for entry in out["tasks"].values():
        assert entry["hypervolume"] > 0 and entry["frontier"]
    path = store.save_json(str(tmp_path / "store.json"))
    with open(path) as f:
        assert json.load(f)["n_tasks"] == 2


def test_campaign_cli_stops_resumes_and_writes(tmp_path, capsys):
    ckpt, out = str(tmp_path / "c.npz"), str(tmp_path / "r.json")
    common = ["--device", "cpu", "--workers", "0"]
    assert campaign_cli.main(["--designs", "gemm", "--budget", "40",
                              "--hetero", "--checkpoint", ckpt,
                              "--max-rounds", "2", *common]) == 0
    assert "stopped after --max-rounds" in capsys.readouterr().out
    assert campaign_cli.main(["--resume", ckpt, "--out", out,
                              *common]) == 0
    with open(out) as f:
        got = json.load(f)
    want = Campaign(_spec(designs=("gemm",), budget=40, hetero=True),
                    device="cpu").run().summary()
    for k, entry in want["tasks"].items():
        assert got["tasks"][k]["frontier"] == entry["frontier"]
        assert got["tasks"][k]["hypervolume"] == entry["hypervolume"]
