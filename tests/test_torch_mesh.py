"""Row sharding over devices: the port's mesh against the reference's, on
CPU meshes of 1, 2 and 4 shards (the CPU repeated).

* ``MeshBackend`` (inner ``fixpoint`` and ``cuda``, whose plain versions
  run on the CPU) returns the reference's solo ``numpy`` and ``fixpoint``
  results on every fuzz-corpus design, and the reference ``MeshBackend``'s
  where jax has the host devices for it;
* ragged batches pad to the shard multiple and cut back exactly, through
  the evaluator (``dispatch.shard_multiple``) and the fused certificate;
* ``HeteroDispatcher`` on a 2x2 ``("design", "eval")`` mesh: rows and
  ``HeteroStats`` equal the reference's;
* a campaign and the campaign CLI with ``--shards 2`` give the unsharded
  results;
* ``device_grid`` and the mesh constructors;
* the production meshes (``make_production_mesh``, ``make_local_mesh``)
  over 1, 8, 256 and 512 ranks of fake process groups: the reference's
  shapes, axis names and errors, and the ``DeviceMesh`` each yields.

Exact equality throughout."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from repro.core.backends.dispatch import \
    HeteroDispatcher as RefHeteroDispatcher
from repro.core.backends.fixpoint import FixpointBackend as RefFixpoint
from repro.core.config import EvalConfig as RefEvalConfig
from repro.core.simgraph import build_simgraph as ref_build_simgraph
from repro.core.simulate import BatchedEvaluator as RefEvaluator
from repro.designs import make_design as ref_make_design
from repro.designs.ddcf import mult_by_2 as ref_mult_by_2
from repro.designs.generate import build_design as ref_build_design
from repro.designs.generate import load_corpus_specs as ref_load_corpus
from repro.launch.mesh import device_grid as ref_device_grid
from repro.launch.mesh import make_production_mesh as ref_production_mesh
from repro.launch.mesh import ensure_host_platform_devices

from repro_torch.core import EvalConfig
from repro_torch.core.backends import HeteroDispatcher, MeshBackend
from repro_torch.core.backends.pallas import CudaBackend
from repro_torch.core.campaign import Campaign, CampaignSpec
from repro_torch.core.condense import condense_auto
from repro_torch.core.simgraph import build_simgraph
from repro_torch.core.simulate import BatchedEvaluator
from repro_torch.designs import make_design, mult_by_2
from repro_torch.designs.generate import build_design, load_corpus_specs
from repro_torch.kernels.fifo_eval.ops import DISPATCH_COUNTS
from repro_torch.launch import campaign as campaign_cli
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import (Mesh, device_grid,
                                     ensure_host_platform_devices as
                                     port_ensure, make_campaign_mesh,
                                     make_eval_mesh, make_local_mesh,
                                     make_production_mesh)

# the reference's mesh needs jax host devices, requested before jax
# starts (as tests/test_mesh.py does); the comparisons against the
# reference's solo backends never need them
ensure_host_platform_devices(4)

import jax  # noqa: E402

CPU = torch.device("cpu")
CORPUS = sorted(glob.glob(os.path.join(os.path.dirname(__file__),
                                       "fuzz_corpus", "*.json")))
SHARDS = (1, 2, 4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _need_jax_devices(n: int):
    if jax.device_count() < n:
        pytest.skip(f"the reference's mesh needs {n} jax devices "
                    f"(jax started with {jax.device_count()})")


def _configs(g, C, seed=0, lo=0.1):
    """Depth rows spanning feasible and deadlock-prone corners."""
    rng = np.random.default_rng(seed)
    u = np.asarray(g.upper_bounds, dtype=np.int64)
    rows = [u, np.ones_like(u)]
    rows += [np.maximum(1, (u * rng.uniform(lo, 1.0, u.size))
                        .astype(np.int64)) for _ in range(C - 2)]
    return np.stack(rows[:C])


@pytest.fixture(scope="module")
def corpus():
    """[(name, reference graph, port graph)] of the fuzz corpus."""
    out = []
    for path, rs, ps in zip(CORPUS, ref_load_corpus(CORPUS),
                            load_corpus_specs(CORPUS)):
        out.append((os.path.basename(path),
                    ref_build_simgraph(ref_build_design(rs).design),
                    build_simgraph(build_design(ps).design)))
    assert out, "tests/fuzz_corpus/*.json missing"
    return out


def _equal(got, want, msg=""):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype, msg
        np.testing.assert_array_equal(a, b, err_msg=msg)


# ------------------------------------------------------------- identity
@pytest.mark.parametrize("inner", ["fixpoint", "cuda"])
@pytest.mark.parametrize("shards", SHARDS)
def test_mesh_backend_equals_reference_solo_backends(corpus, shards, inner):
    """Raw triples (status included: UNRESOLVED rows stay UNRESOLVED)
    equal the reference's solo fixpoint; through the evaluator (rung
    cascade and escalation) the reference's numpy evaluator."""
    for name, ref_g, g in corpus:
        cfgs = _configs(g, 10, seed=sum(map(ord, name)))
        ref = RefFixpoint(max_iters=128)
        ref.prepare(ref_g)
        impl = MeshBackend(max_iters=128, shards=shards, inner=inner,
                           device="cpu")
        impl.prepare(g)
        assert impl.n_shards == shards and impl.inner == inner
        _equal(impl.evaluate(cfgs), ref.evaluate(cfgs), f"{name}:{inner}")
        want = RefEvaluator(ref_g, RefEvalConfig(
            backend="numpy", max_iters=128)).evaluate(cfgs)
        ev = BatchedEvaluator(g, EvalConfig(backend="mesh", max_iters=128,
                                            shards=shards), device="cpu")
        _equal(ev.evaluate(cfgs), want, name)


@pytest.mark.parametrize("shards", (2, 4))
def test_mesh_backend_equals_reference_mesh(corpus, shards):
    _need_jax_devices(shards)
    from repro.core.backends.mesh import MeshBackend as RefMesh
    for name, ref_g, g in corpus:
        cfgs = _configs(g, 9, seed=3)
        ref = RefMesh(max_iters=128, shards=shards)
        ref.prepare(ref_g)
        impl = MeshBackend(max_iters=128, shards=shards, inner="fixpoint",
                           device="cpu")
        impl.prepare(g)
        _equal(impl.evaluate(cfgs), ref.evaluate(cfgs), name)


def test_deadlock_verdicts_identical_across_shard_counts():
    """mult_by_2(n) deadlocks iff depth(x) < n - 1."""
    g = build_simgraph(mult_by_2(16))
    cfgs = np.array([[14, 2], [15, 2], [16, 2], [2, 2], [13, 3]])
    expect_dead = np.array([True, False, False, True, True])
    for shards in SHARDS:
        lat, _, dead = BatchedEvaluator(
            g, EvalConfig(backend="mesh", max_iters=64, shards=shards),
            device="cpu").evaluate(cfgs)
        np.testing.assert_array_equal(dead, expect_dead)
        assert (lat[dead] == -1).all()


def test_ragged_batches_pad_to_shard_multiples_exactly():
    g = build_simgraph(make_design("gemm"))
    solo = BatchedEvaluator(g, EvalConfig(backend="fixpoint", max_iters=64),
                            device="cpu")
    mesh = BatchedEvaluator(g, EvalConfig(backend="mesh", max_iters=64,
                                          shards=4), device="cpu")
    assert mesh.dispatch.shard_multiple == 4
    assert mesh.dispatch.pad_batch(np.zeros((5, 3))).shape[0] == 8
    all_cfgs = _configs(g, 37, seed=7)
    for C in (1, 3, 5, 37):
        got = mesh.evaluate(all_cfgs[:C])
        for a, b in zip(got, solo.evaluate(all_cfgs[:C])):
            assert a.shape[0] == C
            np.testing.assert_array_equal(a, b, err_msg=f"C={C}")


def test_fused_certificate_shards_identically():
    """On the aggressive rung the mesh exposes K1's fused certificate per
    shard; latency, BRAM, status and the certificate mask equal the solo
    kernel backend's, ragged batches included, and every shard counts its
    launch."""
    g = build_simgraph(make_design("gemm"))
    cg = condense_auto(g)[0]
    solo = CudaBackend(device="cpu")
    solo.prepare(cg)
    assert solo.fused_certificate
    cfgs = _configs(g, 9, seed=5, lo=0.4)
    ref = solo.evaluate_certified(cfgs)
    assert ref[3].any(), "the batch must certify some rows"
    for shards in (2, 4):
        impl = MeshBackend(shards=shards, device="cpu")
        impl.prepare(cg)
        assert impl.fused_certificate
        for C in (1, 4, 9):
            DISPATCH_COUNTS.clear()
            got = impl.evaluate_certified(cfgs[:C])
            _equal(got, tuple(r[:C] for r in ref), f"{shards}:{C}")
            assert dict(DISPATCH_COUNTS) == dict(
                {"condensed": 1},
                **{f"condensed@shard{i}": 1 for i in range(shards)})


def test_shard_multiple_must_divide_the_rows():
    from repro_torch.kernels.fifo_eval.ops import make_batched_eval
    g = build_simgraph(mult_by_2(8))
    call = make_batched_eval(g, device="cpu",
                             mesh=make_eval_mesh(2, device="cpu"))
    with pytest.raises(ValueError, match="multiple of the mesh size"):
        call(np.array([[7, 1], [2, 2], [9, 3]]))


# ------------------------------------------------- campaign and service
def _hetero_graphs():
    ref = {"m24": ref_mult_by_2(24), "gemm": ref_make_design("gemm")}
    port = {"m24": mult_by_2(24), "gemm": make_design("gemm")}
    return ({k: ref_build_simgraph(d) for k, d in ref.items()},
            {k: build_simgraph(d) for k, d in port.items()})


def _hetero_items(graphs):
    return [(k, _configs(g, c, seed=i)) for i, ((k, g), c)
            in enumerate(zip(graphs.items(), (5, 2)))]


def test_hetero_dispatcher_on_a_campaign_mesh_equals_per_design():
    """2x2 ("design", "eval") CPU mesh: rows equal the reference's
    unsharded dispatcher and each design's evaluator."""
    ref_graphs, graphs = _hetero_graphs()
    mesh = make_campaign_mesh(2, 2, device="cpu")
    assert (mesh.axis_names, mesh.shape, mesh.size) == (
        ("design", "eval"), (2, 2), 4)
    hd = HeteroDispatcher(graphs, mesh=mesh)
    assert hd.shard_multiple == 4 and hd.device == CPU
    ref = RefHeteroDispatcher(ref_graphs)
    items = _hetero_items(graphs)
    for _ in range(2):
        for (k, cfgs), got, want in zip(items, hd.dispatch(items),
                                        ref.dispatch(items)):
            _equal(got, want, k)
            solo = RefEvaluator(ref_graphs[k], RefEvalConfig(
                backend="numpy", max_iters=64)).evaluate(cfgs)
            _equal(got, solo, k)


def test_hetero_stats_on_a_campaign_mesh_equal_the_reference():
    _need_jax_devices(4)
    from repro.launch.mesh import make_campaign_mesh as ref_campaign_mesh
    ref_graphs, graphs = _hetero_graphs()
    hd = HeteroDispatcher(graphs, mesh=make_campaign_mesh(2, 2,
                                                          device="cpu"))
    ref = RefHeteroDispatcher(ref_graphs, mesh=ref_campaign_mesh(2, 2))
    items = _hetero_items(graphs)
    for got, want in zip(hd.dispatch(items), ref.dispatch(items)):
        _equal(got, want)
    for f in ("n_dispatches", "n_rows", "n_pad_rows", "n_fallbacks"):
        assert getattr(hd.stats, f) == getattr(ref.stats, f), f


def _stores_equal(got, want):
    assert list(got.keys()) == list(want.keys())
    for k in want.keys():
        a, b = got[k], want[k]
        for f in ("configs", "latency", "bram", "deadlock"):
            np.testing.assert_array_equal(getattr(a.result, f),
                                          getattr(b.result, f), err_msg=k)
        assert a.hypervolume() == b.hypervolume(), k


@pytest.mark.parametrize("hetero", [True, False])
def test_campaign_with_shards_stores_the_same(hetero):
    spec = dict(designs=("gemm", "FeedForward"),
                optimizers=("grouped_random",), budget=30, seed=0,
                workers=0, hetero=hetero)
    want = Campaign(CampaignSpec(**spec, eval=EvalConfig(backend="cuda")),
                    device="cpu").run()
    camp = Campaign(CampaignSpec(**spec, eval=EvalConfig(backend="cuda",
                                                         shards=2)),
                    device="cpu")
    if hetero:
        assert camp.hetero.shard_multiple == 2
    else:
        assert all(d.evaluator.backend == "mesh"
                   for d in camp.designs.values())
    _stores_equal(camp.run(), want)


#: summary fields that carry wall-clock seconds, and nothing else
WALL_KEYS = {"wall_s", "runtime_s", "total_runtime_s", "trace_time_s"}


def _strip_walls(obj):
    if isinstance(obj, dict):
        return {k: _strip_walls(v) for k, v in obj.items()
                if k not in WALL_KEYS}
    if isinstance(obj, list):
        return [_strip_walls(v) for v in obj]
    return obj


def test_campaign_cli_with_shards_prints_the_same(tmp_path, capsys):
    def run(extra, out):
        assert campaign_cli.main(
            ["--designs", "gemm", "--optimizers", "grouped_sa", "--budget",
             "30", "--hetero", "--workers", "0", "--device", "cpu",
             "--out", str(out), *extra]) == 0
        text = capsys.readouterr().out
        with open(out) as f:
            res = _strip_walls(json.load(f))
        table = [ln for ln in text.splitlines() if ln.startswith("gemm:")]
        return res, table

    got, got_table = run(["--shards", "2"], tmp_path / "sharded.json")
    want, want_table = run([], tmp_path / "solo.json")
    assert got == want and got_table == want_table and got_table


# ----------------------------------------------------- topology + wiring
def test_device_grid_equals_the_reference():
    for n in range(1, 65):
        assert device_grid(n) == ref_device_grid(n), n
    with pytest.raises(ValueError):
        device_grid(0)


def test_mesh_constructors():
    assert port_ensure(8) is True
    m = make_eval_mesh(3, device="cpu")
    assert (m.axis_names, m.shape, m.size, m.devices) == (
        ("eval",), (3,), 3, (CPU,) * 3)
    assert make_eval_mesh(device="cpu").size == 1
    m = make_eval_mesh(devices=["cpu"] * 4)
    assert m.size == 4
    with pytest.raises(ValueError, match="needs 5 devices"):
        make_eval_mesh(5, devices=["cpu"] * 4)
    assert make_campaign_mesh(device="cpu").shape == (1, 1)
    assert make_campaign_mesh(2, 3, device="cpu").size == 6
    assert make_campaign_mesh(devices=["cpu"] * 8).shape == (2, 4)
    assert make_campaign_mesh(eval_shards=2, devices=["cpu"] * 8
                              ).shape == (4, 2)
    with pytest.raises(ValueError, match="needs"):
        make_campaign_mesh(2, 5, devices=["cpu"] * 8)
    with pytest.raises(ValueError):
        Mesh(("eval",), (2,), (CPU,))


def test_mesh_constructors_count_the_cards(monkeypatch):
    """The default devices are the cards, ``cuda:0..n-1``; more shards
    than cards raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    m = make_eval_mesh()
    assert m.devices == (torch.device("cuda", 0), torch.device("cuda", 1))
    with pytest.raises(ValueError, match="needs 3 devices"):
        make_eval_mesh(3)
    assert make_campaign_mesh().shape == (1, 2)


def test_spawn_keeps_the_mesh_and_inner_spellings():
    impl = MeshBackend(shards=2, inner="pallas", device="cpu")
    assert impl.inner == "cuda" and not impl.use_ref
    clone = impl.spawn()
    assert clone.mesh is impl.mesh and clone.inner == impl.inner
    assert clone.device == impl.device
    assert MeshBackend(shards=2, inner="fixpoint", device="cpu").use_ref
    with pytest.raises(ValueError, match="inner"):
        MeshBackend(shards=2, inner="jnp", device="cpu")


# --------------------------------------------------- production meshes
@pytest.mark.parametrize("n", [1, 8, 256, 512])
def test_production_mesh_over_n_ranks_has_the_reference_s_shape(n):
    """Over ``n`` ranks (a fake group; one CPU without one) the shapes
    the reference derives from ``n`` devices, and its axis names."""
    with fake_world(n):
        m = make_production_mesh(device="cpu")
        assert (m.shape, m.axis_names) == (ref_device_grid(n),
                                           ("data", "model"))
        if n > 1:
            m = make_production_mesh(multi_pod=True, device="cpu")
            assert m.shape == (2,) + ref_device_grid(n // 2)
            assert m.axis_names == ("pod", "data", "model")
            dm = m.device_mesh()
            assert dm.mesh_dim_names == m.axis_names
            assert tuple(dm.mesh.shape) == m.shape
            assert dm.mesh.flatten().tolist() == list(range(n))
            assert make_production_mesh(shape=(2, n // 2),
                                        device="cpu").shape == (2, n // 2)
            with pytest.raises(ValueError, match="needs"):
                make_production_mesh(shape=(2, n), device="cpu")
        else:
            with pytest.raises(ValueError, match="even device count"):
                make_production_mesh(multi_pod=True, device="cpu")
    assert not torch.distributed.is_initialized()


def test_production_mesh_raises_where_the_reference_raises():
    for shape in [(2,), (1, 1, 1, 1)]:
        with pytest.raises(ValueError, match="2-D") as port:
            make_production_mesh(shape=shape, device="cpu")
        with pytest.raises(ValueError, match="2-D") as ref:
            ref_production_mesh(shape=shape)
        assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError, match="needs an even") as port:
        make_production_mesh(multi_pod=True, device="cpu")
    if jax.device_count() == 1:
        with pytest.raises(ValueError, match="needs an even") as ref:
            ref_production_mesh(multi_pod=True)
        assert str(port.value) == str(ref.value)
    # a CPU mesh repeats the CPU as often as the shape asks
    m = make_production_mesh(shape=(2, 2, 4), device="cpu")
    assert (m.axis_names, m.size) == (("pod", "data", "model"), 16)
    loc = make_local_mesh(device="cpu")
    assert (loc.shape, loc.axis_names, loc.devices) == (
        (1, 1), ("data", "model"), (CPU,))


def test_device_mesh_needs_a_group_of_the_mesh_s_size():
    m = make_production_mesh(shape=(2, 2), device="cpu")
    with pytest.raises(RuntimeError, match="world size 4"):
        m.device_mesh()
    with fake_world(8):
        with pytest.raises(RuntimeError, match="world size 4"):
            m.device_mesh()
    with fake_world(4):
        dm = m.device_mesh()
        assert m.device_mesh() is dm            # kept on the mesh
        merged = m.device_mesh((("data", "model"),))
        assert merged.mesh_dim_names == ("data.model",)
        assert tuple(merged.mesh.shape) == (4,)
        with pytest.raises(ValueError, match="cover"):
            m.device_mesh((("model",), ("data",)))
    with fake_world(4):
        assert m.device_mesh() is not dm        # a new group, a new mesh
    # the row-sharding meshes never build one
    assert "_device_meshes" not in make_eval_mesh(4, device="cpu").__dict__
