"""The port's warm-restart snapshots against the reference package.

The port keeps the reference's on-disk format (``SNAPSHOT_VERSION``,
content-addressed members, ``MANIFEST.json``, the checksum), so a
snapshot written by either package loads warm in the other, and on the
numpy backend the two packages write the same bytes.  The port's own
snapshots (``backend="cuda"`` on ``device="cpu"``, the kernels' plain
versions) restore bit-identically — frontiers, histories, baselines,
certificates, cache contents — with zero fresh simulations; a damaged
member is quarantined, ``strict=True`` and manifest-level problems
raise :class:`SnapshotError`, as in the reference.  The config check
maps the backend aliases (``"pallas"`` is ``"cuda"``, ``"jax"`` is
``"fixpoint"``) and refuses any other difference.
"""

import dataclasses
import glob
import json
import os
import time

import numpy as np
import pytest
import torch

from repro.core import EvalConfig as RefEvalConfig
from repro.core import FifoAdvisor as RefAdvisor
from repro.core.condense import CondensedGraph as RefCondensedGraph
from repro.core.service import DesignRegistry as RefRegistry
from repro.core.service import SnapshotError as RefSnapshotError
from repro.core.service import load_snapshot as ref_load_snapshot
from repro.core.service import save_snapshot as ref_save_snapshot
from repro.core.service.snapshot import SNAPSHOT_VERSION as REF_VERSION
from repro.core.service.snapshot import _array_fields as ref_array_fields
from repro.core.simgraph import SimGraph as RefSimGraph
from repro.designs import make_design as ref_make_design

from repro_torch.core import EvalConfig, FifoAdvisor
from repro_torch.core.condense import CondensedGraph
from repro_torch.core.service import (AdvisoryService, DesignRegistry,
                                      ProtocolHandler, SnapshotError,
                                      load_snapshot, save_snapshot)
from repro_torch.core.service.snapshot import (MANIFEST, SNAPSHOT_VERSION,
                                               _array_fields)
from repro_torch.core.simgraph import SimGraph
from repro_torch.core.simulate import BatchedEvaluator
from repro_torch.designs import make_design

DESIGN = "gemm"
BUDGET = 60
CUDA = EvalConfig(backend="cuda", max_iters=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def warm_registry(config=CUDA, designs=(DESIGN,), budget=BUDGET):
    """A registry whose advisors have run a search (cache + history)."""
    reg = DesignRegistry(config, device="cpu")
    runs = {}
    for name in designs:
        runs[name] = reg.register(name).run("grouped_sa", budget=budget,
                                            seed=0)
    return reg, runs


def assert_same_search(got, want):
    for f in ("configs", "latency", "bram", "deadlock"):
        np.testing.assert_array_equal(getattr(got.result, f),
                                      getattr(want.result, f))
    np.testing.assert_array_equal(got.frontier_points, want.frontier_points)
    assert got.hypervolume() == want.hypervolume()


def _member(tmp_path, name=DESIGN):
    hits = glob.glob(str(tmp_path / f"{name}.*.snap.npz"))
    assert len(hits) == 1, hits
    return hits[0]


# ------------------------------------------------------------ round trip
def test_restore_is_bit_identical_and_simulates_nothing(tmp_path):
    reg, runs = warm_registry()
    save_snapshot(reg, str(tmp_path))

    t0 = time.perf_counter()
    reg2 = load_snapshot(str(tmp_path), device="cpu")
    restore_s = time.perf_counter() - t0
    adv, ref = reg2[DESIGN], reg[DESIGN]
    assert adv.config == ref.config
    assert adv.evaluator.device == torch.device("cpu")
    np.testing.assert_array_equal(adv.graph.upper_bounds,
                                  ref.graph.upper_bounds)
    assert adv.baseline_max.latency == ref.baseline_max.latency
    assert adv.baseline_min.deadlocked == ref.baseline_min.deadlocked
    assert len(adv.cache) == len(ref.cache)

    dse = adv.run("grouped_sa", budget=BUDGET, seed=0)
    assert dse.result.n_evals == 0
    assert_same_search(dse, runs[DESIGN])
    fresh = FifoAdvisor(make_design(DESIGN), CUDA, device="cpu")
    assert restore_s < max(0.5, fresh.trace_time_s), (
        f"restore took {restore_s:.3f}s vs trace {fresh.trace_time_s:.3f}s")


def test_restore_preserves_certified_floor(tmp_path):
    reg = DesignRegistry(EvalConfig(backend="cuda", max_iters=64,
                                    certified_floor=True), device="cpu")
    ref = reg.register("gemm")
    ref.run("grouped_random", budget=30, seed=0)
    assert ref._certification is not None
    save_snapshot(reg, str(tmp_path))
    adv = load_snapshot(str(tmp_path), device="cpu")["gemm"]
    cert, ref_cert = adv._certification, ref._certification
    assert cert is not None
    np.testing.assert_array_equal(cert.depths, ref_cert.depths)
    assert cert.latency == ref_cert.latency
    assert cert.n_probes == ref_cert.n_probes


def test_snapshot_skips_custom_designs(tmp_path):
    from repro_torch.core.design import Design
    d = Design("custom_inline")
    d.fifo("a", width=32)

    @d.task("src")
    def src(ctx):
        for i in range(8):
            yield ctx.delay(1)
            yield ctx.write("a", i)

    @d.task("sink")
    def sink(ctx):
        for _ in range(8):
            yield ctx.read("a")

    reg, _ = warm_registry()
    reg.register("custom_inline", d)
    manifest = save_snapshot(reg, str(tmp_path))
    assert manifest["skipped"] == ["custom_inline"]
    assert "custom_inline" not in manifest["designs"]
    assert load_snapshot(str(tmp_path), device="cpu").names() == [DESIGN]


# ------------------------------------------------------------- integrity
def test_gc_spares_superseded_generation(tmp_path):
    def members():
        return {os.path.basename(p) for p
                in glob.glob(str(tmp_path / "*.snap.npz"))}

    reg, _ = warm_registry()
    save_snapshot(reg, str(tmp_path))
    gen1 = members()
    reg[DESIGN].run("grouped_sa", budget=10, seed=1)
    save_snapshot(reg, str(tmp_path))
    assert gen1 < members()
    reg[DESIGN].run("grouped_sa", budget=10, seed=2)
    save_snapshot(reg, str(tmp_path))
    assert gen1.isdisjoint(members())
    load_snapshot(str(tmp_path), strict=True, device="cpu")


def test_tampered_snapshot_is_quarantined_and_strict_rejects(tmp_path):
    reg, _ = warm_registry()
    save_snapshot(reg, str(tmp_path))
    victim = _member(tmp_path)
    with open(victim, "r+b") as fh:
        blob = bytearray(fh.read())
        blob[len(blob) // 2] ^= 0xFF
        fh.seek(0)
        fh.write(bytes(blob))
    with pytest.raises(SnapshotError, match="checksum"):
        load_snapshot(str(tmp_path), strict=True, device="cpu")
    rep = load_snapshot(str(tmp_path), device="cpu").restore_report
    assert sorted(rep["quarantined"]) == [DESIGN]
    assert "checksum" in rep["quarantined"][DESIGN]
    assert rep["restored"] == []
    # the reference reads the same damage the same way
    assert ref_load_snapshot(str(tmp_path)).restore_report == rep


def test_version_mismatch_is_rejected(tmp_path):
    assert SNAPSHOT_VERSION == REF_VERSION
    reg, _ = warm_registry()
    save_snapshot(reg, str(tmp_path))
    mpath = tmp_path / MANIFEST
    manifest = json.loads(mpath.read_text())
    manifest["version"] = SNAPSHOT_VERSION + 1
    mpath.write_text(json.dumps(manifest))
    with pytest.raises(SnapshotError, match="version"):
        load_snapshot(str(tmp_path), device="cpu")


def test_missing_file_and_unreadable_manifest_rejected(tmp_path):
    reg, _ = warm_registry()
    save_snapshot(reg, str(tmp_path))
    os.remove(_member(tmp_path))
    with pytest.raises(SnapshotError, match="missing"):
        load_snapshot(str(tmp_path), strict=True, device="cpu")
    rep = load_snapshot(str(tmp_path), device="cpu").restore_report
    assert "missing" in rep["quarantined"][DESIGN]
    with pytest.raises(SnapshotError, match="manifest"):
        load_snapshot(str(tmp_path / "no_such_dir"), device="cpu")


def test_config_mismatch_is_rejected(tmp_path):
    """A ``max_iters`` mismatch is refused, by the port and by the
    reference, with "config" in the message; the backend aliases are
    one config; a matching registry adopts."""
    reg, _ = warm_registry(EvalConfig(backend="numpy", max_iters=64))
    save_snapshot(reg, str(tmp_path))
    other = DesignRegistry(EvalConfig(backend="numpy", max_iters=128),
                           device="cpu")
    with pytest.raises(SnapshotError, match="config"):
        load_snapshot(str(tmp_path), other)
    with pytest.raises(RefSnapshotError, match="config"):
        ref_load_snapshot(str(tmp_path), RefRegistry(
            RefEvalConfig(backend="numpy", max_iters=128)))
    with pytest.raises(SnapshotError, match="config"):
        load_snapshot(str(tmp_path), DesignRegistry(
            EvalConfig(backend="cuda", max_iters=64), device="cpu"))
    ok = DesignRegistry(EvalConfig(backend="numpy", max_iters=64),
                        device="cpu")
    load_snapshot(str(tmp_path), ok)
    assert ok.names() == [DESIGN]

    pallas = tmp_path / "pallas"
    reg, _ = warm_registry(EvalConfig(backend="pallas", max_iters=64))
    manifest = save_snapshot(reg, str(pallas))
    assert manifest["config"]["backend"] == "pallas"   # as it was given
    alias = DesignRegistry(CUDA, device="cpu")
    load_snapshot(str(pallas), alias)
    assert alias.names() == [DESIGN]
    with pytest.raises(SnapshotError, match="config"):
        load_snapshot(str(pallas), DesignRegistry(
            EvalConfig(backend="fixpoint", max_iters=64), device="cpu"))


# ----------------------------------------------------- protocol + service
def test_snapshot_op_and_warm_first_answer(tmp_path):
    svc = AdvisoryService(config=CUDA, device="cpu")
    handler = ProtocolHandler(svc, snapshot_dir=str(tmp_path))
    opened = handler.handle({"op": "open", "design": DESIGN,
                             "optimizer": "grouped_sa", "budget": BUDGET})
    assert opened["ok"]
    handler.handle({"op": "run"})
    ref = handler.handle({"op": "result", "session": opened["session"]})
    snap = handler.handle({"op": "snapshot"})
    assert snap["ok"] and snap["designs"] == [DESIGN]
    svc.close()

    t0 = time.perf_counter()
    svc2 = AdvisoryService(registry=load_snapshot(str(tmp_path),
                                                  device="cpu"))
    handler2 = ProtocolHandler(svc2)
    opened2 = handler2.handle({"op": "open", "design": DESIGN,
                               "optimizer": "grouped_sa",
                               "budget": BUDGET})
    handler2.handle({"op": "run"})
    res = handler2.handle({"op": "result", "session": opened2["session"]})
    first_answer_s = time.perf_counter() - t0
    assert res["result"]["frontier"] == ref["result"]["frontier"]
    assert res["result"]["n_evals"] == 0
    assert first_answer_s < 2.0, f"warm first answer {first_answer_s:.2f}s"
    svc2.close()


# ------------------------------------------------------- across packages
def test_snapshot_fields_match_the_reference():
    """The npz member names come from the dataclass fields: both
    packages' SimGraph and CondensedGraph must keep the same ones, and
    the rungs are read from ``BatchedEvaluator.condensation``."""
    assert _array_fields(SimGraph) == ref_array_fields(RefSimGraph)
    assert _array_fields(CondensedGraph) == \
        ref_array_fields(RefCondensedGraph)
    assert [f.name for f in dataclasses.fields(SimGraph)] == \
        [f.name for f in dataclasses.fields(RefSimGraph)]
    assert [f.name for f in dataclasses.fields(CondensedGraph)] == \
        [f.name for f in dataclasses.fields(RefCondensedGraph)]
    port = FifoAdvisor(make_design("gemm"), EvalConfig(backend="numpy"),
                       device="cpu").evaluator
    ref = RefAdvisor(ref_make_design("gemm")).evaluator
    assert isinstance(port, BatchedEvaluator)
    assert [(cg.tag, cg.n_events) for cg, _ in port.condensation] == \
        [(cg.tag, cg.n_events) for cg, _ in ref.condensation]


def test_numpy_snapshots_are_byte_identical(tmp_path):
    """On the numpy backend the two packages write the same member
    bytes (so the same content-addressed names) and the same manifest."""
    cfg = dict(backend="numpy")
    port, _ = warm_registry(EvalConfig(**cfg), designs=("gemm", "atax"),
                            budget=30)
    ref = RefRegistry(RefEvalConfig(**cfg))
    for name in ("gemm", "atax"):
        ref.register(name).run("grouped_sa", budget=30, seed=0)
    got = save_snapshot(port, str(tmp_path / "port"))
    want = ref_save_snapshot(ref, str(tmp_path / "ref"))
    assert got == want
    for entry in got["designs"].values():
        with open(tmp_path / "port" / entry["file"], "rb") as a, \
                open(tmp_path / "ref" / entry["file"], "rb") as b:
            assert a.read() == b.read()


def test_reference_pallas_snapshot_restores_warm_in_the_port(tmp_path):
    """A snapshot the reference writes on its ``pallas`` backend (atax:
    the smallest Stream-HLS design, so interpret mode stays cheap)
    restores warm in the port, whose ``cuda`` registry reads ``pallas``
    as its own name: no fresh simulation, the same frontier."""
    ref = RefRegistry(RefEvalConfig(backend="pallas"))
    want = ref.register("atax").run("grouped_sa", budget=30, seed=0)
    ref_save_snapshot(ref, str(tmp_path))
    reg = load_snapshot(str(tmp_path), DesignRegistry(device="cpu"))
    assert reg.restore_report == {"restored": ["atax"], "quarantined": {}}
    adv = reg["atax"]
    assert adv.config.backend == "pallas"
    assert adv.evaluator.device == torch.device("cpu")
    dse = adv.run("grouped_sa", budget=30, seed=0)
    assert dse.result.n_evals == 0
    assert_same_search(dse, want)
    fresh = load_snapshot(str(tmp_path), device="cpu")   # its own registry
    assert fresh.config.backend == "pallas"


def test_port_numpy_snapshot_restores_warm_in_the_reference(tmp_path):
    reg, runs = warm_registry(EvalConfig(backend="numpy"),
                              designs=("gemm", "FeedForward"), budget=40)
    save_snapshot(reg, str(tmp_path))
    ref = ref_load_snapshot(str(tmp_path), strict=True)
    assert sorted(ref.names()) == ["FeedForward", "gemm"]
    for name in ref.names():
        dse = ref[name].run("grouped_sa", budget=40, seed=0)
        assert dse.result.n_evals == 0
        assert_same_search(dse, runs[name])
