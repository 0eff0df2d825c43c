"""The port's differential fuzz CLI (``python -m repro_torch.launch.fuzz``)
and the cross-package gate.

The CLI exits 0 in its three modes (``diff`` over the port's backends,
``bounds``, ``chaos`` on the port's pool and fault plan) with the
committed corpus replayed from a temporary copy, 2 on an empty seed
range, and 1 — after shrinking the failing spec and writing a corpus
entry — when a deliberately wrong backend is registered.  The gate: on
the same seeds, the port's and the reference fuzzer's summaries are
equal, and so are the depth matrices, the oracle's latencies and
deadlock verdicts, and every backend's latencies."""

import glob
import json
import os
import shutil

import numpy as np
import pytest
import torch

from repro.core import EvalConfig as RefEvalConfig
from repro.core.oracle import simulate as ref_simulate
from repro.core.simgraph import build_simgraph as ref_build_simgraph
from repro.core.simulate import BatchedEvaluator as RefEvaluator
from repro.designs.generate import build_design as ref_build_design
from repro.designs.generate import spec_from_seed as ref_spec_from_seed
from repro.launch import fuzz as ref_fuzz

from repro_torch.core import BatchedEvaluator, EvalConfig
from repro_torch.core.backends import DEADLOCK, BACKENDS, WorklistBackend
from repro_torch.core.backends.base import register_backend
from repro_torch.core.oracle import simulate
from repro_torch.core.simgraph import build_simgraph
from repro_torch.designs.generate import build_design, spec_from_seed
from repro_torch.launch import fuzz

CORPUS_DIR = os.path.join(os.path.dirname(__file__), "fuzz_corpus")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain kernels run many tiny torch ops; with several test
    workers on one host, torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def corpus(tmp_path):
    """A temporary copy of the committed corpus, so that no run writes
    into the tree."""
    dst = tmp_path / "corpus"
    shutil.copytree(CORPUS_DIR, dst)
    return str(dst)


@pytest.mark.parametrize("mode", ["diff", "bounds"])
def test_cli_exits_zero(corpus, mode, capsys):
    assert fuzz.main(["--seeds", "0:20", "--quick", "--corpus", corpus,
                      "--mode", mode]) == 0
    out = capsys.readouterr().out
    assert "corpus: 3 specs replayed, 0 regressions" in out
    assert "disagreements: 0" in out
    assert sorted(os.listdir(corpus)) == sorted(os.listdir(CORPUS_DIR))


def test_cli_diff_over_the_tensor_backends_on_cpu(corpus, capsys):
    assert fuzz.main(["--seeds", "0:6", "--quick", "--corpus", corpus,
                      "--device", "cpu", "--backends",
                      "worklist,condensed,fixpoint,cuda,cuda-condensed"]
                     ) == 0
    assert "disagreements: 0" in capsys.readouterr().out


def test_cli_chaos_exits_zero(corpus, capsys):
    import multiprocessing as mp
    assert fuzz.main(["--seeds", "0:3", "--quick", "--mode", "chaos",
                      "--corpus", corpus]) == 0
    assert "disagreements: 0" in capsys.readouterr().out
    assert mp.active_children() == []


@pytest.mark.parametrize("seeds", ["5:5", "10:2", "x"])
def test_cli_rejects_empty_seed_range(seeds, capsys):
    assert fuzz.main(["--seeds", seeds, "--quick"]) == 2
    assert "error" in capsys.readouterr().err


def test_wrong_backend_is_shrunk_into_the_corpus(corpus, monkeypatch,
                                                 capsys):
    """A registered backend that reports one cycle too many drives
    mismatch -> shrink -> corpus entry -> exit 1."""

    class OffByOne(WorklistBackend):
        name = "off_by_one"
        aliases = ()       # the worklist's own aliases stay the worklist's

        def evaluate(self, depth_matrix):
            lat, bram, status = super().evaluate(depth_matrix)
            return lat + (status != DEADLOCK), bram, status

    monkeypatch.setitem(BACKENDS, "off_by_one", None)
    register_backend(OffByOne)
    assert BACKENDS["numpy"] is WorklistBackend
    rc = fuzz.main(["--seeds", "3:4", "--quick", "--corpus", corpus,
                    "--backends", "off_by_one"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "minimal repro" in out and "latency on off_by_one" in out
    path = os.path.join(corpus, "shrunk_seed3.json")
    with open(path) as f:
        entry = json.load(f)
    assert entry["mismatch"]["kind"] == "latency"
    assert entry["mismatch"]["backend"] == "off_by_one"
    # the shrunk spec still fails, and is no larger than the original
    spec = fuzz.DesignSpec.from_json(entry["spec"])
    mism, _ = fuzz.fuzz_one(spec, ["off_by_one"], n_random=4)
    assert any(m.kind == "latency" for m in mism)
    assert len(spec.stages) <= len(spec_from_seed(3, quick=True).stages)


def test_cross_package_summaries_equal(tmp_path):
    """The gate, at the CLI: the same seeds and backends through both
    fuzzers give equal summaries (designs, rows, zero disagreements)."""
    for mode, backends in (("diff", "worklist,condensed"),
                           ("bounds", "worklist")):
        got_p, want_p = tmp_path / "port.json", tmp_path / "ref.json"
        args = ["--seeds", "0:12", "--quick", "--mode", mode,
                "--backends", backends, "--corpus", CORPUS_DIR]
        assert fuzz.main(args + ["--out", str(got_p)]) == 0
        assert ref_fuzz.main(args + ["--out", str(want_p)]) == 0
        got, want = json.loads(got_p.read_text()), \
            json.loads(want_p.read_text())
        for d in (got, want):
            d.pop("wall_s")
        assert got == want
        assert got["mismatches"] == []


@pytest.mark.parametrize("seed", list(range(8)))
def test_cross_package_verdicts_and_latencies_equal(seed):
    """The gate, row by row: the depth matrix, the oracle's latency and
    deadlock verdict, and every backend's latency and verdict, in the
    port equal the reference's (the port's tensor backends on the
    CPU)."""
    spec = spec_from_seed(seed, quick=True)
    ref_spec = ref_spec_from_seed(seed, quick=True)
    assert spec.to_json() == ref_spec.to_json()
    gen, ref_gen = build_design(spec), ref_build_design(ref_spec)
    g, ref_g = build_simgraph(gen.design), ref_build_simgraph(ref_gen.design)
    m = fuzz.depth_configs(g, np.random.default_rng(seed))
    np.testing.assert_array_equal(
        m, ref_fuzz.depth_configs(ref_g, np.random.default_rng(seed)))
    for row in m:
        a, b = simulate(gen.design, row), ref_simulate(ref_gen.design, row)
        assert (a.latency, a.deadlocked) == (b.latency, b.deadlocked)
    want = RefEvaluator(ref_g, RefEvalConfig(backend="worklist",
                                             max_iters=64)).evaluate(m)
    for name in ("worklist", "fixpoint", "cuda"):
        got = BatchedEvaluator(g, EvalConfig(backend=name, max_iters=64),
                               device="cpu").evaluate(m)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b, err_msg=name)
    mism, n = fuzz.fuzz_one(spec, ["worklist", "condensed", "cuda"],
                            n_random=4, device="cpu")
    ref_mism, ref_n = ref_fuzz.fuzz_one(ref_spec, ["worklist", "condensed"],
                                        n_random=4)
    assert (mism, n) == ([], ref_n) and ref_mism == []


def test_resolve_backends_names_the_ports_backends():
    names = fuzz.resolve_backends("auto")
    assert {"worklist", "fixpoint", "cuda", "condensed",
            "cuda-condensed"} <= set(names)
    assert fuzz.resolve_backends("worklist, cuda") == ["worklist", "cuda"]
    assert glob.glob(os.path.join(CORPUS_DIR, "*.json"))
