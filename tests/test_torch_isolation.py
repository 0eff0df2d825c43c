"""The port stands alone: importing every module of ``repro_torch`` pulls
in neither jax nor the reference package, no source line imports them,
and without a CUDA device the tensor entry points raise instead of
quietly running on the CPU."""

import os
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import EvalConfig, FifoAdvisor
from repro_torch.core.backends import get_backend
from repro_torch.core.backends.base import resolve_device
from repro_torch.core.simgraph import build_simgraph
from repro_torch.core.simulate import BatchedEvaluator
from repro_torch.designs import mult_by_2

PKG_DIR = os.path.dirname(repro_torch.__file__)
SRC_DIR = os.path.dirname(PKG_DIR)
ROOT = os.path.dirname(SRC_DIR)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG_DIR], prefix="repro_torch."))


def test_importing_every_module_loads_no_jax_and_no_reference():
    mods = _modules()
    for m in ("kernels.fifo_eval.condensed", "core.backends.mesh",
              "launch.mesh", "launch.decode_demo", "models.transformer",
              "models.moe", "models.ssm", "configs.base", "train.steps",
              "train.optimizer", "train.checkpoint", "train.data",
              "launch.train", "launch.dryrun"):
        assert "repro_torch." + m in mods, m
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=SRC_DIR)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


_IMPORT = re.compile(
    r"^\s*(import\s+(jax|repro)\b(?!_)|from\s+(jax|repro)(\.|\s)(?!_))",
    re.MULTILINE)


def test_no_source_imports_jax_or_reference():
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG_DIR)
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    hits = []
    for path in files:
        with open(path) as fh:
            src = fh.read()
        hits += [f"{path}: {m.group(0).strip()}"
                 for m in _IMPORT.finditer(src)]
    assert not hits, hits


def test_import_pattern_catches_what_it_should():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import x",
                 "from repro.core import a", "import repro", "from repro "
                 "import core"):
        assert _IMPORT.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import a"):
        assert not _IMPORT.search(line), line


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_cuda(no_cuda):
    g = build_simgraph(mult_by_2(8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    for backend in ("cuda", "pallas", "fixpoint", "jax"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BatchedEvaluator(g, EvalConfig(backend=backend))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            get_backend(backend)(max_iters=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FifoAdvisor(mult_by_2(8))
    # calibration races the device's backend, so it needs the card too
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedEvaluator(g, EvalConfig(backend="auto"))
    assert EvalConfig().backend == "cuda"


def test_cpu_is_only_taken_when_asked(no_cuda):
    g = build_simgraph(mult_by_2(8))
    rows = np.array([[7, 1], [2, 2], [9, 3]])
    want = BatchedEvaluator(g, EvalConfig(backend="numpy")).evaluate(rows)
    got = BatchedEvaluator(g, EvalConfig(backend="cuda"),
                           device="cpu").evaluate(rows)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("backend", ["mesh", "sharded"])
def test_unported_backends_name_their_roadmap_item(backend):
    """Both spellings of the row-sharded backend build a ``MeshBackend``
    on the CPU that equals the plain fixpoint; without a card they raise
    unless the CPU is asked for."""
    from repro_torch.core.backends.mesh import MeshBackend
    g = build_simgraph(mult_by_2(8))
    rows = np.array([[7, 1], [2, 2], [9, 3]])
    ev = BatchedEvaluator(g, EvalConfig(backend=backend, shards=2),
                          device="cpu")
    assert isinstance(ev._impl, MeshBackend) and ev._impl.n_shards == 2
    want = BatchedEvaluator(g, EvalConfig(backend="fixpoint"),
                            device="cpu").evaluate(rows)
    for a, b in zip(ev.evaluate(rows), want):
        np.testing.assert_array_equal(a, b)
    assert get_backend(backend) is MeshBackend


def test_new_entry_points_raise_without_cuda(no_cuda):
    """The LLM demo and the default device mesh need the card; the CPU
    is taken only when asked for."""
    from repro_torch.launch import decode_demo
    from repro_torch.launch.mesh import (make_campaign_mesh,
                                         make_eval_mesh)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode_demo.main(["--arch", "qwen2-1.5b", "--batch", "1",
                          "--prompt-len", "8", "--gen", "2"])
    for make in (make_eval_mesh, make_campaign_mesh):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    g = build_simgraph(mult_by_2(8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedEvaluator(g, EvalConfig(backend="mesh", shards=1))
    assert make_eval_mesh(3, device="cpu").devices == \
        (torch.device("cpu"),) * 3
    assert make_eval_mesh(2, devices=["cuda:0"] * 2).size == 2
