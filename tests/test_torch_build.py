"""Where the port builds its CUDA kernels: the compile cache.

The reference points jax's persistent compilation cache at
``$REPRO_JIT_CACHE_DIR`` (``repro/core/backends/jaxcfg.py``).  The
port compiles nothing per shape: it builds one shared library per source
hash, and with ``REPRO_JIT_CACHE_DIR`` set (and ``REPRO_TORCH_BUILD_DIR``
not) it builds into that directory, so a restarted server loads the
library instead of rebuilding it.  There is no nvcc on a CPU host, so the
build runs a stand-in compiler that writes its ``-o`` target."""

import os
import stat
import sys
from pathlib import Path

import pytest

from repro_torch.kernels.fifo_eval import build

FAKE_NVCC = f"""#!{sys.executable}
import sys
args = sys.argv[1:]
with open(args[args.index("-o") + 1], "w") as f:
    f.write("stand-in object")
with open({{log!r}}, "a") as f:
    f.write(" ".join(args) + "\\n")
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in ``nvcc`` that logs each call; the build state of the
    module is restored afterwards."""
    log = tmp_path / "nvcc.log"
    path = tmp_path / "nvcc"
    path.write_text(FAKE_NVCC.format(log=str(log)))
    path.chmod(path.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("NVCC", str(path))
    monkeypatch.setattr(build, "BUILD_INFO", {})
    return log


def test_default_build_dir_is_in_the_checkout(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    monkeypatch.delenv("REPRO_JIT_CACHE_DIR", raising=False)
    root = Path(build.__file__).resolve().parents[4]
    assert build.build_dir() == root / "build" / "repro_torch"


def test_jit_cache_dir_holds_the_build_and_a_restart_loads_it(
        tmp_path, monkeypatch, fake_nvcc):
    cache = tmp_path / "jit-cache"
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    monkeypatch.setenv("REPRO_JIT_CACHE_DIR", str(cache))
    assert build.build_dir() == cache
    lib = build.build()
    assert lib == cache / build.source_hash() / "libfifo_eval.so"
    assert lib.exists() and build.BUILD_INFO["built"] is True
    calls = fake_nvcc.read_text().splitlines()
    assert len(calls) == len(build.SOURCES) + 1      # compiles + link
    assert all("arch=compute_90a,code=sm_90a" in c for c in calls)
    # a restart: a fresh process state finds the library and builds nothing
    monkeypatch.setattr(build, "BUILD_INFO", {})
    assert build.build() == lib
    assert build.BUILD_INFO["built"] is False
    assert len(fake_nvcc.read_text().splitlines()) == len(calls)
    assert sorted(os.listdir(cache)) == [build.source_hash()]


def test_the_port_build_dir_wins_over_the_jit_cache(tmp_path, monkeypatch,
                                                    fake_nvcc):
    monkeypatch.setenv("REPRO_JIT_CACHE_DIR", str(tmp_path / "jit"))
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path / "port"))
    assert build.build_dir() == tmp_path / "port"
    assert build.build().parent.parent == tmp_path / "port"
    assert not (tmp_path / "jit").exists()
