"""Build and load the fifo_eval CUDA kernels (``csrc/*.cu``).

The kernels are compiled at first use, from this package's sources only,
with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3`` into one shared
library with a plain C interface, and loaded with :mod:`ctypes`.  The build
directory (``build/repro_torch/<source hash>/`` at the root of the
checkout, or ``$REPRO_TORCH_BUILD_DIR``) is keyed on a hash of the sources
and flags, so an edit to any source rebuilds and an unchanged tree loads
the library it built before.  A failed build raises; nothing falls back.

This is also the port's compile cache, the counterpart of the reference's
``repro/core/backends/jaxcfg.py`` (which points jax's persistent
compilation cache at ``$REPRO_JIT_CACHE_DIR``): the kernels compile
nothing per shape, so one build per source hash is all there is to keep.
When ``REPRO_JIT_CACHE_DIR`` is set and ``REPRO_TORCH_BUILD_DIR`` is not,
the build goes there, so a restarted server or campaign that shares the
reference's cache variable loads the library instead of rebuilding it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parents[2] / "csrc"
SOURCES = ("fifo_eval.cu", "condensed.cu", "launch_ops.cu")
HEADERS = ("fifo_step.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: argtypes of the C entry points (pointers and the stream as c_void_p)
SIGNATURES = {
    "fifo_eval_launch": [_P] * 14 + [_I, _I, _I, _F, _I, _I, _I, _P],
    "fifo_eval_active_clusters": [_I, _I, _I],
    "fifo_eval_condensed_launch": [_P] * 16 + [_I, _I, _I, _I, _F]
                                  + [_I] * 3 + [_P],
    "fifo_eval_condensed_active": [_I] * 5,
    "depth_operands_launch": [_P] * 15 + [_I] * 4 + [_P],
    "eval_epilogue_launch": [_P] * 5 + [_I] * 3 + [_F, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: what the last build did: {"seconds", "path", "built", "ptxas"}; seconds
#: and ptxas are None when the library was already built
BUILD_INFO: dict = {}


#: the reference's persistent-compilation-cache variable
JIT_CACHE_ENV = "REPRO_JIT_CACHE_DIR"


def build_dir() -> Path:
    """``$REPRO_TORCH_BUILD_DIR``, else ``$REPRO_JIT_CACHE_DIR``, else
    ``build/repro_torch`` at the root of the checkout."""
    for var in ("REPRO_TORCH_BUILD_DIR", JIT_CACHE_ENV):
        env = os.environ.get(var)
        if env:
            return Path(env).expanduser()
    return Path(__file__).resolve().parents[4] / "build" / "repro_torch"


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the fifo_eval CUDA kernels cannot "
                       "be built (set NVCC or put nvcc on PATH)")


def _run(cmd: List[str]) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build(verbose_ptxas: bool = False) -> Path:
    """Compile the sources (one ``nvcc`` per source, all at once), link
    them into one shared library, and return its path."""
    out_dir = build_dir() / source_hash()
    lib = out_dir / "libfifo_eval.so"
    if lib.exists():
        if not BUILD_INFO:                # built by an earlier process
            BUILD_INFO.update(seconds=None, path=str(lib), built=False,
                              ptxas=None)
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        extra = ["-Xptxas", "-v"] if verbose_ptxas else []
        objs, procs = [], []
        for name in SOURCES:
            obj = os.path.join(tmp, name + ".o")
            objs.append(obj)
            procs.append(_run([nvcc, *NVCC_FLAGS, *extra, "-c",
                               str(CSRC / name), "-o", obj]))
        logs = [p.communicate()[0] for p in procs]
        for name, p, log in zip(SOURCES, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        tmp_lib = os.path.join(tmp, "libfifo_eval.so")
        link = _run([nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", tmp_lib])
        log = link.communicate()[0]
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{log}")
        os.replace(tmp_lib, lib)          # atomic: concurrent builders
    BUILD_INFO.update(seconds=time.perf_counter() - t0, path=str(lib),
                      built=True, ptxas="\n".join(logs))
    return lib


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for fn, argtypes in SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
