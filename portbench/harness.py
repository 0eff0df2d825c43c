"""One run of one benchmark cell: set-up, the measured window, the check.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs the cell named in ``BENCHMARK.json``.  Everything
that belongs to one configuration, traffic mix, job kind or per-layer
metric is found by its name:

* ``portbench/configs/<config>.json``: the configuration (the file the
  ``configs`` entry names);
* ``portbench/workloads/<traffic>.json``: the traffic mix, whose
  ``kind`` names the job kind and whose ``limits`` hold the check's
  limits;
* ``portbench/jobs/<kind>.py``: the job kind (``setup``, ``window``,
  ``judge``);
* ``portbench/metrics/<metric>.py``: a per-layer metric's reader
  (``read(run)``, None when it finds nothing to read).

The last line of standard output is the result, one JSON object; the
numbers the check compared, each beside its limit, are the last lines of
standard error and the last key of the result.  Without a CUDA device,
or with fewer than the cell asks for, the run exits 2 and prints no
result; if ``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` is
loaded once the window has closed, it exits 3 and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "portbench"
#: top-level module names no run may load (``repro`` is the JAX package;
#: the port ``repro_torch`` only begins with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: where the program's kernels are built once and loaded by every later
#: run of this checkout (git-ignored)
BUILD_DIR = ROOT / "build" / "portbench" / "kernels"


#: host threads of each math library: one client is one thread, so that
#: idle worker threads spinning on the shared host do not move the timings
HOST_THREADS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")


def environment() -> Dict[str, str]:
    """The variables every process of a run gets, set before numpy or
    torch is imported: the kernels' build directory inside the checkout,
    one host thread a math library, and no JAX behind any library."""
    return {"REPRO_TORCH_BUILD_DIR": str(BUILD_DIR), "USE_FLAX": "0",
            "USE_JAX": "0", **dict.fromkeys(HOST_THREADS, "1")}


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is in :data:`FORBIDDEN`,
    compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names if m.split(".")[0] in FORBIDDEN})


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """Import a file by path (metric files have dots in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    return read_json(ROOT / "BENCHMARK.json")


def find_cell(name: str, bench: Optional[dict] = None) -> SimpleNamespace:
    """The cell ``name`` with its configuration, traffic mix, job kind and
    metrics, each found by name."""
    bench = bench or benchmark()
    w = {c["name"]: c for c in bench["workloads"]}.get(name)
    if w is None:
        # a <config>.<traffic> pair whose files exist but that no entry
        # lists yet: measurable (sweep.py, readings.py) before it is added
        config, _, traffic = name.partition(".")
        w = {"name": name, "config": config, "traffic": traffic, "chips": 1}
    files = {c["name"]: c["file"] for c in bench["configs"]}
    config = read_json(ROOT / files.get(
        w["config"], f"portbench/configs/{w['config']}.json"))
    traffic = read_json(BENCH / "workloads" / f"{w['traffic']}.json")

    def reported(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]
    return SimpleNamespace(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        kind=load_module(BENCH / "jobs" / f"{traffic['kind']}.py",
                         f"portbench_job_{traffic['kind']}"),
        end_to_end=reported(bench["end_to_end"]),
        per_layer=reported(bench["per_layer"]))


def metric_reader(name: str) -> ModuleType:
    return load_module(BENCH / "metrics" / f"{name}.py",
                       "portbench_metric_" + name.replace(".", "_"))


class Run:
    """What one run knows: its cell, seed and window, and what the job
    kind and the probes recorded.  Job kinds and metric readers take it.

    ``counters`` holds what the job kind read from the program (its
    ``BatchStats``, ``HeteroStats``, the benchmark's own construct
    spans); ``kernels`` the
    :class:`~portbench.probe.KernelLog`, ``spans`` the
    :class:`~portbench.probe.Spans` and ``profile`` the
    :func:`~portbench.probe.profile_summary` of a traced run.
    """

    def __init__(self, cell, seed: int, seconds: float, trace: bool,
                 device: str = "cuda"):
        self.cell = cell
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.counters: Dict[str, object] = {}
        self.kernels = None
        self.spans = None
        self.profile: Optional[dict] = None
        self.e2e: Dict[str, float] = {}
        self.attempted = 0
        self.failed = 0
        self.memory_peak_bytes = 0
        self.device_kind = None
        self.tmp = Path(tempfile.gettempdir())

    def log(self, msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)


def measure(cell, seed: int, seconds: float, trace: bool,
            device: str = "cuda", t_start: Optional[float] = None):
    """Set-up and the measured window; returns ``(run, state)`` with the
    program's objects dropped and its answers kept for the check."""
    t_start = time.perf_counter() if t_start is None else t_start
    run = Run(cell, seed, seconds, trace, device)
    state = cell.kind.setup(run)
    # what set-up built lives to the end: the collector need not walk it
    # again during the window
    gc.collect()
    gc.freeze()
    run.e2e["setup_s"] = time.perf_counter() - t_start
    run.log(f"setup_s {run.e2e['setup_s']!r}")
    try:
        cell.kind.window(run, state)
    finally:
        gc.unfreeze()
    state = cell.kind.close(run, state)
    gc.collect()
    return run, state


def check(run, state, control: bool = False):
    """The reference's :class:`~portbench.reference.judge.Judge` over what
    the run produced (with ``control``, the control in the program's
    place)."""
    from portbench.reference.judge import Judge
    judge = Judge(control=control)
    t0 = time.perf_counter()
    run.cell.kind.judge(run, state, judge)
    run.log(f"check{' (control)' if control else ''}: {judge.n_rows} rows, "
            f"{judge.n_results} results, "
            f"{time.perf_counter() - t0:.3f} s; found {judge.values}")
    return judge


def result(run, judge) -> dict:
    """The result object (the JSON line), with ``checks`` last."""
    cell = run.cell
    limits = cell.traffic["limits"]
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in judge.numbers().items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    if run.trace:
        metrics = {}
        for m in cell.per_layer:
            v = metric_reader(m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        missing = [m["name"] for m in cell.per_layer
                   if m["name"] not in metrics]
        if missing:
            run.log(f"per-layer metrics with nothing to read: {missing}")
    else:
        metrics = {m["name"]: {"value": run.e2e[m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if run.device == "cuda" else run.device,
           "kind": run.device_kind, "count": cell.chips,
           "memory_peak_bytes": int(run.memory_peak_bytes)}
    out = {"correct": correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": dev}
    if run.trace and run.profile is not None:
        dev["busy_s"] = run.profile["busy_s"]
        dev["window_s"] = run.profile["window_s"]
        out["breakdown"] = {"device_ops": run.profile["device_ops"],
                            "idle_gaps": run.profile["idle_gaps"]}
    out["checks"] = checks
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: Optional[float] = None) -> dict:
    """Set up, measure and check one run; returns the result object."""
    run, state = measure(cell, seed, seconds, trace, device, t_start)
    return result(run, check(run, state))


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python3 portbench/run.py",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="cell name")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t_start: Optional[float] = None) -> int:
    args = parse_args(argv)
    os.environ.update(environment())
    cell = find_cell(args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"portbench: cell {cell.name} needs {cell.chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"portbench: torch host threads {torch.get_num_threads()}",
          file=sys.stderr)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                   t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
