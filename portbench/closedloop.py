"""What the closed-loop job kinds share: building the frozen designs, the
probes of a traced run, the measured window and the row samples the check
takes.

One client runs one job after another; the window starts with the first
job and ends with the first job that ends ``--seconds`` or more after it
started, so ``job_s`` is the whole window over the jobs completed in it.
"""

from __future__ import annotations

import importlib
import random
import statistics
import time
from typing import Callable, Dict, List

import numpy as np

from portbench import probe, timing

#: salt of the check's own draws, so they never repeat the job seeds
CHECK_SALT = 0x5EED_C4EC


def build_design(config: dict, name: str, **args):
    """The frozen design ``name`` of a configuration, from its factory
    (``"<module>.<function>"`` under :mod:`portbench.inputs`) and the
    configuration's arguments, updated by ``args``."""
    entry = config["designs"][name]
    module, fn = entry["factory"].rsplit(".", 1)
    factory = getattr(importlib.import_module(f"portbench.inputs.{module}"),
                      fn)
    return factory(**{**entry.get("args", {}), **args})


def design_names(config: dict, spec) -> List[str]:
    """A traffic mix's designs: a list, or the name of a group of the
    configuration."""
    return list(config["groups"][spec]) if isinstance(spec, str) else \
        list(spec)


def install_probes(run, patches: probe.Patches) -> None:
    """In a traced run, the kernel log and the spans around each layer;
    an untraced run gets no probe."""
    if not run.trace:
        return
    run.kernels = probe.KernelLog()
    run.kernels.install(patches)
    run.spans = probe.Spans()
    advisor, simulate, dispatch, worklist, scheduler = (
        importlib.import_module(f"repro_torch.core.{m}") for m in (
            "advisor", "simulate", "backends.dispatch", "backends.worklist",
            "campaign.scheduler"))
    spans = run.spans
    spans.around(patches, advisor.FifoAdvisor, "__init__", "construct")
    spans.around(patches, advisor.FifoAdvisor, "min_safe_depths",
                 "certify")
    spans.around(patches, advisor.FifoAdvisor, "run", "optimizer")
    spans.around(patches, simulate.BatchedEvaluator, "evaluate",
                 "evaluate")
    spans.around(patches, worklist.WorklistBackend, "evaluate",
                 "escalation")
    spans.around(patches, scheduler.Campaign, "__init__", "construct")
    spans.around(patches, scheduler.Campaign, "_round", "campaign round")
    spans.around(patches, dispatch.HeteroDispatcher, "dispatch",
                 "hetero dispatch")


def window(run, job: Callable[[int, int], None]) -> None:
    """Run ``job(index, seed)`` in a closed loop for ``run.seconds``; sets
    ``job_s``, the attempted and failed counts and, in a traced run, the
    profile of the window."""
    import torch
    seeds = random.Random(run.seed)
    prof = None
    if run.trace:
        run.kernels.clear()
        run.spans.clear()
        prof = probe.start_profiler(run.device)
    w0 = time.time_ns()
    start = time.perf_counter()
    ends: List[float] = []
    times: List[float] = []
    while True:
        t0 = time.perf_counter()
        run.attempted += 1
        try:
            job(len(ends), seeds.randrange(2 ** 31))
        except Exception as exc:  # noqa: BLE001 -- counted, reported
            run.failed += 1
            run.log(f"job {run.attempted - 1} failed: "
                    f"{type(exc).__name__}: {exc}")
        if run.device == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        ends.append(t1)
        times.append(t1 - t0)
        if t1 - start >= run.seconds:
            break
    w1 = time.time_ns()
    if prof is not None:
        prof.stop()
        run.profile = probe.profile_summary(probe.device_events(prof), w0,
                                            w1, run.spans)
    run.e2e["job_s"] = timing.rate_over_window(start, ends)
    q = statistics.quantiles(times, n=4) if len(times) > 1 else times * 3
    run.log(f"jobs {len(times)} in {ends[-1] - start:.6f} s; job_s "
            f"{run.e2e['job_s']!r}; per job median "
            f"{statistics.median(times):.6f} s, quartiles {q[0]:.6f} "
            f"{q[2]:.6f}, max {max(times):.6f}; each "
            f"{' '.join(f'{x:.3f}' for x in times)}")


def close(run) -> None:
    """Read the device's name and memory peak, free the program's cached
    blocks (call once the program's objects are dropped)."""
    import torch
    if run.device == "cuda":
        run.device_kind = torch.cuda.get_device_name()
        run.memory_peak_bytes = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()


def sample_rows(rng: random.Random, configs: np.ndarray,
                frontier: np.ndarray, n_random: int) -> List[int]:
    """History indices to check: every frontier row and ``n_random``
    more, drawn uniformly from the other distinct rows, each row once."""
    first: Dict[bytes, int] = {}
    for i, r in enumerate(configs):
        first.setdefault(np.asarray(r, dtype=np.int64).tobytes(), i)
    chosen = {first[np.asarray(r, dtype=np.int64).tobytes()]
              for r in frontier}
    rest = sorted(set(first.values()) - chosen)
    chosen.update(rng.sample(rest, min(n_random, len(rest))))
    return sorted(chosen)
