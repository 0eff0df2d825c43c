"""Job kind ``dse``: one client runs advisory jobs back to back.

A job is what a user runs: a fresh ``FifoAdvisor(design,
EvalConfig(...))`` constructed (trace, event graph, condensation rungs,
baselines) and run to its budget, ending in ``torch.cuda.synchronize()``.

Traffic keys: ``design`` (a design of the configuration), ``eval`` (the
``EvalConfig`` fields), ``optimizer``, ``budget``, and ``check``:
``jobs`` (how many jobs' rows the oracle checks) and ``random`` (rows of
a checked job drawn uniformly, beside its frontier rows and baselines).
Every job's frontier and hypervolume are checked.
"""

from __future__ import annotations

import random
import time

from portbench import closedloop, probe


def setup(run):
    from repro_torch.core import EvalConfig, FifoAdvisor
    t = run.cell.traffic
    patches = probe.Patches()
    closedloop.install_probes(run, patches)
    state = {"patches": patches, "jobs": [], "FifoAdvisor": FifoAdvisor,
             "cfg": EvalConfig(**t["eval"]),
             "design": closedloop.build_design(run.cell.config,
                                               t["design"])}
    _job(run, state, -1, 0)                 # warm-up: every shape once
    state["jobs"].clear()
    run.counters.update(construct_s=[], batch_stats=[])
    return state


def _job(run, state, index: int, seed: int) -> None:
    import torch
    t = run.cell.traffic
    t0 = time.perf_counter()
    adv = state["FifoAdvisor"](state["design"], state["cfg"],
                               device=run.device)
    if run.device == "cuda":
        torch.cuda.synchronize()
    construct_s = time.perf_counter() - t0
    dse = adv.run(t["optimizer"], budget=int(t["budget"]), seed=seed)
    res = dse.result
    state["jobs"].append({
        "index": index, "seed": seed,
        "configs": res.configs, "lat": res.latency, "bram": res.bram,
        "dead": res.deadlock, "frontier": dse.frontier_points,
        "frontier_configs": dse.frontier_configs,
        "hv": dse.hypervolume(),
        "baselines": [(b.depths, b.latency, b.bram, b.deadlocked)
                      for b in (adv.baseline_max, adv.baseline_min)]})
    if index >= 0:
        run.counters["construct_s"].append(construct_s)
        run.counters["batch_stats"].append(adv.evaluator.stats)


def window(run, state) -> None:
    closedloop.window(run, lambda i, s: _job(run, state, i, s))


def close(run, state):
    state["patches"].undo()
    state.pop("FifoAdvisor")
    closedloop.close(run)
    return state


def judge(run, state, judge) -> None:
    from portbench.reference import judge as ref
    judge.missing(run.failed)           # jobs that raised gave no answer
    check = run.cell.traffic["check"]
    rng = random.Random(run.seed ^ closedloop.CHECK_SALT)
    jobs, d = state["jobs"], state["design"]
    picked = set(rng.sample(range(len(jobs)), min(check["jobs"],
                                                  len(jobs))))
    u = ref.baseline_max_depths(d)
    lat, bram, _ = ref.reference_rows(d, u[None, :])
    base = (float(lat[0]), float(bram[0]))
    for j, job in enumerate(jobs):
        judge.result(job["lat"], job["bram"], job["dead"], job["frontier"],
                     job["hv"], *base)
        if j not in picked:
            continue
        idx = closedloop.sample_rows(rng, job["configs"],
                                     job["frontier_configs"],
                                     check["random"])
        judge.rows(d, job["configs"][idx], job["lat"][idx],
                   job["bram"][idx], job["dead"][idx])
        for depths, lat, bram, dead in job["baselines"]:
            judge.rows(d, depths[None, :], [lat], [bram], [dead])
    run.log(f"checked rows of jobs {sorted(picked)} of {len(jobs)}")
