"""Job kind ``campaign``: one client runs campaigns back to back.

A job is ``Campaign(CampaignSpec(designs, optimizers, budget, seed,
hetero, eval=EvalConfig(...))).run()``: every design's advisor built by
name (trace, event graph, baselines), then every (design, optimizer)
task stepped round-robin, each round's full-solve rows packed across
designs into one cross-design dispatch.  No checkpoint path is given, so
a job writes nothing.

Traffic keys: ``designs`` (a list, or a group of the configuration),
``optimizers``, ``budget``, ``hetero``, ``eval`` (the ``EvalConfig``
fields), and ``check``: ``jobs`` (campaigns whose rows the oracle
checks), ``tasks`` (tasks of a checked campaign) and ``random`` (rows of
a checked task, as in the ``dse`` kind).  Every task's frontier and
hypervolume are checked.
"""

from __future__ import annotations

import random
import time

from portbench import closedloop, probe


def setup(run):
    from repro_torch.core import EvalConfig
    from repro_torch.core.campaign import Campaign, CampaignSpec
    t = run.cell.traffic
    names = closedloop.design_names(run.cell.config, t["designs"])
    patches = probe.Patches()
    closedloop.install_probes(run, patches)
    state = {"patches": patches, "jobs": [], "names": names,
             "Campaign": Campaign, "CampaignSpec": CampaignSpec,
             "cfg": EvalConfig(**t["eval"]),
             "designs": {n: closedloop.build_design(run.cell.config, n)
                         for n in names}}
    _job(run, state, -1, 0)                  # warm-up: every shape once
    state["jobs"].clear()
    run.counters.update(construct_s=[], hetero_stats=[])
    return state


def _job(run, state, index: int, seed: int) -> None:
    import torch
    t = run.cell.traffic
    spec = state["CampaignSpec"](
        designs=tuple(state["names"]), optimizers=tuple(t["optimizers"]),
        budget=int(t["budget"]), seed=seed, hetero=bool(t["hetero"]),
        eval=state["cfg"])
    t0 = time.perf_counter()
    camp = state["Campaign"](spec, device=run.device)
    if run.device == "cuda":
        torch.cuda.synchronize()
    construct_s = time.perf_counter() - t0
    store = camp.run()
    tasks = []
    for key in store.keys():
        dse = store[key]
        res = dse.result
        tasks.append({
            "key": key, "design": dse.design_name, "configs": res.configs,
            "lat": res.latency, "bram": res.bram, "dead": res.deadlock,
            "frontier": dse.frontier_points,
            "frontier_configs": dse.frontier_configs,
            "hv": dse.hypervolume(),
            "baselines": [(b.depths, b.latency, b.bram, b.deadlocked)
                          for b in (dse.baseline_max, dse.baseline_min)]})
    state["jobs"].append({"index": index, "seed": seed, "tasks": tasks})
    if index >= 0:
        run.counters["construct_s"].append(construct_s)
        if camp.hetero is not None:
            run.counters["hetero_stats"].append(camp.hetero.stats)


def window(run, state) -> None:
    closedloop.window(run, lambda i, s: _job(run, state, i, s))


def close(run, state):
    state["patches"].undo()
    for k in ("Campaign", "CampaignSpec"):
        state.pop(k)
    closedloop.close(run)
    return state


def judge(run, state, judge) -> None:
    from portbench.reference import judge as ref
    judge.missing(run.failed)           # jobs that raised gave no answer
    check = run.cell.traffic["check"]
    rng = random.Random(run.seed ^ closedloop.CHECK_SALT)
    designs = state["designs"]
    base = {}
    for n, d in designs.items():
        lat, bram, _ = ref.reference_rows(
            d, ref.baseline_max_depths(d)[None, :])
        base[n] = (float(lat[0]), float(bram[0]))
    jobs = state["jobs"]
    picked = set(rng.sample(range(len(jobs)), min(check["jobs"],
                                                  len(jobs))))
    for j, job in enumerate(jobs):
        for task in job["tasks"]:
            judge.result(task["lat"], task["bram"], task["dead"],
                         task["frontier"], task["hv"], *base[task["design"]])
        if j not in picked:
            continue
        for ti in sorted(rng.sample(range(len(job["tasks"])),
                                    min(check["tasks"], len(job["tasks"])))):
            task = job["tasks"][ti]
            d = designs[task["design"]]
            idx = closedloop.sample_rows(rng, task["configs"],
                                         task["frontier_configs"],
                                         check["random"])
            judge.rows(d, task["configs"][idx], task["lat"][idx],
                       task["bram"][idx], task["dead"][idx])
            for depths, lat, bram, dead in task["baselines"]:
                judge.rows(d, depths[None, :], [lat], [bram], [dead])
    run.log(f"checked rows of campaigns {sorted(picked)} of {len(jobs)}")
