"""Job kind ``ddcf_stream``: one client sizes FIFOs for one fresh stream
after another.

A job is what a user sizing a data-dependent engine for a new input
stream runs: the stream and its design built from the job's seed (the
frozen factory of the configuration, ``seed`` set), then a fresh
``FifoAdvisor(design, EvalConfig(...))`` (trace, event graph, rungs, the
pair and channel bounds, deadlock certification, baselines) run to its
budget, ending in ``torch.cuda.synchronize()``: the ``dse`` kind's job on
a design of its own.  Building the stream and the design is inside the
job's time.

Traffic keys as in the ``dse`` kind: ``design`` (a design of the
configuration whose factory takes ``seed``), ``eval``, ``optimizer``,
``budget``, and ``check``: ``jobs`` and ``random``; and ``warmup_seed``,
the seed of the warm-up job's stream, one of the largest, so that the
launch shapes of the longest rows the window meets are set up before
it.  Every job's frontier and hypervolume are checked against an oracle
Baseline-Max of its own stream, rebuilt by the check from the job's
seed.  For the checked jobs
the check also judges the certified vector (deadlock-free at the
certification's latency and BRAM) and, for each FIFO certified above 1,
the certification's claim that the vector with that FIFO one lower
deadlocks; a certificate that is unsafe or not minimal counts as wrong.
"""

from __future__ import annotations

import random

import numpy as np

from portbench import closedloop, probe
from portbench.jobs import dse
from portbench.jobs.dse import close  # noqa: F401  (the same teardown)


def setup(run):
    from repro_torch.core import EvalConfig, FifoAdvisor
    t = run.cell.traffic
    patches = probe.Patches()
    closedloop.install_probes(run, patches)

    def advisor(*args, **kwargs):   # kept for the job's certificate
        state["adv"] = FifoAdvisor(*args, **kwargs)
        return state["adv"]
    state = {"patches": patches, "jobs": [], "FifoAdvisor": advisor,
             "cfg": EvalConfig(**t["eval"])}
    _job(run, state, -1, int(t["warmup_seed"]))   # warm-up: every path
    state["jobs"].clear()
    run.counters.update(construct_s=[], batch_stats=[])
    return state


def design_of(run, seed: int):
    """The frozen design of the job seeded ``seed``."""
    return closedloop.build_design(run.cell.config,
                                   run.cell.traffic["design"], seed=seed)


def _job(run, state, index: int, seed: int) -> None:
    """Build the job's stream and design, run the ``dse`` kind's job on
    it, and add the certificate to its record."""
    state["design"] = design_of(run, seed)
    dse._job(run, state, index, seed)
    cert = state.pop("adv").certification
    state["jobs"][-1]["certified"] = (
        None if cert is None else (cert.depths.copy(), cert.latency,
                                   cert.bram))


def window(run, state) -> None:
    closedloop.window(run, lambda i, s: _job(run, state, i, s))


def judge(run, state, judge) -> None:
    from portbench.reference import judge as ref
    from portbench.reference.bram import design_bram_np
    judge.missing(run.failed)           # jobs that raised gave no answer
    check = run.cell.traffic["check"]
    rng = random.Random(run.seed ^ closedloop.CHECK_SALT)
    jobs = state["jobs"]
    picked = set(rng.sample(range(len(jobs)), min(check["jobs"],
                                                  len(jobs))))
    for j, job in enumerate(jobs):
        d = design_of(run, job["seed"])
        lat, bram, _ = ref.reference_rows(
            d, ref.baseline_max_depths(d)[None, :])
        judge.result(job["lat"], job["bram"], job["dead"], job["frontier"],
                     job["hv"], float(lat[0]), float(bram[0]))
        if j not in picked:
            continue
        idx = closedloop.sample_rows(rng, job["configs"],
                                     job["frontier_configs"],
                                     check["random"])
        judge.rows(d, job["configs"][idx], job["lat"][idx],
                   job["bram"][idx], job["dead"][idx])
        for depths, lat, bram, dead in job["baselines"]:
            judge.rows(d, depths[None, :], [lat], [bram], [dead])
        if job["certified"] is None:
            judge.missing(1)            # the certificate never came
            continue
        depths, lat, bram = job["certified"]
        judge.rows(d, depths[None, :], [lat], [bram], [False])
        # minimality: each FIFO certified above 1 deadlocks one lower
        # (the claim is of deadlock alone, so its BRAM is the reference's)
        lower = np.repeat(depths[None, :], int(np.sum(depths > 1)), axis=0)
        for r, f in enumerate(np.flatnonzero(depths > 1)):
            lower[r, f] -= 1
        if lower.shape[0]:
            widths = np.asarray(d.widths(), dtype=np.int64)
            judge.rows(d, lower, [-1] * lower.shape[0],
                       design_bram_np(lower, widths),
                       [True] * lower.shape[0])
    run.log(f"checked rows of jobs {sorted(picked)} of {len(jobs)}")
