"""Differential design-space fuzzing CLI.

Runs continuous differential campaigns over randomly generated designs
(:mod:`repro_torch.designs.generate`): for every seed, the design is evaluated
at a spread of depth configurations by the discrete-event **oracle** and
by every requested trace-based :class:`EvalBackend`, and the results must
agree on

* **latency** (exact, cycle for cycle, on deadlock-free rows),
* **deadlock verdicts** (including per-FIFO blame being well-formed), and
* **functional outputs** vs the design's numpy reference (tracer and
  oracle both execute the real values).

The backends are this package's (``worklist``, ``fixpoint``, ``cuda``,
and the pseudo-backends ``condensed`` and ``cuda-condensed``, which force
the rung cascade); the tensor backends run on ``--device`` (default
``cuda``; ``cpu`` runs the kernels' plain versions).  Holding these
verdicts against the reference package's fuzzer on the same seeds is a
test of the repository, not a mode of this CLI: this package imports
nothing of the reference.

On a disagreement the failing spec is *shrunk* to a minimal reproducing
design (structural reductions, see
:func:`repro_torch.designs.generate.shrink_spec`) and serialized into the
seed corpus, which CI replays first as regression tests on every
subsequent run.

``--mode bounds`` swaps the differential property: instead of backend
agreement, every design must satisfy the analytical channel-bounds
contract (:mod:`repro_torch.core.bounds`) —

* ``analytical lower <= certified <= analytical upper`` on every FIFO,
* bounds-seeded certification returns the identical vector, and
* on affine-only specs the bounds are *exact* (``analytical ==
  certified``) and seeded certification is probe-free (the shortcut
  probe plus the start check, nothing else).

``--mode chaos`` swaps it again: every design is evaluated through a
2-lane :class:`~repro_torch.core.campaign.pool.WorkerPool` running a seeded
:class:`~repro_torch.core.faults.FaultPlan` that kills every lane mid-round
(crash or hang, seed-chosen), and the pooled results must be
bit-identical to the fault-free inline reference, with every scheduled
fault fired, exactly one respawn per lane death, and no worker process
outliving the pool.  Needs the ``fork`` start method (generated designs
ride to workers via copy-on-write); exits 2 otherwise so CI cannot
green-light a no-op chaos run.

  PYTHONPATH=src python -m repro_torch.launch.fuzz --seeds 0:200 --quick
  PYTHONPATH=src python -m repro_torch.launch.fuzz --seeds 0:200 --quick \\
      --mode bounds --corpus tests/fuzz_corpus
  PYTHONPATH=src python -m repro_torch.launch.fuzz --seeds 0:50 \\
      --backends worklist,fixpoint,cuda --device cpu --configs 6 \\
      --corpus tests/fuzz_corpus

Exit code 0 = zero disagreements (corpus replays included); an empty or
malformed ``--seeds`` range exits 2 so CI cannot green-light a no-op run.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import glob
import json
import os
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.config import EvalConfig
from repro_torch.core.oracle import simulate
from repro_torch.core.simgraph import build_simgraph
from repro_torch.core.simulate import BatchedEvaluator
from repro_torch.core.tracer import collect_trace
from repro_torch.designs.generate import (DesignSpec, GeneratedDesign,
                                    build_design, corpus_entry,
                                    load_corpus_specs, shrink_spec,
                                    spec_from_seed)

__all__ = ["Mismatch", "bounds_check", "bounds_one", "chaos_check",
           "chaos_one", "depth_configs", "differential_check", "fuzz_one",
           "main", "parse_args", "parse_seed_range", "resolve_backends"]


@dataclasses.dataclass
class Mismatch:
    """One observed disagreement, with everything needed to reproduce."""

    spec: DesignSpec
    kind: str            # "latency" | "deadlock" | "functional" | "blame"
    backend: str         # backend name ("oracle"/"trace" for functional)
    depths: Optional[List[int]]
    detail: str

    def to_json(self) -> Dict[str, object]:
        return {"kind": self.kind, "backend": self.backend,
                "depths": self.depths, "detail": self.detail}


def depth_configs(g, rng: np.random.Generator, n_random: int = 4
                  ) -> np.ndarray:
    """The depth matrix a design is differentially tested at: the two
    corner cases (all-1 — maximal back-pressure, most deadlocks — and the
    upper-bound vector) plus ``n_random`` uniform draws in between."""
    u = np.maximum(g.upper_bounds, 1)
    rows = [np.ones_like(u), np.minimum(u, 2), u]
    for _ in range(n_random):
        rows.append(rng.integers(1, u + 1))
    return np.unique(np.stack(rows), axis=0)


def differential_check(gen: GeneratedDesign,
                       backends: Sequence[str] = ("worklist",),
                       n_random: int = 4,
                       rng: Optional[np.random.Generator] = None,
                       device=None) -> Tuple[List[Mismatch], int]:
    """Differentially test one generated design.

    Returns ``(mismatches, n_rows_checked)``.  The oracle is ground
    truth; every backend's (latency, deadlock) must match it row for
    row, the tracer's and oracle's functional outputs must match the
    numpy reference, and deadlocked rows must yield a non-empty,
    well-formed blame set.  ``device`` is the torch device of the tensor
    backends (None = CUDA).
    """
    from repro_torch.core.deadlock import extract_wait_graph

    design = gen.design
    mism: List[Mismatch] = []
    spec = gen.spec
    rng = rng or np.random.default_rng(spec.seed)

    trace = collect_trace(design)
    if not gen.check_results(trace.results):
        mism.append(Mismatch(spec, "functional", "trace", None,
                             f"trace results {trace.results} != "
                             f"reference {gen.expected}"))
    g = build_simgraph(design, trace)
    matrix = depth_configs(g, rng, n_random=n_random)

    oracle_lat = np.zeros(matrix.shape[0], dtype=np.int64)
    oracle_dead = np.zeros(matrix.shape[0], dtype=bool)
    fifo_names = {f.name for f in design.fifos}
    for i in range(matrix.shape[0]):
        r = simulate(design, matrix[i])
        oracle_lat[i] = r.latency
        oracle_dead[i] = r.deadlocked
        if r.deadlocked:
            blame = extract_wait_graph(design, r, trace=trace).blame()
            if not blame or not set(blame) <= fifo_names:
                mism.append(Mismatch(
                    spec, "blame", "oracle", matrix[i].tolist(),
                    f"deadlocked row produced ill-formed blame {blame}"))
        elif not gen.check_results(r.results):
            mism.append(Mismatch(
                spec, "functional", "oracle", matrix[i].tolist(),
                f"oracle results {r.results} != reference {gen.expected}"))

    for name in backends:
        if name == "condensed":
            # the numpy worklist forced through the condensation cascade:
            # every accepted row carries a per-row exactness certificate,
            # so this differentially pins condensed-vs-oracle identity
            # without a tensor backend
            from repro_torch.core.condense import condense_auto
            rungs = condense_auto(g)
            if not rungs:
                # nothing compressed -> the cascade would be an exact
                # duplicate of the plain worklist run; skip rather than
                # double-count the seed as condensation coverage
                continue
            ev = BatchedEvaluator(
                g, EvalConfig(backend="worklist", max_iters=64),
                rungs=rungs)
        elif name == "cuda-condensed":
            # the kernel backend driven through the rung cascade: K1's
            # on-device certificate decides row acceptance on the fused
            # rungs (this pins the whole cascade to the oracle)
            from repro_torch.core.condense import condense_auto
            rungs = condense_auto(g)
            if not rungs:
                continue
            ev = BatchedEvaluator(
                g, EvalConfig(backend="cuda", max_iters=64),
                rungs=rungs, device=device)
        else:
            ev = BatchedEvaluator(
                g, EvalConfig(backend=name, max_iters=64), device=device)
        lat, _, dead = ev.evaluate(matrix)
        for i in range(matrix.shape[0]):
            if bool(dead[i]) != bool(oracle_dead[i]):
                mism.append(Mismatch(
                    spec, "deadlock", name, matrix[i].tolist(),
                    f"backend says deadlock={bool(dead[i])}, oracle says "
                    f"{bool(oracle_dead[i])}"))
            elif not dead[i] and int(lat[i]) != int(oracle_lat[i]):
                mism.append(Mismatch(
                    spec, "latency", name, matrix[i].tolist(),
                    f"backend latency {int(lat[i])} != oracle "
                    f"{int(oracle_lat[i])}"))
    return mism, int(matrix.shape[0])


def fuzz_one(spec: DesignSpec, backends: Sequence[str],
             n_random: int = 4, device=None) -> Tuple[List[Mismatch], int]:
    """Build + differentially check one spec (corpus replay entry point)."""
    gen = build_design(spec)
    return differential_check(gen, backends=backends, n_random=n_random,
                              device=device)


def bounds_check(gen: GeneratedDesign) -> Tuple[List[Mismatch], int]:
    """The ``bounds`` differential property for one generated design.

    Certifies minimal safe depths twice — unseeded and seeded with the
    analytical :func:`~repro_torch.core.bounds.channel_bounds` — and checks:
    bracket (``lower <= certified <= upper`` per FIFO), seeded/unseeded
    vector identity, and on affine-only specs exactness (``certified ==
    lower``) plus probe-freedom (seeded certification issues at most 2
    evaluator probes: the start check and the shortcut).

    Returns ``(mismatches, n_channels_checked)``.
    """
    from repro_torch.core.backends import ConfigCache
    from repro_torch.core.bounds import channel_bounds
    from repro_torch.core.deadlock import certify_min_depths

    spec = gen.spec
    mism: List[Mismatch] = []
    g = build_simgraph(gen.design)
    b = channel_bounds(g)
    ev = BatchedEvaluator(g, EvalConfig(backend="worklist", max_iters=64))
    cert = certify_min_depths(g, ev, cache=ConfigCache(g.n_fifos))
    seeded = certify_min_depths(g, ev, cache=ConfigCache(g.n_fifos),
                                bounds=b)

    names = [f.name for f in gen.design.fifos]
    if not np.array_equal(cert.depths, seeded.depths):
        mism.append(Mismatch(
            spec, "bounds-identity", "bounds", seeded.depths.tolist(),
            f"seeded certification {seeded.depths.tolist()} != unseeded "
            f"{cert.depths.tolist()}"))
    viol = (b.lower > cert.depths) | (cert.depths > b.upper)
    if viol.any():
        f = int(np.flatnonzero(viol)[0])
        mism.append(Mismatch(
            spec, "bounds-bracket", "bounds", cert.depths.tolist(),
            f"fifo {names[f]!r} ({b.kinds[f]}): certified "
            f"{int(cert.depths[f])} outside analytical "
            f"[{int(b.lower[f])}, {int(b.upper[f])}]"))
    if spec.affine_only:
        if not np.array_equal(cert.depths, b.lower):
            f = int(np.flatnonzero(cert.depths != b.lower)[0])
            mism.append(Mismatch(
                spec, "bounds-exact", "bounds", cert.depths.tolist(),
                f"affine-only spec but fifo {names[f]!r} ({b.kinds[f]}) "
                f"certified {int(cert.depths[f])} != analytical lower "
                f"{int(b.lower[f])}"))
        if seeded.n_probes > 2:
            mism.append(Mismatch(
                spec, "bounds-probes", "bounds", seeded.depths.tolist(),
                f"affine-only spec needed {seeded.n_probes} evaluator "
                f"probes (expected <= 2: start check + shortcut)"))
    return mism, g.n_fifos


def bounds_one(spec: DesignSpec, backends: Sequence[str] = (),
               n_random: int = 0) -> Tuple[List[Mismatch], int]:
    """``fuzz_one``-shaped wrapper so ``--mode bounds`` reuses the
    corpus-replay / shrink plumbing (``backends``/``n_random`` unused)."""
    return bounds_check(build_design(spec))


def chaos_check(gen: GeneratedDesign, n_random: int = 2,
                rng: Optional[np.random.Generator] = None
                ) -> Tuple[List[Mismatch], int]:
    """The ``chaos`` differential property for one generated design.

    Evaluates the design's depth matrix twice — inline (the fault-free
    reference) and through a
    :class:`~repro_torch.core.campaign.pool.WorkerPool` running a seeded
    :class:`~repro_torch.core.faults.FaultPlan` with an aggressive recv
    deadline — and checks three things:

    * **identity**: pooled ``(latency, bram, deadlock)`` bit-identical
      to the inline reference despite every lane dying mid-round,
    * **coverage**: every scheduled fault fired (worker faults are
      pinned to each lane's *first* job so the schedule is reachable by
      construction — an unfired fault means the injection plumbing
      broke, not that the dice fell badly),
    * **recovery**: exactly one respawn per lane death, and no worker
      process outlives ``pool.close()``.

    Returns ``(mismatches, n_rows_checked)``.  Requires the ``fork``
    start method (the caller gates on it): generated designs have no
    ``make_design`` name, so they can only reach workers through fork's
    copy-on-write pages.
    """
    import multiprocessing as mp

    from repro_torch.core.campaign.pool import WorkerPool
    from repro_torch.core.faults import Fault, FaultPlan

    spec = gen.spec
    mism: List[Mismatch] = []
    design = gen.design
    trace = collect_trace(design)
    g = build_simgraph(design, trace)
    rng = rng or np.random.default_rng(spec.seed)
    matrix = depth_configs(g, rng, n_random=n_random)

    ref = BatchedEvaluator(g, EvalConfig(backend="numpy", max_iters=64))
    want_lat, want_bram, want_dead = ref.evaluate(matrix)

    # round-robin the rows over up to 4 jobs / 2 lanes; degenerate
    # designs whose depth matrix collapses to one row get one lane
    n_jobs = min(4, matrix.shape[0])
    n_lanes = min(2, n_jobs)
    name = f"chaos_seed{spec.seed}"
    chunks = [c for c in np.array_split(matrix, n_jobs, axis=0)
              if c.shape[0]]
    jobs = [(j % n_lanes, name, chunk, None)
            for j, chunk in enumerate(chunks)]

    # one lethal fault per lane at that lane's first job (guaranteed to
    # fire: every lane receives at least one job), plus a dispatch delay
    # on a seed-chosen job index (wildcard lane, so always reachable)
    lethal = ("crash_worker", "hang_worker")
    faults = [Fault(lethal[int(rng.integers(2))], at=0, lane=w, value=1.0)
              for w in range(n_lanes)]
    faults.append(Fault("delay_dispatch",
                        at=int(rng.integers(len(jobs))), value=0.005))
    plan = FaultPlan(faults)

    pool = WorkerPool(n_lanes, max_iters=64, graphs={name: g},
                      faults=plan, recv_timeout_s=0.3)
    try:
        results = pool.run_jobs(jobs)
    finally:
        pool.close()

    got_lat = np.concatenate([r[0] for r in results])
    got_bram = np.concatenate([r[1] for r in results])
    got_dead = np.concatenate([r[2] for r in results])
    if not (np.array_equal(got_lat, want_lat)
            and np.array_equal(got_bram, want_bram)
            and np.array_equal(got_dead, want_dead)):
        bad = np.flatnonzero((got_lat != want_lat)
                             | (got_dead != want_dead))
        i = int(bad[0]) if bad.size else 0
        mism.append(Mismatch(
            spec, "chaos-identity", "pool", matrix[i].tolist(),
            f"pooled row {i} (lat={int(got_lat[i])}, "
            f"dead={bool(got_dead[i])}) != inline reference "
            f"(lat={int(want_lat[i])}, dead={bool(want_dead[i])}) "
            f"under plan {plan.to_json()}"))
    if not plan.all_fired:
        unfired = [f.to_dict() for i, f in enumerate(plan.faults)
                   if not plan._fired[i]]
        mism.append(Mismatch(
            spec, "chaos-coverage", "pool", None,
            f"{len(unfired)} scheduled fault(s) never fired: {unfired}"))
    if pool.stats["respawns"] != n_lanes:
        mism.append(Mismatch(
            spec, "chaos-recovery", "pool", None,
            f"expected {n_lanes} respawns (one per lane death), pool "
            f"reports {pool.stats}"))
    strays = mp.active_children()
    if strays:  # pragma: no cover - the defect this mode exists to catch
        for p in strays:
            p.kill()
        mism.append(Mismatch(
            spec, "chaos-zombies", "pool", None,
            f"{len(strays)} worker process(es) outlived pool.close()"))
    return mism, int(matrix.shape[0])


def chaos_one(spec: DesignSpec, backends: Sequence[str] = (),
              n_random: int = 2) -> Tuple[List[Mismatch], int]:
    """``fuzz_one``-shaped wrapper so ``--mode chaos`` reuses the
    corpus-replay / shrink plumbing (``backends`` unused)."""
    return chaos_check(build_design(spec), n_random=n_random)


def _shrunk(spec: DesignSpec, backends: Sequence[str], n_random: int,
            kind: str, backend: str, check=None) -> DesignSpec:
    """Shrink ``spec`` while the ORIGINAL failure mode still reproduces.

    A reduction that merely fails differently (another kind, another
    backend) is rejected — the corpus entry must guard the disagreement
    that was actually observed, not whatever the smaller design happens
    to trip over.  ``check`` defaults to the module-level ``fuzz_one``,
    resolved at call time so tests can monkeypatch it.
    """
    def still_fails(cand: DesignSpec) -> bool:
        found, _ = (check or fuzz_one)(cand, backends, n_random=n_random)
        return any(m.kind == kind and m.backend == backend for m in found)
    return shrink_spec(spec, still_fails)


def resolve_backends(arg: str) -> List[str]:
    """``auto`` -> every backend of this package, plus the two cascade
    pseudo-backends (``condensed`` = numpy worklist through the rung
    cascade; ``cuda-condensed`` = the kernel backend's on-device
    certificate through the same cascade); else a comma-list."""
    if arg == "auto":
        from repro_torch.core.backends import available_backends
        return list(available_backends()) + ["condensed", "cuda-condensed"]
    return [b.strip() for b in arg.split(",") if b.strip()]


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.fuzz",
        description="Differential fuzzing: generated designs, oracle vs "
                    "every evaluation backend.")
    p.add_argument("--seeds", default="0:50", metavar="LO:HI",
                   help="seed range (half-open, non-empty), e.g. 0:200")
    p.add_argument("--mode", choices=("diff", "bounds", "chaos"),
                   default="diff",
                   help="diff: oracle vs backends (default); bounds: "
                        "analytical channel-bounds contract (bracket, "
                        "seeded-certification identity, affine exactness); "
                        "chaos: worker-pool evaluation under injected "
                        "lane crashes/hangs must stay bit-identical to "
                        "the fault-free inline reference")
    p.add_argument("--quick", action="store_true",
                   help="small designs + the CI-bounded default backend "
                        "set (worklist, condensed, and cuda when a CUDA "
                        "device is present)")
    p.add_argument("--backends", default=None,
                   help="comma-list of backend names (pseudo-backends "
                        "'condensed' and 'cuda-condensed' run the rung "
                        "cascade), or 'auto' for everything available")
    p.add_argument("--device", default="cuda",
                   help="torch device of the tensor backends (cuda, or "
                        "cpu for the kernels' plain versions)")
    p.add_argument("--configs", type=int, default=4, metavar="N",
                   help="random depth configs per design (plus the three "
                        "corner configs)")
    p.add_argument("--corpus", default=None, metavar="DIR",
                   help="seed-corpus directory: replayed first, and "
                        "minimal shrunk specs for new mismatches are "
                        "written here")
    p.add_argument("--out", default=None, metavar="JSON",
                   help="write a machine-readable campaign summary")
    return p.parse_args(argv)


def parse_seed_range(text: str) -> range:
    """``LO:HI`` (half-open) or a single seed ``N`` -> a non-empty range.

    Raises ``ValueError`` on malformed input and on empty or inverted
    ranges (``5:5``, ``10:2``): those used to silently fuzz *zero*
    designs and report "0 disagreements", which let CI green-light a
    no-op campaign.
    """
    lo_s, _, hi_s = text.partition(":")
    try:
        lo = int(lo_s)
        hi = int(hi_s) if hi_s else lo + 1
    except ValueError:
        raise ValueError(
            f"--seeds {text!r} is not LO:HI (half-open ints) or a single "
            f"seed N") from None
    if hi <= lo:
        raise ValueError(
            f"--seeds {text!r} is an empty range (need LO < HI): a "
            f"campaign over zero designs proves nothing")
    return range(lo, hi)


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        seeds = parse_seed_range(args.seeds)
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        print("usage: python -m repro_torch.launch.fuzz --seeds LO:HI  "
              "(half-open, LO < HI; e.g. --seeds 0:200)", file=sys.stderr)
        return 2
    if args.backends:
        backends = resolve_backends(args.backends)
    elif args.quick:
        # the CI-bounded set: numpy worklist + cascade, and (when a card
        # is present) the kernel backend — a run without one drops it
        backends = ["worklist", "condensed"]
        import torch
        if torch.cuda.is_available():
            backends.append("cuda")
    else:
        backends = resolve_backends("auto")
    check = {"bounds": bounds_one, "chaos": chaos_one}.get(
        args.mode, functools.partial(fuzz_one, device=args.device))
    if args.mode == "chaos":
        from repro_torch.core.campaign.pool import pick_start_method
        if pick_start_method() != "fork":
            print("error: --mode chaos needs the fork start method "
                  "(generated designs reach workers via copy-on-write; "
                  "CUDA is already initialised or the platform lacks "
                  "fork)",
                  file=sys.stderr)
            return 2

    t0 = time.perf_counter()
    all_mism: List[Mismatch] = []
    n_rows = n_designs = 0

    # 1. corpus replay: prior shrunk reproducers act as regression tests
    corpus_files = (sorted(glob.glob(os.path.join(args.corpus, "*.json")))
                    if args.corpus else [])
    for path, spec in zip(corpus_files, load_corpus_specs(corpus_files)):
        mism, rows = check(spec, backends, n_random=args.configs)
        n_designs += 1
        n_rows += rows
        if mism:
            print(f"CORPUS REGRESSION {os.path.basename(path)}: "
                  f"{mism[0].kind} ({mism[0].detail})")
            all_mism.extend(mism)
    if corpus_files:
        print(f"corpus: {len(corpus_files)} specs replayed, "
              f"{len(all_mism)} regressions")

    # 2. the fresh seed campaign
    for seed in seeds:
        spec = spec_from_seed(seed, quick=args.quick)
        mism, rows = check(spec, backends, n_random=args.configs)
        n_designs += 1
        n_rows += rows
        if not mism:
            continue
        print(f"seed {seed}: {len(mism)} disagreement(s); shrinking...")
        kind, backend = mism[0].kind, mism[0].backend
        small = _shrunk(spec, backends, args.configs,
                        kind=kind, backend=backend, check=check)
        small_mism, _ = check(small, backends, n_random=args.configs)
        same = [m for m in small_mism
                if m.kind == kind and m.backend == backend]
        repro = same[0] if same else mism[0]
        print(f"  minimal repro ({len(small.stages)} stages, n={small.n}): "
              f"{repro.kind} on {repro.backend}: {repro.detail}")
        if args.corpus:
            os.makedirs(args.corpus, exist_ok=True)
            path = os.path.join(args.corpus, f"shrunk_seed{seed}.json")
            with open(path, "w") as f:
                json.dump(corpus_entry(
                    small, note=f"shrunk from seed {seed}",
                    mismatch=repro.to_json()), f, indent=1)
            print(f"  corpus entry written: {path}")
        all_mism.extend(mism)

    wall = time.perf_counter() - t0
    if args.mode == "bounds":
        print(f"\n{n_designs} designs, {n_rows} channels checked against "
              f"the analytical bounds contract (bracket + seeded identity "
              f"+ affine exactness), {wall:.1f}s wall")
    elif args.mode == "chaos":
        print(f"\n{n_designs} designs, {n_rows} rows pooled under "
              f"injected lane deaths (crash/hang per lane + dispatch "
              f"delay), all bit-identical to the fault-free inline "
              f"reference, {wall:.1f}s wall")
    else:
        rate = n_rows * (1 + len(backends)) / max(wall, 1e-9)
        print(f"\n{n_designs} designs, {n_rows} configs x "
              f"{1 + len(backends)} evaluators ({', '.join(backends)} + "
              f"oracle), {wall:.1f}s wall ({rate:.0f} differential evals/s)")
    print(f"disagreements: {len(all_mism)}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({
                "mode": args.mode,
                "n_designs": n_designs, "n_rows": n_rows,
                "backends": list(backends), "wall_s": round(wall, 3),
                "mismatches": [m.to_json() for m in all_mism],
            }, f, indent=1)
    return 1 if all_mism else 0


if __name__ == "__main__":
    sys.exit(main())
