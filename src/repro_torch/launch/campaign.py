"""CLI for cross-design DSE campaigns.

Runs designs x optimizers as one scheduled workload with checkpointing:

  python -m repro_torch.launch.campaign --designs gemm,FeedForward \\
      --optimizers grouped_sa,grouped_random --budget 300 \\
      --checkpoint camp.npz --out campaign_results.json
  python -m repro_torch.launch.campaign --designs fast --hetero \\
      --workers 0          # every full-solve row through one K2 launch

  # after a kill, continue exactly where it stopped (byte-identical
  # frontiers to an uninterrupted run):
  python -m repro_torch.launch.campaign --resume camp.npz

Design sets: ``quick`` (CI smoke pair), ``fast`` (the benchmark subset),
``all`` (every Stream-HLS design), or a comma-separated list of names.
The tensor backends and the hetero dispatch run on the CUDA device;
``--device cpu`` runs them on the CPU (the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import sys
import time



def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.campaign",
        description="Run a cross-design FIFO-sizing DSE campaign.")
    p.add_argument("--designs", default="quick",
                   help="design set (quick/fast/all) or comma-list "
                        "of Stream-HLS design names")
    p.add_argument("--optimizers", default="grouped_sa,grouped_random",
                   help="comma-list of optimizer names")
    p.add_argument("--budget", type=int, default=300,
                   help="evaluation budget per task")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backend", default="cuda",
                   help="per-design evaluator backend "
                        "(cuda/pallas, fixpoint/jax, numpy/worklist, "
                        "auto)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the tensor backends and the "
                        "hetero dispatch (cuda, or cpu)")
    p.add_argument("--workers", default=None,
                   help="worklist worker processes: an int, 'auto', or 0 "
                        "to evaluate inline (default: auto for new "
                        "campaigns, the checkpointed value on --resume)")
    p.add_argument("--hetero", action="store_true",
                   help="pack cross-design batches into one fixpoint "
                        "dispatch (one K2 launch on the card)")
    p.add_argument("--shards", type=int, default=None, metavar="N",
                   help="shard batched evaluation over N devices "
                        "(with --hetero: shards the packed cross-design "
                        "batch; otherwise forces the mesh backend); with "
                        "--device cpu the CPU is repeated N times")
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="write campaign state to this .npz periodically")
    p.add_argument("--checkpoint-every", type=int, default=8,
                   metavar="ROUNDS")
    p.add_argument("--resume", default=None, metavar="PATH",
                   help="resume from a checkpoint (other spec flags are "
                        "taken from the checkpoint)")
    p.add_argument("--max-rounds", type=int, default=None,
                   help="stop (and checkpoint) after this many rounds")
    p.add_argument("--out", default=None, metavar="JSON",
                   help="write per-task results to this JSON file")
    p.add_argument("--track-hypervolume", action="store_true",
                   help="record per-round hypervolume trajectories "
                        "(slower; for convergence studies)")
    p.add_argument("--alpha", type=float, default=0.7,
                   help="alpha for the selected-point summaries")
    return p.parse_args(argv)


def resolve_designs(arg: str):
    from repro_torch.designs import (FAST_DESIGNS, QUICK_DESIGNS,
                               STREAMHLS_DESIGNS)
    sets = {"quick": list(QUICK_DESIGNS), "fast": list(FAST_DESIGNS),
            "all": sorted(STREAMHLS_DESIGNS)}
    if arg in sets:
        return sets[arg]
    return [d.strip() for d in arg.split(",") if d.strip()]


def resolve_workers(arg) -> int:
    from repro_torch.core.campaign import default_workers
    if arg == "auto":
        return default_workers()
    return int(arg)


def main(argv=None) -> int:
    args = parse_args(argv)
    from repro_torch.core.campaign import Campaign, CampaignSpec

    t0 = time.perf_counter()
    if args.resume:
        # only override the checkpointed worker count when the user
        # explicitly passed --workers
        override = (resolve_workers(args.workers)
                    if args.workers is not None else None)
        campaign = Campaign.resume(
            args.resume, workers=override,
            checkpoint_path=args.checkpoint or args.resume,
            device=args.device)
        print(f"resumed {len(campaign.tasks)} tasks at round "
              f"{campaign.round} "
              f"({sum(t.done for t in campaign.tasks)} already done)")
    else:
        from repro_torch.core.config import EvalConfig
        spec = CampaignSpec(
            designs=tuple(resolve_designs(args.designs)),
            optimizers=tuple(
                o.strip() for o in args.optimizers.split(",") if o.strip()),
            budget=args.budget, seed=args.seed,
            eval=EvalConfig(backend=args.backend, shards=args.shards),
            workers=resolve_workers(args.workers
                                    if args.workers is not None
                                    else "auto"),
            hetero=args.hetero,
            checkpoint_every=args.checkpoint_every,
            track_hypervolume=args.track_hypervolume)
        campaign = Campaign(spec, checkpoint_path=args.checkpoint,
                            device=args.device)
        print(f"campaign: {len(campaign.tasks)} tasks "
              f"({len(campaign.designs)} designs x "
              f"{len(spec.optimizers)} optimizers), backend="
              f"{spec.backend}, workers={spec.workers}"
              f"{', hetero' if spec.hetero else ''}"
              f"{f', shards={spec.shards}' if spec.shards else ''}")

    store = campaign.run(max_rounds=args.max_rounds)
    wall = time.perf_counter() - t0

    if not campaign.finished:
        print(f"stopped after --max-rounds at round {campaign.round} "
              f"({sum(t.done for t in campaign.tasks)}/"
              f"{len(campaign.tasks)} tasks done)"
              + (f"; resume with --resume {campaign.checkpoint_path}"
                 if campaign.checkpoint_path else ""))

    print(f"\n{'task':38s} {'evals':>6} {'frontier':>8} "
          f"{'hypervolume':>12} {'selected':>16}")
    for key in store.keys():
        dse = store[key]
        sel = dse.selected(args.alpha)
        sel_s = (f"({int(sel[0][0])},{int(sel[0][1])})"
                 if sel is not None else "-")
        print(f"{key:38s} {dse.result.n_evals:6d} "
              f"{dse.frontier_points.shape[0]:8d} "
              f"{dse.hypervolume():12.1f} {sel_s:>16}")
    print(f"\n{len(store)} tasks, {store.total_evals()} simulated "
          f"configs, {wall:.2f}s wall")
    if args.out:
        store.save_json(args.out, alpha=args.alpha,
                        extra={"wall_s": round(wall, 3)})
        print(f"results written to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
