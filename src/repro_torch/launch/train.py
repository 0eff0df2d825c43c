"""Training entry point: trains a reduced config end to end on the synthetic
Markov stream.

Fault tolerance: auto-resume from the newest complete checkpoint (atomic
manifests mean a preempted save is invisible), async checkpointing off the
step path, deterministic stateless data (restart == exact replay).

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \\
      --steps 50 --ckpt /tmp/ckpt

It runs on the CUDA device (``--device cuda``, the default, raises without
a card) or, when asked, on the CPU (``--device cpu``).  Weights come from
a ``torch.Generator`` seeded with ``--seed`` on that device.  On the card,
TF32 is switched off so that float32 products stay float32.  As in the
reference, ``--reduced`` is always on: this CLI trains reduced configs
only.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_arch
from repro_torch.core.backends.base import resolve_device
from repro_torch.launch.decode_demo import no_tf32
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.data import DataConfig, SyntheticLM
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.steps import init_train_state, make_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(f"tf32 off: {no_tf32()}")
    cfg = get_arch(args.arch).reduced()
    # MiniCPM picks WSD; everyone else cosine
    sched = "wsd" if args.arch == "minicpm-2b" else "cosine"
    opt_cfg = OptConfig(lr=args.lr, schedule=sched, warmup_steps=10,
                        total_steps=args.steps)

    F = cfg.frontend_tokens
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq - F + 1
                                  if F else args.seq,
                                  global_batch=args.batch,
                                  seed=args.seed), arch=cfg)

    params, opt_state = init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(args.seed))
    start_step = 0
    saver = None
    if args.ckpt:
        saver = ckpt_lib.AsyncCheckpointer(args.ckpt)
        latest = ckpt_lib.latest_step(args.ckpt)
        if latest is not None:
            state = ckpt_lib.restore(args.ckpt, latest,
                                     {"params": params, "opt": opt_state},
                                     device=dev)
            params, opt_state = state["params"], state["opt"]
            start_step = latest
            print(f"resumed from step {latest}")

    step_fn = make_train_step(cfg, opt_cfg, cdt=torch.float32)
    losses = []
    t0 = time.perf_counter()
    for step in range(start_step, args.steps):
        raw = data.batch(step)
        batch = {"tokens": torch.as_tensor(raw["tokens"] % cfg.vocab,
                                           device=dev),
                 "labels": torch.as_tensor(raw["labels"] % cfg.vocab,
                                           device=dev)}
        if "embeds" in raw:
            batch["embeds"] = torch.as_tensor(
                raw["embeds"][:, :, :cfg.d_model], device=dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):.2f} "
                  f"({(time.perf_counter() - t0):.1f}s)")
        if saver and args.ckpt and (step + 1) % args.save_every == 0:
            saver.save(step + 1, {"params": params, "opt": opt_state})
    if saver and args.ckpt:
        saver.save(args.steps, {"params": params, "opt": opt_state})
        saver.wait()
    return {"first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None,
            "steps": args.steps - start_step}


if __name__ == "__main__":
    out = main()
    print(out)
