"""LLM decode demo: batched prefill + token-by-token decode on a reduced
config, in float32.

  PYTHONPATH=src python -m repro_torch.launch.decode_demo \\
      --arch mamba2-1.3b --batch 4 --prompt-len 32 --gen 16

It runs on the CUDA device (``--device cuda``, the default, raises without
a card) or, when asked, on the CPU (``--device cpu``).  Weights and
prompts come from a ``torch.Generator`` seeded with ``--seed`` on that
device.  On the card, TF32 is switched off so that float32 products stay
float32; the flags are printed.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.backends.base import resolve_device
from repro_torch.models import params as pm
from repro_torch.models.transformer import model_specs
from repro_torch.train.steps import make_decode_step, make_prefill_step


def no_tf32() -> dict:
    """Keep float32 matmuls and convolutions in float32 (no TF32); returns
    the flags as set."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return {"matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "float32_matmul_precision":
                torch.get_float32_matmul_precision()}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch."
                                      "decode_demo")
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(f"tf32 off: {no_tf32()}")
    cfg = get_arch(args.arch).reduced()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = pm.materialize(model_specs(cfg), gen)

    B = args.batch
    F = cfg.frontend_tokens
    max_len = args.prompt_len + args.gen
    toks = torch.randint(0, cfg.vocab, (B, args.prompt_len - F),
                         generator=gen, device=dev)
    embeds = (torch.randn((B, F, cfg.d_model), generator=gen, device=dev)
              if F else None)

    prefill = make_prefill_step(cfg, max_len, cdt=torch.float32)
    decode = make_decode_step(cfg, cdt=torch.float32)

    _sync(dev)
    t0 = time.perf_counter()
    last_logits, cache = prefill(params, toks, embeds)
    tok = torch.argmax(last_logits, -1).to(torch.int32)[:, None]
    _sync(dev)
    t_prefill = time.perf_counter() - t0

    out_tokens = [tok[:, 0]]
    t0 = time.perf_counter()
    for i in range(args.gen - 1):
        tok, cache = decode(params, cache, tok, args.prompt_len + i)
        tok = tok[:, None]
        out_tokens.append(tok[:, 0])
    _sync(dev)
    t_decode = time.perf_counter() - t0
    toks_s = B * (args.gen - 1) / max(t_decode, 1e-9)
    print(f"prefill {args.prompt_len} toks x{B}: {t_prefill:.2f}s | "
          f"decode {args.gen - 1} steps: {t_decode:.2f}s "
          f"({toks_s:.1f} tok/s) on {dev}")
    gen_toks = torch.stack(out_tokens, dim=1).cpu().numpy()
    print("generated:", gen_toks[0][:12], "...")
    return {"prefill_s": t_prefill, "decode_s": t_decode,
            "tok_per_s": toks_s, "tokens": np.asarray(gen_toks)}


if __name__ == "__main__":
    main()
