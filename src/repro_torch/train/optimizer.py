"""AdamW + LR schedules (cosine, and MiniCPM's WSD) on nested-dict trees.

The reference's math, leaf for leaf: float32 moments, a global-norm clip
to ``clip_norm`` computed in float32, bias correction, weight decay on
parameters of two or more dimensions only (norms and biases are not
decayed), and the step counter advanced before the learning rate is
read.  The step counter, the learning rate and the norm stay tensors on
the parameters' device, so a step never waits for the card.

:func:`adamw_update` updates the parameters and both moments IN PLACE
and returns those same trees: the caller holds the returned trees next,
as the reference's train step donates its state.  On DTensor leaves a
gradient is first laid out as its parameter is (the reference's jit
out-shardings), since an in-place update keeps its target's layout.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.models import params as pm
from repro_torch.models.sharding import like, sharded_region


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    schedule: str = "cosine"        # cosine | wsd | const
    warmup_steps: int = 100
    total_steps: int = 10_000
    wsd_decay_frac: float = 0.1     # final fraction of steps in decay
    min_lr_frac: float = 0.1


def schedule_lr(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an integer tensor), float32."""
    s = step.to(torch.float32)
    warm = torch.clamp((s + 1.0) / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "const":
        return cfg.lr * warm
    if cfg.schedule == "wsd":
        # Warmup-Stable-Decay (MiniCPM): hold at peak, then cool to min_lr
        decay_steps = int(cfg.total_steps * cfg.wsd_decay_frac)
        start = cfg.total_steps - decay_steps
        frac = torch.clamp((s - start) / max(decay_steps, 1), 0.0, 1.0)
        stable = 1.0 - (1.0 - cfg.min_lr_frac) * frac
        return cfg.lr * warm * stable
    # cosine
    frac = torch.clamp(s / max(cfg.total_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def init_opt_state(params) -> Dict[str, Any]:
    """Zero float32 moments shaped like ``params`` and a zero int32 step,
    on the parameters' device."""
    dev = pm.tree_leaves(params)[0].device

    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)
    return {"m": pm.tree_map(zeros, params), "v": pm.tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _global_norm(tree) -> torch.Tensor:
    """The float32 norm over every leaf (over DTensor leaves, one
    replicated scalar)."""
    return torch.sqrt(sum(torch.sum(torch.square(t.float()))
                          for t in pm.tree_leaves(tree)))


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads, state, params
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: ``(params, state, {"grad_norm", "lr"})``, with
    ``params`` and ``state["m"]``, ``state["v"]`` updated in place."""
    flat_p = pm.tree_leaves(params)
    flat_g = pm.tree_leaves(grads)
    flat_m = pm.tree_leaves(state["m"])
    flat_v = pm.tree_leaves(state["v"])
    if not len(flat_p) == len(flat_g) == len(flat_m) == len(flat_v):
        raise ValueError(f"adamw_update: {len(flat_p)} parameters, "
                         f"{len(flat_g)} gradients, {len(flat_m)} and "
                         f"{len(flat_v)} moments")
    with sharded_region():
        return _adamw(cfg, flat_g, flat_m, flat_v, flat_p, grads, state,
                      params)


def _adamw(cfg, flat_g, flat_m, flat_v, flat_p, grads, state, params):
    step = state["step"] + 1
    gnorm = _global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule_lr(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    c1 = 1.0 - b1 ** step.to(torch.float32)
    c2 = 1.0 - b2 ** step.to(torch.float32)
    for g, m, v, p in zip(flat_g, flat_m, flat_v, flat_p):
        g = like(g, p).float() * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        delta = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        if p.ndim >= 2:                      # decay matrices only
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    new_state = {"m": state["m"], "v": state["v"], "step": step}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
