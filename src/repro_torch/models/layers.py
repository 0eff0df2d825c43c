"""Shared model primitives: RMSNorm, RoPE, SwiGLU MLP, embeddings.

Forward functions take a params dict made from the matching ``*_specs``
function (one source of truth per module).  Compute runs in ``cdt``
(float32 or bfloat16); params are stored float32, as in the reference.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.params import ParamSpec
from repro_torch.models.sharding import constrain, take_rows


def scalar(value: float, dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float: the constant the
    reference makes with ``jnp.asarray(value, dtype)``, without a
    host-to-device copy (which would wait for the card)."""
    return float(torch.tensor(value, dtype=torch.float64).to(dtype))


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * weight.to(dt)


def norm_specs(d: int) -> Dict[str, ParamSpec]:
    return {"w": ParamSpec((d,), ("embed",), init="ones")}


# ------------------------------------------------------------------ RoPE

def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin of shape (..., head_dim//2)."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / (scalar(theta, torch.float32) ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, D); cos/sin (..., S, D/2) broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# ----------------------------------------------------------------- MLP

def mlp_specs(d: int, ff: int) -> Dict[str, ParamSpec]:
    return {
        "gate": ParamSpec((d, ff), ("embed", "mlp")),
        "up": ParamSpec((d, ff), ("embed", "mlp")),
        "down": ParamSpec((ff, d), ("mlp", "embed")),
    }


def mlp(p: Dict, x: torch.Tensor, cdt=torch.bfloat16) -> torch.Tensor:
    """SwiGLU MLP."""
    g = x @ p["gate"].to(cdt)
    u = x @ p["up"].to(cdt)
    h = F.silu(g) * u
    h = constrain(h, "batch", "seq", "mlp")
    return h @ p["down"].to(cdt)


# ----------------------------------------------------------- embeddings

def embed_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    # vocab padded up to a multiple of 16, as in the reference
    vpad = -(-cfg.vocab // 16) * 16
    out = {"tok": ParamSpec((vpad, cfg.d_model), ("vocab", "embed"))}
    if not cfg.tie_embeddings:
        out["out"] = ParamSpec((cfg.d_model, vpad), ("embed", "vocab"))
    return out


def embed(p: Dict, cfg: ArchConfig, tokens: torch.Tensor,
          cdt=torch.bfloat16) -> torch.Tensor:
    # gather, then cast: the same values as casting the table first
    e = take_rows(p["tok"], tokens.long()).to(cdt)
    return e * scalar(cfg.embed_scale, cdt)


def unembed(p: Dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    """Final projection in float32; returns logits over the PADDED vocab
    (ids >= cfg.vocab are never targets, but greedy argmax may pick one,
    exactly as in the reference)."""
    if cfg.tie_embeddings:
        w = p["tok"].float().T
    else:
        w = p["out"].float()
    logits = x.float() @ w
    logits = logits * cfg.logit_scale
    return constrain(logits, "batch", "seq", "vocab")
