"""Multi-head Latent Attention (DeepSeek-V2), absorbed formulation.

The KV cache stores only the compressed latent ``c_kv`` (kv_lora_rank)
plus the shared decoupled-RoPE key ``k_rope`` (rope_head_dim) per
position — MLA's point.  The *absorbed* computation is used in every mode
(W_uk folded into the query, W_uv applied after the attention-weighted
latent), so nothing of size (S, heads, head_dim) is materialized.  As in
:mod:`repro_torch.models.attention`, decode writes the cache in place.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.attention import (NEG_INF, _mask, _scale,
                                          query_chunks)
from repro_torch.models.layers import rope_angles
from repro_torch.models.params import ParamSpec
from repro_torch.models.sharding import batch_local, constrain, reshape


def mla_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    return {
        "wdq": ParamSpec((d, m.q_lora_rank), ("embed", None)),
        "wuq_nope": ParamSpec((m.q_lora_rank, h, m.nope_head_dim),
                              (None, "heads", None)),
        "wuq_rope": ParamSpec((m.q_lora_rank, h, m.rope_head_dim),
                              (None, "heads", None)),
        "wdkv": ParamSpec((d, m.kv_lora_rank), ("embed", None)),
        "wk_rope": ParamSpec((d, m.rope_head_dim), ("embed", None)),
        "wuk": ParamSpec((m.kv_lora_rank, h, m.nope_head_dim),
                         (None, "heads", None)),
        "wuv": ParamSpec((m.kv_lora_rank, h, m.v_head_dim),
                         (None, "heads", None)),
        "wo": ParamSpec((h * m.v_head_dim, d), ("heads", "embed")),
    }


def _apply_rope_1h(x, cos, sin):
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c, s = cos.to(x.dtype), sin.to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


@batch_local
def _mla_scores_out(q_lat, q_rope, c_kv, k_rope, q_pos, k_pos, scale):
    """q_lat (B,Q,H,C); q_rope (B,Q,H,R); c_kv (B,S,C); k_rope (B,S,R)."""
    s_lat = torch.einsum("bqhc,bsc->bhqs", q_lat, c_kv)
    s_rope = torch.einsum("bqhr,bsr->bhqs", q_rope, k_rope)
    scores = (s_lat + s_rope) * scale
    scores = scores.float().masked_fill(~_mask(q_pos, k_pos, 0)[None, None],
                                        NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q_lat.dtype)
    return torch.einsum("bhqs,bsc->bqhc", w, c_kv)  # weighted latent


def mla_attention(
    p: Dict, cfg: ArchConfig, x: torch.Tensor,
    positions: torch.Tensor,
    cache: Optional[Dict] = None,
    cache_index: Optional[int] = None,
    cdt=torch.bfloat16,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    m = cfg.mla
    B, S, _ = x.shape
    h = cfg.n_heads

    # queries through the low-rank bottleneck
    q_lora = x @ p["wdq"].to(cdt)
    q_nope = torch.einsum("bsl,lhd->bshd", q_lora, p["wuq_nope"].to(cdt))
    q_rope = torch.einsum("bsl,lhr->bshr", q_lora, p["wuq_rope"].to(cdt))
    cos, sin = rope_angles(positions, m.rope_head_dim, cfg.rope_theta)
    q_rope = _apply_rope_1h(q_rope, cos[..., None, :], sin[..., None, :])
    # absorb W_uk into the query: q_lat (B,S,H,kv_lora)
    q_lat = torch.einsum("bshd,lhd->bshl", q_nope, p["wuk"].to(cdt))

    # keys/values: compressed latent + shared rope key
    c_kv_new = x @ p["wdkv"].to(cdt)
    k_rope_new = _apply_rope_1h(x @ p["wk_rope"].to(cdt), cos, sin)

    scale = _scale(m.nope_head_dim + m.rope_head_dim, cdt)

    if cache is not None:
        i = int(cache_index)
        c_kv, k_rope = cache["c_kv"], cache["k_rope"]
        c_kv[:, i:i + S] = c_kv_new.to(c_kv.dtype)
        k_rope[:, i:i + S] = k_rope_new.to(k_rope.dtype)
        c_kv = constrain(c_kv, "batch", "kv_seq", None)
        k_rope = constrain(k_rope, "batch", "kv_seq", None)
        k_pos = torch.arange(c_kv.shape[1], device=x.device)
        k_pos = torch.where(k_pos <= i, k_pos,
                            torch.full_like(k_pos, 1 << 30))
        lat = _mla_scores_out(q_lat, q_rope, c_kv.to(cdt),
                              k_rope.to(cdt), positions, k_pos, scale)
    else:
        c_kv = constrain(c_kv_new, "batch", "kv_seq", None)
        k_rope = constrain(k_rope_new, "batch", "kv_seq", None)
        n = query_chunks(S)
        c = S // n
        lat = torch.cat([
            _mla_scores_out(q_lat[:, j * c:(j + 1) * c],
                            q_rope[:, j * c:(j + 1) * c], c_kv, k_rope,
                            positions[j * c:(j + 1) * c], positions, scale)
            for j in range(n)], dim=1)
    new_cache = {"c_kv": c_kv, "k_rope": k_rope}

    # un-absorb the value projection, then the output projection
    o = torch.einsum("bqhl,lhv->bqhv", lat, p["wuv"].to(cdt))
    out = reshape(o, B, S, h * m.v_head_dim) @ p["wo"].to(cdt)
    return out, new_cache
