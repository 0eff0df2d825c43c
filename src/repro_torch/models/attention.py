"""GQA attention: causal, optionally sliding-window, queries in chunks.

A plain torch transcription of the reference's jnp attention (not
``scaled_dot_product_attention``): scores in ``cdt``, masked and soft-maxed
in float32, with the GQA head grouping done by a reshape.  Prompts longer
than ``Q_CHUNK`` are processed in query chunks of ``Q_CHUNK``, so the
(Q, S) score tile, not the S x S matrix, bounds memory; as in the
reference, such prompts must be a multiple of ``Q_CHUNK`` long.

Decode writes the new token's K/V into the caller's cache IN PLACE at
``cache_index`` and attends over every cached position up to it (the
reference donates its cache to the decode step, so nothing reads the old
one).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import apply_rope, rope_angles, scalar
from repro_torch.models.params import ParamSpec
from repro_torch.models.sharding import batch_local, constrain, reshape

NEG_INF = -1e9
Q_CHUNK = 512
FULL_WINDOW = 1 << 30   # "no sliding window" sentinel


def gqa_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    d, hd = cfg.d_model, cfg.head_dim_
    h, kv = cfg.n_heads, cfg.n_kv_heads
    out = {
        "wq": ParamSpec((d, h * hd), ("embed", "heads")),
        "wk": ParamSpec((d, kv * hd), ("embed", "kv_heads")),
        "wv": ParamSpec((d, kv * hd), ("embed", "kv_heads")),
        "wo": ParamSpec((h * hd, d), ("heads", "embed")),
    }
    if cfg.qkv_bias:
        out["bq"] = ParamSpec((h * hd,), ("heads",), init="zeros")
        out["bk"] = ParamSpec((kv * hd,), ("kv_heads",), init="zeros")
        out["bv"] = ParamSpec((kv * hd,), ("kv_heads",), init="zeros")
    return out


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
          window: int) -> torch.Tensor:
    """(Q, S) True where attention is allowed (causal + sliding window);
    a window of 0 or FULL_WINDOW means full causal attention."""
    w = FULL_WINDOW if int(window) <= 0 else int(window)
    ok = k_pos[None, :] <= q_pos[:, None]
    ok &= k_pos[None, :] > q_pos[:, None] - w
    return ok


def _scale(d: int, dtype) -> float:
    """1 / sqrt(d), computed in float32 and rounded to ``dtype`` as the
    reference does."""
    s = 1.0 / torch.sqrt(torch.tensor(float(d), dtype=torch.float32))
    return scalar(float(s), dtype)


@batch_local
def _sdpa(q, k, v, q_pos, k_pos, window: int) -> torch.Tensor:
    """q (B,Q,H,D); k/v (B,S,KV,D); GQA grouped."""
    B, Q, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    qg = q.reshape(B, Q, KV, G, D)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg * _scale(D, q.dtype), k)
    scores = scores.float().masked_fill(
        ~_mask(q_pos, k_pos, window)[None, None, None], NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v)
    return out.reshape(B, Q, H, D)


def query_chunks(S: int) -> int:
    """How many ``Q_CHUNK`` query chunks a prompt of S tokens takes (1
    when it fits one); raises when S is longer but not a multiple."""
    if S <= Q_CHUNK:
        return 1
    if S % Q_CHUNK:
        raise ValueError(f"a prompt of {S} tokens must be at most "
                         f"{Q_CHUNK} or a multiple of {Q_CHUNK}")
    return S // Q_CHUNK


def gqa_attention(
    p: Dict, cfg: ArchConfig, x: torch.Tensor,
    positions: torch.Tensor,
    window: int = 0,
    cache: Optional[Dict] = None,
    cache_index: Optional[int] = None,
    cdt=torch.bfloat16,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Returns (attn_out (B,S,d), cache entry).

    Prefill (``cache=None``): the fresh K/V are the cache entry.  Decode
    (``cache`` given, ``cache_index`` the position of ``x``'s first
    token): the new K/V are written into ``cache`` in place, which is
    returned.
    """
    B, S, d = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_

    q = x @ p["wq"].to(cdt)
    k = x @ p["wk"].to(cdt)
    v = x @ p["wv"].to(cdt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(cdt)
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    q = reshape(q, B, S, h, hd)
    k = reshape(k, B, S, kv, hd)
    v = reshape(v, B, S, kv, hd)

    cos, sin = rope_angles(positions, hd, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    if cache is not None:
        i = int(cache_index)
        ck, cv = cache["k"], cache["v"]
        ck[:, i:i + S] = k.to(ck.dtype)
        cv[:, i:i + S] = v.to(cv.dtype)
        ck = constrain(ck, "batch", "kv_seq", "kv_heads", None)
        cv = constrain(cv, "batch", "kv_seq", "kv_heads", None)
        k_pos = torch.arange(ck.shape[1], device=x.device)
        k_pos = torch.where(k_pos <= i, k_pos,
                            torch.full_like(k_pos, 1 << 30))
        qo = _sdpa(q, ck.to(cdt), cv.to(cdt), positions, k_pos, window)
        out = reshape(qo, B, S, h * hd) @ p["wo"].to(cdt)
        return out, {"k": ck, "v": cv}

    k = constrain(k, "batch", "kv_seq", "kv_heads", None)
    v = constrain(v, "batch", "kv_seq", "kv_heads", None)
    n = query_chunks(S)
    qo = torch.cat([
        _sdpa(q[:, j * (S // n):(j + 1) * (S // n)], k, v,
              positions[j * (S // n):(j + 1) * (S // n)], positions, window)
        for j in range(n)], dim=1)
    out = reshape(qo, B, S, h * hd) @ p["wo"].to(cdt)
    return out, {"k": k, "v": v}
