"""Composable decoder-only LM covering every assigned architecture family.

One block function dispatches on the arch family (dense / moe / ssm /
hybrid); the layer stack is a Python loop over the stacked ``(L, ...)``
parameter tensors (the reference's ``lax.scan``).  Heterogeneous leading
layers (DeepSeek-V2's first dense FFN layer) are stacked and looped
separately.

Prefill (no cache) returns the per-layer caches stacked as ``(L, B, S,
...)``.  Decode (a cache and ``cache_index``) writes each layer's new
K/V and SSM state into that cache IN PLACE and returns it: the caller
hands its cache to the step and uses the returned one, as the
reference's decode step donates it.

VLM/audio frontends are stubs, as in the reference: ``embeds``
(precomputed patch/frame embeddings, (B, F, d_model)) are consumed as a
sequence prefix ahead of the token embeddings.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import params as pm
from repro_torch.models.attention import (FULL_WINDOW, gqa_attention,
                                          gqa_specs)
from repro_torch.models.layers import (embed, embed_specs, mlp, mlp_specs,
                                       norm_specs, rms_norm, scalar,
                                       unembed)
from repro_torch.models.mla import mla_attention, mla_specs
from repro_torch.models.moe import moe_ffn, moe_specs
from repro_torch.models.params import ParamSpec
from repro_torch.models.sharding import (constrain, data_ptr, like,
                                         sharded_region)
from repro_torch.models.ssm import ssd_block, ssd_specs


# --------------------------------------------------------------- specs

def block_specs(cfg: ArchConfig, dense_ffn: bool = False) -> Dict:
    """Parameter specs for ONE layer."""
    d = cfg.d_model
    out: Dict[str, Any] = {"ln1": norm_specs(d)}
    if cfg.family == "ssm":
        out["ssm"] = ssd_specs(cfg)
        return out
    out["attn"] = mla_specs(cfg) if cfg.mla else gqa_specs(cfg)
    if cfg.hybrid_ssm:
        out["ssm"] = ssd_specs(cfg)
        out["post_attn"] = norm_specs(d)
        out["post_ssm"] = norm_specs(d)
    out["ln2"] = norm_specs(d)
    if cfg.moe is not None and not dense_ffn:
        out["ffn"] = moe_specs(cfg)
    else:
        ff = cfg.moe.d_ff_dense if (cfg.moe and dense_ffn) else cfg.d_ff
        out["ffn"] = mlp_specs(d, ff)
    return out


def model_specs(cfg: ArchConfig) -> Dict:
    k_dense = cfg.moe.first_k_dense if cfg.moe else 0
    out = {
        "embed": embed_specs(cfg),
        "final_norm": norm_specs(cfg.d_model),
        "layers": pm.stack_layers(block_specs(cfg), cfg.n_layers - k_dense),
    }
    if k_dense:
        out["dense_layers"] = pm.stack_layers(
            block_specs(cfg, dense_ffn=True), k_dense)
    return out


# --------------------------------------------------------------- cache

def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               dtype=torch.bfloat16) -> Dict:
    """KV/SSM cache specs (all zeros; make them with
    :func:`repro_torch.models.params.materialize`)."""
    def layer_cache() -> Dict:
        c: Dict[str, ParamSpec] = {}
        if cfg.family == "ssm" or cfg.hybrid_ssm:
            s = cfg.ssm
            d_in = s.expand * cfg.d_model
            heads = d_in // s.head_dim
            c["ssm_state"] = ParamSpec(
                (batch, heads, s.head_dim, s.d_state),
                ("batch", "ssm_heads", None, None), torch.float32, "zeros")
            c["ssm_conv"] = ParamSpec(
                (batch, s.d_conv - 1, d_in + 2 * s.d_state),
                ("batch", None, "ssm_inner"), torch.float32, "zeros")
        if cfg.family != "ssm":
            if cfg.mla:
                m = cfg.mla
                c["c_kv"] = ParamSpec((batch, max_len, m.kv_lora_rank),
                                      ("batch", "kv_seq", None),
                                      dtype, "zeros")
                c["k_rope"] = ParamSpec((batch, max_len, m.rope_head_dim),
                                        ("batch", "kv_seq", None),
                                        dtype, "zeros")
            else:
                kv, hd = cfg.n_kv_heads, cfg.head_dim_
                c["k"] = ParamSpec((batch, max_len, kv, hd),
                                   ("batch", "kv_seq", "kv_heads", None),
                                   dtype, "zeros")
                c["v"] = ParamSpec((batch, max_len, kv, hd),
                                   ("batch", "kv_seq", "kv_heads", None),
                                   dtype, "zeros")
        return c

    k_dense = cfg.moe.first_k_dense if cfg.moe else 0
    out = {"layers": pm.stack_layers(layer_cache(), cfg.n_layers - k_dense)}
    if k_dense:
        out["dense_layers"] = pm.stack_layers(layer_cache(), k_dense)
    return out


# --------------------------------------------------------------- blocks

def _layer_windows(cfg: ArchConfig, n: int, offset: int = 0) -> np.ndarray:
    """Per-layer attention window (FULL_WINDOW = global)."""
    if not cfg.sliding_window:
        return np.full(n, FULL_WINDOW, dtype=np.int32)
    w = np.full(n, cfg.sliding_window, dtype=np.int32)
    for i in range(n):
        li = i + offset
        is_global = (cfg.global_attn_every and
                     (li % cfg.global_attn_every == 0
                      or li == cfg.n_layers - 1))
        if is_global:
            w[i] = FULL_WINDOW
    return w


def block_apply(cfg: ArchConfig, p: Dict, x: torch.Tensor,
                positions: torch.Tensor, window,
                cache: Optional[Dict], cache_index,
                dense_ffn: bool = False, cdt=torch.bfloat16
                ) -> Tuple[torch.Tensor, Dict]:
    rs = scalar(cfg.residual_scale, cdt)
    new_cache: Dict[str, Any] = {}
    h = rms_norm(x, p["ln1"]["w"], cfg.norm_eps)

    if cfg.family == "ssm":
        sc = ({"state": cache["ssm_state"], "conv": cache["ssm_conv"]}
              if cache is not None else None)
        y, nc = ssd_block(p["ssm"], cfg, h, sc, cache_index, cdt)
        new_cache.update(ssm_state=nc["state"], ssm_conv=nc["conv"])
        return x + y * rs, new_cache

    if cfg.mla:
        mc = ({"c_kv": cache["c_kv"], "k_rope": cache["k_rope"]}
              if cache is not None else None)
        attn_out, kvc = mla_attention(p["attn"], cfg, h, positions,
                                      mc, cache_index, cdt)
        new_cache.update(c_kv=kvc["c_kv"], k_rope=kvc["k_rope"])
    else:
        kc = ({"k": cache["k"], "v": cache["v"]}
              if cache is not None else None)
        attn_out, kvc = gqa_attention(p["attn"], cfg, h, positions, window,
                                      kc, cache_index, cdt)
        new_cache.update(k=kvc["k"], v=kvc["v"])

    if cfg.hybrid_ssm:
        sc = ({"state": cache["ssm_state"], "conv": cache["ssm_conv"]}
              if cache is not None else None)
        ssm_out, nc = ssd_block(p["ssm"], cfg, h, sc, cache_index, cdt)
        new_cache.update(ssm_state=nc["state"], ssm_conv=nc["conv"])
        y = 0.5 * (rms_norm(attn_out, p["post_attn"]["w"], cfg.norm_eps)
                   + rms_norm(ssm_out, p["post_ssm"]["w"], cfg.norm_eps))
    else:
        y = attn_out

    x = x + y * rs
    h2 = rms_norm(x, p["ln2"]["w"], cfg.norm_eps)
    if cfg.moe is not None and not dense_ffn:
        f = moe_ffn(p["ffn"], cfg, h2, cdt)
    else:
        f = mlp(p["ffn"], h2, cdt)
    return x + f * rs, new_cache


# --------------------------------------------------------------- model

def _layer_loop(cfg: ArchConfig, stacked_params: Dict, x: torch.Tensor,
                positions: torch.Tensor, windows: np.ndarray,
                cache: Optional[Dict], cache_index, dense_ffn: bool,
                remat: bool, collect_cache: bool, cdt
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """The reference's ``_scan_stack``: layer ``i`` reads slice ``i`` of
    every stacked tensor.  With a cache, each layer's new entries are
    written into slice ``i`` of it (K/V already are, by the attention).

    With ``remat`` and grad mode on (training), each layer runs under
    ``torch.utils.checkpoint``: only its input is kept for the backward
    pass, which runs the layer again (the reference's ``jax.checkpoint``
    with ``nothing_saveable``).  A layer draws no random numbers, so the
    RNG state is not stashed."""
    n = pm.tree_leaves(stacked_params)[0].shape[0]
    remat = remat and cache is None and torch.is_grad_enabled()
    per_layer = []
    for i in range(n):
        p_i = pm.tree_map(lambda a: a[i], stacked_params)
        c_i = (pm.tree_map(lambda a: a[i], cache)
               if cache is not None else None)
        args = (cfg, p_i, x, positions, int(windows[i]), c_i, cache_index,
                dense_ffn, cdt)
        if remat:
            x, nc = checkpoint(block_apply, *args, use_reentrant=False,
                               preserve_rng_state=False)
        else:
            x, nc = block_apply(*args)
        # the residual stream stays laid out as the embedding's output:
        # a partial sum (a row-parallel product's) is reduced here, not
        # carried into the next layer and, in the backward pass, gathered
        # whole
        x = constrain(x, "batch", "seq", "embed")
        if cache is not None:
            for k, v in nc.items():
                if data_ptr(v) != data_ptr(c_i[k]):
                    c_i[k].copy_(like(v, c_i[k]))
        elif collect_cache:
            per_layer.append(nc)
    if cache is not None:
        return x, cache
    if not collect_cache:
        return x, None
    return x, {k: torch.stack([c[k] for c in per_layer])
               for k in per_layer[0]}


def forward(cfg: ArchConfig, params: Dict, tokens: torch.Tensor,
            embeds: Optional[torch.Tensor] = None,
            cache: Optional[Dict] = None,
            cache_index=None,
            positions: Optional[torch.Tensor] = None,
            remat: bool = True,
            return_cache: bool = True,
            unroll: bool = False,
            cdt=torch.bfloat16) -> Tuple[torch.Tensor, Optional[Dict]]:
    """tokens (B, S_text); embeds (B, F, d) optional frontend prefix.

    Prefill: ``cache=None``; returns (logits (B, S, vocab_padded),
    per-layer caches stacked (L, B, S, ...)).  Decode: tokens (B, 1),
    cache + cache_index given; the cache is updated in place and
    returned.  ``remat`` recomputes each layer in the backward pass
    instead of keeping its activations (see :func:`_layer_loop`); it
    acts only in grad mode without a cache, so inference never pays for
    it.  ``unroll`` is accepted for the reference's signature: the layer
    loop is a Python loop already.
    """
    with sharded_region():
        return _forward(cfg, params, tokens, embeds, cache, cache_index,
                        positions, remat, return_cache, cdt)


def _forward(cfg, params, tokens, embeds, cache, cache_index, positions,
             remat, return_cache, cdt):
    x = embed(params["embed"], cfg, tokens, cdt)
    if embeds is not None:
        x = torch.cat([embeds.to(cdt), x], dim=1)
    x = constrain(x, "batch", "seq", "embed")
    S = x.shape[1]
    if positions is None:
        if cache_index is not None and S == 1:
            i = int(cache_index)
            positions = torch.arange(i, i + 1, device=x.device)
        else:
            positions = torch.arange(S, device=x.device)

    k_dense = cfg.moe.first_k_dense if cfg.moe else 0
    new_cache: Dict[str, Any] = {}
    if k_dense:
        x, nc = _layer_loop(cfg, params["dense_layers"], x, positions,
                            _layer_windows(cfg, k_dense),
                            cache.get("dense_layers") if cache else None,
                            cache_index, True, remat, return_cache, cdt)
        new_cache["dense_layers"] = nc
    x, nc = _layer_loop(cfg, params["layers"], x, positions,
                        _layer_windows(cfg, cfg.n_layers - k_dense, k_dense),
                        cache.get("layers") if cache else None,
                        cache_index, False, remat, return_cache, cdt)
    new_cache["layers"] = nc

    x = rms_norm(x, params["final_norm"]["w"], cfg.norm_eps)
    logits = unembed(params["embed"], cfg, x)
    return logits, (new_cache if return_cache else None)
