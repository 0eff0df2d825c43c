"""Prefill / decode steps: the serving half of the reference's
``train/steps.py``.

Each ``make_*_step`` returns a plain function that runs under
``torch.no_grad``.
The decode step updates the cache it is given in place and returns it
(the reference's decode step donates its cache).  ``loss_fn`` and the
train/eval steps come with training (ROADMAP P14b).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.transformer import forward

_KV_KEYS = ("k", "v", "c_kv", "k_rope")


def make_prefill_step(cfg: ArchConfig, max_len: int, cdt=torch.bfloat16):
    """Forward over the prompt, returning the last logits and the cache
    grown to ``max_len`` (prompt K/V occupy [0, S))."""
    @torch.no_grad()
    def prefill_step(params, tokens, embeds=None):
        logits, cache = forward(cfg, params, tokens, embeds=embeds,
                                remat=False, return_cache=True, cdt=cdt)
        cache = _pad_cache_to(cfg, cache, max_len)
        return logits[:, -1], cache
    return prefill_step


def _pad_cache_to(cfg: ArchConfig, cache, max_len: int):
    """Grow per-layer KV tensors (stacked (L, B, S, ...) layout, dim 2 = S)
    from prompt length to the serving window.  SSM state is length-free."""
    if cfg.family == "ssm":
        return cache

    def pad(x):
        padw = [0, 0] * x.ndim
        padw[2 * (x.ndim - 3) + 1] = max_len - x.shape[2]
        return F.pad(x, padw)

    return {grp: {k: (pad(v) if k in _KV_KEYS and v.shape[2] < max_len
                      else v) for k, v in sub.items()}
            for grp, sub in cache.items()}


def make_decode_step(cfg: ArchConfig, cdt=torch.bfloat16):
    """One new token against a pre-filled cache: ``decode_step(params,
    cache, tokens (B, 1), index) -> (next_tok (B,) int32, cache)``, the
    cache updated in place."""
    @torch.no_grad()
    def decode_step(params, cache, tokens, index):
        logits, new_cache = forward(cfg, params, tokens, cache=cache,
                                    cache_index=index, remat=False,
                                    return_cache=True, cdt=cdt)
        next_tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return next_tok, new_cache
    return decode_step
