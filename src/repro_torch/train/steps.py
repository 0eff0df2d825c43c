"""Train / eval / prefill / decode steps (the reference's
``train/steps.py``).

Each ``make_*_step`` returns a plain function.  The train step takes
gradients with ``torch.autograd.grad`` over the parameter leaves and
updates the parameters and optimizer state in place
(:func:`repro_torch.train.optimizer.adamw_update`); the other steps run
under ``torch.no_grad``.  The decode step updates the cache it is given
in place and returns it (the reference's steps donate their state).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models import params as pm
from repro_torch.models.sharding import (like, logsumexp, pick, reshape,
                                         sharded_region, unshard)
from repro_torch.models.transformer import forward, model_specs
from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                         init_opt_state)


def loss_fn(cfg: ArchConfig, params, batch: Dict[str, torch.Tensor],
            cdt=torch.bfloat16, unroll: bool = False, remat: bool = True
            ) -> Tuple[torch.Tensor, Dict]:
    """Causal-LM cross entropy over the padded vocab; labels < 0 are
    masked (frontend prefix, padding).  Frontend archs prepend
    ``embeds`` (stub modality tokens), whose positions get label -1.
    Returns ``(loss + 1e-4 * z_loss, {"loss", "tokens"})``.  ``remat``
    (the reference always rematerializes) lets a caller compare against
    a run that keeps every activation."""
    logits, _ = forward(cfg, params, batch["tokens"],
                        embeds=batch.get("embeds"),
                        remat=remat, return_cache=False, unroll=unroll,
                        cdt=cdt)
    labels = batch["labels"]
    if "embeds" in batch:  # prefix positions carry no LM loss
        prefix = torch.full((labels.shape[0], batch["embeds"].shape[1]), -1,
                            dtype=labels.dtype, device=labels.device)
        labels = torch.cat([prefix, labels], dim=1)
    mask = labels >= 0
    safe = torch.clamp(labels, min=0).long()
    # -log_softmax at the label, without a (B, S, vocab) log-probability
    # tensor: logsumexp minus the label's logit
    lse = logsumexp(logits)
    nll = lse - pick(logits, safe)
    denom = torch.clamp(mask.sum(), min=1)
    loss = torch.where(mask, nll, 0.0).sum() / denom
    # small z-loss stabilizer (standard at scale)
    zl = torch.where(mask, lse ** 2, 0.0).sum() / denom
    return loss + 1e-4 * zl, {"loss": loss,
                              "tokens": denom.to(torch.float32)}


def _aux_and_grads(cfg: ArchConfig, params, batch, cdt, unroll):
    """``(aux, grads)`` of :func:`loss_fn` over every parameter leaf (the
    graph, logits included, is freed before this returns)."""
    live = pm.tree_map(lambda t: t.detach().requires_grad_(), params)
    leaves = pm.tree_leaves(live)
    with torch.enable_grad(), sharded_region():
        loss, aux = loss_fn(cfg, live, batch, cdt, unroll)
        flat = torch.autograd.grad(loss, leaves, allow_unused=True,
                                   materialize_grads=True)
    by_leaf = {id(t): g for t, g in zip(leaves, flat)}
    grads = pm.tree_map(lambda t: by_leaf[id(t)], live)
    return {k: v.detach() for k, v in aux.items()}, grads


def make_train_step(cfg: ArchConfig, opt: OptConfig, cdt=torch.bfloat16,
                    unroll: bool = False, accum: int = 1):
    """One optimizer step: ``train_step(params, opt_state, batch) ->
    (params, opt_state, metrics)``.  ``accum`` > 1 splits the batch into
    ``accum`` microbatches: the gradient is the mean of theirs, and each
    ``aux`` entry the mean of theirs (the reference's ``lax.scan``)."""
    def train_step(params, opt_state, batch):
        if accum <= 1:
            aux, grads = _aux_and_grads(cfg, params, batch, cdt, unroll)
        else:
            micro = {k: reshape(v, accum, v.shape[0] // accum,
                                *v.shape[1:])
                     for k, v in batch.items()}
            grads = pm.tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
            auxs = []
            for i in range(accum):
                a, g = _aux_and_grads(
                    cfg, params, {k: v[i] for k, v in micro.items()}, cdt,
                    unroll)
                for acc, gi in zip(pm.tree_leaves(grads), pm.tree_leaves(g)):
                    acc.add_(like(gi, acc))
                auxs.append(a)
                del g      # not alive beside the next microbatch's
            for acc in pm.tree_leaves(grads):
                acc.div_(accum)
            aux = {k: torch.stack([a[k] for a in auxs]).mean()
                   for k in auxs[0]}
        new_params, new_state, om = adamw_update(opt, grads, opt_state,
                                                 params)
        return new_params, new_state, dict(aux, **om)
    return train_step


def make_eval_step(cfg: ArchConfig, cdt=torch.bfloat16):
    """``eval_step(params, batch) -> {"loss", "tokens"}``, no gradients."""
    @torch.no_grad()
    def eval_step(params, batch):
        _, aux = loss_fn(cfg, params, batch, cdt)
        return aux
    return eval_step


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
        # (DTensor's argmax over a vocab-sharded dim fails at batch 1)
        next_tok = torch.argmax(unshard(logits[:, -1], -1), dim=-1).to(
            torch.int32)
        return next_tok, new_cache
    return decode_step


def init_train_state(cfg: ArchConfig, generator: torch.Generator,
                     param_dtype=torch.float32, device=None):
    """``(params, opt_state)``: parameters drawn from ``generator`` (on
    its device unless ``device`` says otherwise) in ``param_dtype``, and
    zero AdamW state beside them."""
    params = pm.materialize(model_specs(cfg), generator, dtype=param_dtype,
                            device=device)
    return params, init_opt_state(params)
