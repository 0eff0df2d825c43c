"""Mixture-of-Experts FFN with capacity-based dispatch (GShard-style).

Top-k routing with per-expert capacity ``C = min(max(8, ceil(cf * N * k /
E)), N)``; overflow tokens are dropped, underflow slots stay zero.  Shared
experts (DeepSeek-V2) are plain dense FFNs added to the routed output.

Two choices keep this equal to the reference on the same inputs:

* the top-k is a stable descending sort, so tied gates pick the lower
  expert index first, as ``lax.top_k`` does;
* every kept (token, slot) owns a distinct ``(expert, position)`` buffer
  slot, so the dispatch is an index assignment — no scatter-add, whose
  order on CUDA is not fixed.  Dropped ones are assigned to a spare slot
  past the end, which is cut off.  The reference's scatter-add adds only
  zeros beyond the kept rows (dropped tokens masked to zero at position
  ``C - 1``), so both give the same buffer.

Over a mesh of several devices the routing runs on the full (N, K)
decisions on every rank, and each rank dispatches its own tokens into
its own experts' buffer rows (:class:`_Layout`).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import mlp, mlp_specs
from repro_torch.models.params import ParamSpec
from repro_torch.models import params as pm
from repro_torch.models.sharding import (Sharding, constrain, from_local,
                                         get_ctx, is_sharded, redistribute,
                                         reshape, unshard)


def moe_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    mo = cfg.moe
    d, e, f = cfg.d_model, mo.n_experts, mo.d_ff_expert
    out = {
        "router": ParamSpec((d, e), ("embed", None), scale=0.006),
        "gate": ParamSpec((e, d, f), ("experts", "fsdp", None)),
        "up": ParamSpec((e, d, f), ("experts", "fsdp", None)),
        "down": ParamSpec((e, f, d), ("experts", None, "fsdp")),
    }
    for i in range(mo.n_shared):
        out[f"shared{i}"] = mlp_specs(d, mo.d_ff_shared)
    return out


def capacity(cfg: ArchConfig, n_tokens: int) -> int:
    """Per-expert buffer slots for ``n_tokens`` routed tokens."""
    mo = cfg.moe
    c = max(8, int(-(-mo.capacity_factor * n_tokens * mo.top_k
                     // mo.n_experts)))
    return min(c, n_tokens)


def moe_ffn(p: Dict, cfg: ArchConfig, x: torch.Tensor,
            cdt=torch.bfloat16) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d)."""
    mo = cfg.moe
    B, S, d = x.shape
    N = B * S
    E, K = mo.n_experts, mo.top_k
    C = capacity(cfg, N)

    xf = reshape(x, N, d)
    logits = (xf @ p["router"].to(cdt)).float()
    gates_all = torch.softmax(logits, dim=-1)
    top_g, top_e = torch.sort(gates_all, dim=-1, descending=True,
                              stable=True)
    top_g, top_e = top_g[:, :K], top_e[:, :K]                # (N, K)
    top_g = top_g / torch.clamp(top_g.sum(-1, keepdim=True), min=1e-9)

    if is_sharded():     # every rank places every token: (N, K) ints
        top_e = unshard(top_e, 0).to_local()

    # per-(token, slot) position within its expert's capacity buffer
    counts = torch.zeros((E,), dtype=torch.long, device=x.device)
    pos = torch.zeros((N, K), dtype=torch.long, device=x.device)
    for j in range(K):
        onehot = F.one_hot(top_e[:, j], E)                   # (N, E)
        within = torch.cumsum(onehot, dim=0) - 1
        pos[:, j] = torch.gather(within + counts[None, :], 1,
                                 top_e[:, j:j + 1])[:, 0]
        counts = counts + onehot.sum(dim=0)
    keep = pos < C
    pos_c = torch.clamp(pos, max=C - 1)

    # dispatch: every kept (token, slot) into its own (E, C, d) slot; the
    # dropped ones all land in a spare slot C, which is cut off
    slot = torch.where(keep, pos, C)
    if is_sharded():
        lay = _Layout(xf, E, C)
        buf = lay.dispatch(xf, top_e, slot, cdt)
    else:
        buf = _dispatch(xf, top_e, slot, E, C, cdt)
    buf = constrain(buf, "experts", "capacity", None)

    # expert computation (batched over the expert axis)
    g = torch.bmm(buf, p["gate"].to(cdt))
    u = torch.bmm(buf, p["up"].to(cdt))
    h = F.silu(g) * u
    h = constrain(h, "experts", "capacity", None)
    ob = torch.bmm(h, p["down"].to(cdt))
    ob = constrain(ob, "experts", "capacity", None)

    # combine: gather each token's expert outputs, weight by gates
    if is_sharded():
        y = lay.combine(ob, top_e, pos_c, top_g, keep, cdt)
    else:
        y = _combine(ob, top_e, pos_c, top_g, keep, cdt)

    y = reshape(y, B, S, d)
    for i in range(mo.n_shared):
        y = y + mlp(p[f"shared{i}"], x, cdt)   # shared experts: dense path
    return y


def _dispatch(xf, top_e, slot, E: int, C: int, cdt) -> torch.Tensor:
    """The (E, C, d) expert buffer: row ``xf[n]`` at ``(top_e[n, j],
    slot[n, j])``; every kept (token, slot) owns its own buffer slot, and
    the dropped ones all land in a spare slot C, which is cut off."""
    buf = torch.zeros((E, C + 1, xf.shape[-1]), dtype=cdt,
                      device=xf.device)
    for j in range(top_e.shape[1]):
        buf[top_e[:, j], slot[:, j]] = xf.to(cdt)
    return buf[:, :C].contiguous()


def _combine(ob, top_e, pos_c, top_g, keep, cdt) -> torch.Tensor:
    """Each token's expert outputs from ``ob``, weighted by its gates
    (zero where the token was dropped)."""
    y = torch.zeros((top_e.shape[0], ob.shape[-1]), dtype=cdt,
                    device=ob.device)
    for j in range(top_e.shape[1]):
        o = ob[top_e[:, j], pos_c[:, j]]
        w = (top_g[:, j] * keep[:, j]).to(cdt)
        y = y + o * w[:, None]
    return y


class _Layout:
    """Dispatch and combine over a mesh, with the routing (``top_e``,
    slots, ``keep``: full (N, K) on every rank) replicated.

    Tokens are laid out as ``("batch", None)`` and the buffer as
    ``("experts", "capacity", None)``.  Each rank writes its own tokens
    into its own experts' rows, so the buffer it holds is a partial sum
    over the mesh dims that shard the tokens; each rank reads back its
    own tokens from its own experts, so the output is a partial sum over
    the mesh dims that shard the experts.  A mesh dim that would shard
    both keeps the tokens whole."""

    def __init__(self, xf, E: int, C: int):
        from torch.distributed.tensor import Partial, Replicate
        ctx = get_ctx()
        self.mesh = ctx.device_mesh()
        pe = ctx.placements(("experts", "capacity", None))
        px = [Replicate() if e.is_shard() else t for t, e in
              zip(ctx.placements(("batch", None)), pe)]

        def mix(first, second):    # per mesh dim: first's shard, else
            return tuple(a if a.is_shard() else             # second's
                         (Partial() if b.is_shard() else Replicate())
                         for a, b in zip(first, second))
        self.px, self.pe = tuple(px), pe
        self.buf_pl = mix(pe, px)      # buffer: experts, partial in tokens
        self.tok_pl = mix(px, pe)      # tokens: rows, partial in experts
        self.N, self.d, self.E, self.C = xf.shape[0], xf.shape[1], E, C
        self.rows = pm.shard_bounds((self.N, self.d),
                               Sharding(self.mesh, self.px))[0]
        self.experts = pm.shard_bounds((E, C, self.d),
                                  Sharding(self.mesh, pe))[0]

    def _mine(self, top_e):
        """This rank's rows of ``top_e`` (expert ids made local) and
        where they name one of its experts."""
        (n0, n1), (e0, e1) = self.rows, self.experts
        e = top_e[n0:n1]
        mine = (e >= e0) & (e < e1)
        return torch.where(mine, e - e0, 0), mine

    def _local(self, x):
        """The local tokens of ``x`` (N, ...), their gradient partial
        over the expert dims."""
        x = redistribute(x, Sharding(self.mesh, self.px))
        return x.to_local(grad_placements=self.tok_pl)

    def dispatch(self, xf, top_e, slot, cdt):
        (n0, n1), (e0, e1) = self.rows, self.experts
        e, mine = self._mine(top_e)
        s = torch.where(mine, slot[n0:n1], self.C)
        buf = _dispatch(self._local(xf), e, s, e1 - e0, self.C, cdt)
        return from_local(buf, self.mesh, self.buf_pl,
                          (self.E, self.C, self.d))

    def combine(self, ob, top_e, pos_c, top_g, keep, cdt):
        n0, n1 = self.rows
        e, mine = self._mine(top_e)
        ob = redistribute(ob, Sharding(self.mesh, self.pe))
        ob_l = ob.to_local(grad_placements=self.buf_pl)
        y = _combine(ob_l, e, pos_c[n0:n1], self._local(top_g),
                     keep[n0:n1] & mine, cdt)
        return from_local(y, self.mesh, self.tok_pl, (self.N, self.d))
