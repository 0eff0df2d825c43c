"""Mixture-of-Experts FFN with capacity-based dispatch (GShard-style).

Top-k routing with per-expert capacity ``C = min(max(8, ceil(cf * N * k /
E)), N)``; overflow tokens are dropped, underflow slots stay zero.  Shared
experts (DeepSeek-V2) are plain dense FFNs added to the routed output.

Two choices keep this equal to the reference on the same inputs:

* the top-k is a stable descending sort, so tied gates pick the lower
  expert index first, as ``lax.top_k`` does;
* every kept (token, slot) owns a distinct ``(expert, position)`` buffer
  slot, so the dispatch is an index assignment of the kept rows — no
  scatter-add, whose order on CUDA is not fixed.  The reference's
  scatter-add adds only zeros beyond those rows (dropped tokens masked to
  zero at position ``C - 1``), so both give the same buffer.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import mlp, mlp_specs
from repro_torch.models.params import ParamSpec
from repro_torch.models.sharding import constrain


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

    xf = x.reshape(N, d)
    logits = (xf @ p["router"].to(cdt)).float()
    gates_all = torch.softmax(logits, dim=-1)
    top_g, top_e = torch.sort(gates_all, dim=-1, descending=True,
                              stable=True)
    top_g, top_e = top_g[:, :K], top_e[:, :K]                # (N, K)
    top_g = top_g / torch.clamp(top_g.sum(-1, keepdim=True), min=1e-9)

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

    # dispatch: every kept (token, slot) into its own (E, C, d) slot
    buf = torch.zeros((E, C, d), dtype=cdt, device=x.device)
    for j in range(K):
        kj = keep[:, j]
        buf[top_e[kj, j], pos_c[kj, j]] = xf[kj].to(cdt)
    buf = constrain(buf, "experts", "capacity", None)

    # expert computation (batched over the expert axis)
    g = torch.bmm(buf, p["gate"].to(cdt))
    u = torch.bmm(buf, p["up"].to(cdt))
    h = F.silu(g) * u
    h = constrain(h, "experts", "capacity", None)
    ob = torch.bmm(h, p["down"].to(cdt))
    ob = constrain(ob, "experts", "capacity", None)

    # combine: gather each token's expert outputs, weight by gates
    y = torch.zeros((N, d), dtype=cdt, device=x.device)
    for j in range(K):
        o = ob[top_e[:, j], pos_c[:, j]]
        w = (top_g[:, j] * keep[:, j]).to(cdt)
        y = y + o * w[:, None]

    y = y.reshape(B, S, d)
    for i in range(mo.n_shared):
        y = y + mlp(p[f"shared{i}"], x, cdt)   # shared experts: dense path
    return y
