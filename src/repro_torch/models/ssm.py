"""Mamba-2 SSD block (state-space duality, chunked matmul form).

The chunked algorithm (Dao & Gu 2024) turns the linear recurrence

    h_t = a_t h_{t-1} + dt_t * B_t x_t^T ;   y_t = C_t h_t + D x_t

into matmul work: within chunks of length Q the output is an
attention-like (Q x Q) masked product; across chunks a short loop carries
the (H, head_dim, state) boundary states (the reference's ``lax.scan``).
As in the reference, a prompt longer than the chunk must be a multiple of
it.

Decode is the O(1) recurrence on the carried state; the conv1d keeps a
(d_conv-1)-deep rolling buffer.  Neither grows with context length.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.models.params import ParamSpec
from repro_torch.models.sharding import batch_local


def ssd_specs(cfg: ArchConfig) -> Dict[str, ParamSpec]:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.expand * d
    heads = d_in // s.head_dim
    conv_dim = d_in + 2 * s.d_state
    return {
        # projection to [z (gate), x, B, C, dt]
        "win": ParamSpec((d, 2 * d_in + 2 * s.d_state + heads),
                         ("embed", "ssm_inner")),
        "conv_w": ParamSpec((s.d_conv, conv_dim), ("conv", "ssm_inner"),
                            scale=0.1),
        "conv_b": ParamSpec((conv_dim,), ("ssm_inner",), init="zeros"),
        "a_log": ParamSpec((heads,), ("ssm_heads",), init="zeros"),
        "dt_bias": ParamSpec((heads,), ("ssm_heads",), init="zeros"),
        "dd": ParamSpec((heads,), ("ssm_heads",), init="ones"),
        "norm": ParamSpec((d_in,), ("ssm_inner",), init="ones"),
        "wout": ParamSpec((d_in, d), ("ssm_inner", "embed")),
    }


def _split(cfg: ArchConfig, zxbcdt: torch.Tensor):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    heads = d_in // s.head_dim
    z, xbc, dt = torch.split(
        zxbcdt, [d_in, d_in + 2 * s.d_state, heads], dim=-1)
    return z, xbc, dt, d_in, heads


@batch_local
def _ssd_chunked(xh, a, b, c, chunk: int):
    """xh (B,S,H,P) pre-scaled by dt; a (B,S,H) decay in (0,1);
    b/c (B,S,N).  Returns y (B,S,H,P) and final state (B,H,P,N)."""
    B, S, H, P = xh.shape
    N = b.shape[-1]
    if S % chunk:
        raise ValueError(f"SSD: a sequence of {S} tokens must be a "
                         f"multiple of the chunk {chunk}")
    nc = S // chunk
    xc = xh.reshape(B, nc, chunk, H, P)
    ac = a.reshape(B, nc, chunk, H)
    bc = b.reshape(B, nc, chunk, N)
    cc = c.reshape(B, nc, chunk, N)

    la = torch.cumsum(torch.log(torch.clamp(ac, min=1e-20)), dim=2)
    seg = la[:, :, :, None, :] - la[:, :, None, :, :]        # (B,nc,Q,K,H)
    iota = torch.arange(chunk, device=xh.device)
    causal = iota[:, None] >= iota[None, :]
    decay = torch.where(causal[None, None, :, :, None], torch.exp(seg),
                        torch.zeros((), dtype=seg.dtype, device=seg.device))

    # intra-chunk: (C_q . B_k) * decay(q,k) applied to x_k
    cb = torch.einsum("bnqs,bnks->bnqk", cc, bc)               # (B,nc,Q,K)
    y_intra = torch.einsum("bnqk,bnqkh,bnkhp->bnqhp",
                           cb, decay.to(cb.dtype), xc)

    # chunk-final states: sum_k decay_to_end(k) * b_k (x) x_k
    dte = torch.exp(la[:, :, -1:, :] - la)                     # (B,nc,Q,H)
    states = torch.einsum("bnkh,bnks,bnkhp->bnhps",
                          dte.to(xc.dtype), bc, xc)            # (B,nc,H,P,N)
    a_chunk = torch.exp(la[:, :, -1, :])                       # (B,nc,H)

    # the state ENTERING each chunk, carried chunk to chunk
    h = torch.zeros((B, H, P, N), dtype=xh.dtype, device=xh.device)
    h_in = []
    for n in range(nc):
        h_in.append(h)
        h = h * a_chunk[:, n, :, None, None].to(h.dtype) + states[:, n]
    h_in = torch.stack(h_in, dim=1)                            # (B,nc,H,P,N)

    # inter-chunk: y += C_q . (decay_from_start(q) * h_in)
    dfs = torch.exp(la)                                        # (B,nc,Q,H)
    y_inter = torch.einsum("bnqs,bnqh,bnhps->bnqhp",
                           cc, dfs.to(cc.dtype), h_in)
    y = (y_intra + y_inter).reshape(B, S, H, P)
    return y, h


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` as ``jax.nn.softplus`` computes it."""
    return torch.logaddexp(x, torch.zeros_like(x))


def ssd_block(
    p: Dict, cfg: ArchConfig, x: torch.Tensor,
    cache: Optional[Dict] = None,
    cache_index: Optional[int] = None,
    cdt=torch.bfloat16,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x (B,S,d) -> (y (B,S,d), new_cache).  cache = {"state","conv"}."""
    s = cfg.ssm
    B, S, _ = x.shape
    zxbcdt = x @ p["win"].to(cdt)
    z, xbc, dt, d_in, heads = _split(cfg, zxbcdt)

    conv_w = p["conv_w"].to(cdt)
    if cache is None:
        # causal depthwise conv over the sequence
        pad = F.pad(xbc, (0, 0, s.d_conv - 1, 0))
        xbc_c = sum(pad[:, i:i + S] * conv_w[i] for i in range(s.d_conv))
        new_conv = pad[:, -(s.d_conv - 1):, :]   # rolling buffer for decode
    else:
        roll = torch.cat([cache["conv"].to(cdt), xbc], dim=1)
        xbc_c = sum(roll[:, i + S - 1:i + S] * conv_w[i]
                    for i in range(s.d_conv))
        new_conv = roll[:, -(s.d_conv - 1):, :]
    xbc_c = F.silu(xbc_c + p["conv_b"].to(cdt))

    xs, b, c = torch.split(xbc_c, [d_in, s.d_state, s.d_state], dim=-1)
    xs = xs.reshape(B, -1, heads, s.head_dim)
    dt_v = _softplus(dt.float() + p["dt_bias"].float())
    a = torch.exp(-dt_v * torch.exp(p["a_log"].float()))
    xh = xs * dt_v.to(cdt)[..., None]

    if cache is None:
        y, h_last = _ssd_chunked(xh, a, b, c, min(s.chunk, S))
        new_state = h_last
    else:
        h = cache["state"].to(cdt)
        h = h * a.to(cdt)[:, 0, :, None, None] + torch.einsum(
            "bhp,bn->bhpn", xh[:, 0], b[:, 0])
        y = torch.einsum("bn,bhpn->bhp", c[:, 0], h)[:, None]
        new_state = h

    y = y + xs * p["dd"].to(cdt)[None, None, :, None]
    y = y.reshape(B, S, d_in) * F.silu(z)
    # RMS-style gate norm
    var = torch.mean(torch.square(y.float()), dim=-1, keepdim=True)
    y = (y.float() * torch.rsqrt(var + 1e-6)).to(cdt)
    y = y * p["norm"].to(cdt)
    out = y @ p["wout"].to(cdt)
    new_cache = {"state": new_state.float(), "conv": new_conv.float()}
    return out, new_cache
