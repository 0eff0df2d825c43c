"""A plain reference of the gate the ``dsv2_lite_moe`` designs route by.

DeepSeek-V2's gate (arXiv:2405.04434, §2.2) as DeepSeek-V2-Lite's
``config.json`` sets it (``scoring_func`` softmax, ``topk_method``
greedy, ``n_group`` 1 and ``topk_group`` 1, ``norm_topk_prob`` false,
``routed_scaling_factor`` 1), in plain ``torch``::

    s_{i,t} = Softmax_i(u_t^T e_i)
    g_{i,t} = s_{i,t} if s_{i,t} in TopK({s_{j,t}}, K_r) else 0

One departure: it computes in float64 by default, where the published
gate computes in float32, so that the design's numpy router and this
reference fall on the same side of every top-k boundary.  TF32 is
switched off, so a float32 product on a GPU is float32.

It imports nothing of the program and no JAX.
"""

from __future__ import annotations

from typing import Tuple

import torch


def moe_gate(states, gate, top_k: int, dtype: torch.dtype = torch.float64,
             device: str = "cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """``(ids, gates)`` of every token: ``ids`` ``(n_tokens, top_k)`` the
    chosen experts in index order, ``gates`` their softmax scores, not
    renormalised and scaled by 1; ``states`` ``(n_tokens, hidden)`` and
    the gate's weights ``gate`` ``(n_experts, hidden)``, computed in
    ``dtype`` on ``device``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    u = torch.as_tensor(states, dtype=dtype, device=device)
    w = torch.as_tensor(gate, dtype=dtype, device=device)
    scores = torch.softmax(u @ w.T, dim=-1)
    _, ids = torch.topk(scores, top_k, dim=-1)
    ids, _ = torch.sort(ids, dim=-1)
    return ids, torch.gather(scores, -1, ids)
