"""A plain reference of the PNA layer the ``flowgnn_pna`` designs compute.

One layer of PNA (Corso et al., arXiv:2004.05718) on node embeddings, in
plain ``torch`` on the CPU: the messages are the source embeddings (no
pre-transform), four aggregators (mean, max, min, std) over each node's
incoming edges, elementwise, three degree scalers (identity,
amplification ``log(d+1)/delta``, attenuation ``delta/log(d+1)``, the
degree clamped to at least 1 as in PyTorch Geometric's ``PNAConv``,
``delta`` the mean ``log(d+1)`` over the graph's nodes), and one linear
map of the self embedding and the 12 scaled aggregates in place of the
update MLP.  A node without incoming edges aggregates to 0 under every
aggregator.

It imports nothing of the program and no JAX.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

#: PNA's std adds this under its square root
STD_EPS = 1e-5


def pna_layer(n_nodes: int, edges: Sequence[Tuple[int, int]], x, weights,
              dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Per-node outputs, shape ``(n_nodes, dim_out)``, of the layer over
    directed ``edges`` ``(src, dst)``, embeddings ``x`` ``(n_nodes, dim)``
    and ``weights`` ``(13 * dim, dim_out)``: rows of the self embedding,
    then of each aggregator under each scaler, aggregators in the order
    mean, max, min, std and scalers in the order identity, amplification,
    attenuation; computed in ``dtype``."""
    x = torch.as_tensor(x, dtype=dtype)
    w = torch.as_tensor(weights, dtype=dtype)
    e = torch.as_tensor(list(edges), dtype=torch.long).reshape(-1, 2)
    src, dst = e[:, 0], e[:, 1]
    msg = x[src]
    at = dst[:, None].expand_as(msg)
    zeros = torch.zeros(n_nodes, x.shape[1], dtype=dtype)
    deg = torch.zeros(n_nodes, dtype=dtype).index_add_(
        0, dst, torch.ones(len(dst), dtype=dtype))
    has = (deg > 0)[:, None]
    d = deg.clamp(min=1)[:, None]
    mean = zeros.index_add(0, dst, msg) / d
    mx = zeros.scatter_reduce(0, at, msg, "amax", include_self=False)
    mn = zeros.scatter_reduce(0, at, msg, "amin", include_self=False)
    var = zeros.index_add(0, dst, msg * msg) / d - mean * mean
    std = torch.sqrt(torch.relu(var) + STD_EPS)
    std = torch.where(has, std, torch.zeros_like(std))
    log_d = torch.log(d + 1)
    delta = torch.log(deg + 1).mean()
    scalers = (torch.ones_like(log_d), log_d / delta, delta / log_d)
    feats = [x] + [a * sc for a in (mean, mx, mn, std) for sc in scalers]
    return torch.cat(feats, dim=1) @ w
