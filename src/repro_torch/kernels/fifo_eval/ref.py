"""Plain torch versions of the two fifo_eval kernels.

``fifo_eval_plain``            what ``fifo_eval.cu`` computes (and the
                               ``fixpoint`` backend's fixpoint)
``fifo_eval_ref_hetero``       what ``fifo_eval.cu`` computes in its
                               per-design-table mode: every operand per
                               row, a per-row bound (cross-design batches)
``fifo_eval_condensed_plain``  what ``condensed.cu`` computes: the same
                               fixpoint with per-row freezing, then the
                               fused exactness certificate

Both run on any device with stock torch ops: a batched Jacobi step (two
gathers of the previous iterate), then the inclusive segmented max-plus
scan by Hillis-Steele doubling.  Every time is an integer held in float32
below 2**24, so the results are bit-identical to the CUDA kernels whatever
order the scan associates in (see the ``NEG`` note in ``fifo_step.cuh``).
The CPU tests hold these against the reference package; ``chip_smoke.py``
holds the kernels against these on the card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG = -1e9


def _seg_scan(a: torch.Tensor, m: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of ``(a, m)`` pairs under the max-plus combine
    ``(a1, m1) . (a2, m2) = (a1 + a2, max(m1 + a2, m2))`` along dim 1,
    with the pad identity ``(0, NEG)``."""
    n = a.shape[1]
    sh = 1
    while sh < n:
        a_prev = torch.nn.functional.pad(a[:, :-sh], (sh, 0), value=0.0)
        m_prev = torch.nn.functional.pad(m[:, :-sh], (sh, 0), value=NEG)
        m = torch.maximum(m_prev + a, m)
        a = a_prev + a
        sh <<= 1
    return a, m


def _step(t, a_base, delta, segst, is_read, has_data, data_idx,
          rd_lat, bp_idx, bp_valid, bp_base):
    """One Jacobi step for the rows of ``t`` (both gathers read the
    previous iterate)."""
    C = t.shape[0]
    neg = torch.tensor(NEG, dtype=t.dtype, device=t.device)
    td = torch.gather(t, 1, data_idx.long().expand(C, -1))
    bd = torch.where(has_data > 0, td + rd_lat, neg)
    tb = torch.gather(t, 1, bp_idx.long())
    bb = torch.where(bp_valid > 0, tb + bp_base, neg)
    b = torch.where(is_read > 0, bd, bb)
    m = torch.where(segst > 0, torch.maximum(b, delta), b)
    A, M = _seg_scan(a_base.expand(C, -1), m)
    return torch.maximum(A, M)


def fifo_eval_plain(delta, segst, is_read, has_data, data_idx, end_bonus,
                    rd_lat, bp_idx, bp_valid, bp_base, *, max_iters: int,
                    bound: float, with_times: bool = False
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Shared operands (1, E_pad), per-row operands (C, E_pad).  Returns
    (C, 4) f32 rows ``[latency, converged, over_bound, iters]`` and, with
    ``with_times``, the final (C, E_pad) times (else None).

    Stop rule per row (the reference's ``fifo_eval.py:95-106``): one step
    from zeros with ``iters = 1``, then step while not converged,
    ``iters < max_iters`` and ``max(t) <= bound`` (checked BEFORE each
    step); converged means the step left ``t`` unchanged."""
    C, E = rd_lat.shape
    dev = rd_lat.device
    bound = torch.tensor(bound, dtype=torch.float32, device=dev)
    a_base = torch.where(segst > 0, torch.tensor(NEG, device=dev), delta)
    args = (a_base, delta, segst, is_read, has_data, data_idx)
    t = _step(torch.zeros((C, E), dtype=torch.float32, device=dev),
              *args, rd_lat, bp_idx, bp_valid, bp_base)
    iters = torch.ones(C, dtype=torch.int32, device=dev)
    conv = torch.zeros(C, dtype=torch.bool, device=dev)
    while True:
        active = ~conv & (iters < max_iters) & (t.amax(dim=1) <= bound)
        rows = torch.nonzero(active).flatten()
        if rows.numel() == 0:
            break
        t_old = t[rows]
        t_new = _step(t_old, *args, rd_lat[rows], bp_idx[rows],
                      bp_valid[rows], bp_base[rows])
        t[rows] = t_new
        iters[rows] += 1
        conv[rows] = (t_new == t_old).all(dim=1)
    latency = (t + end_bonus).amax(dim=1)
    over = t.amax(dim=1) > bound
    out = torch.stack([latency, conv.float(), over.float(), iters.float()],
                      dim=1)
    return out, (t if with_times else None)


def fifo_eval_ref_hetero(delta, segst, is_read, has_data, data_idx,
                         end_bonus, rd_lat, bp_idx, bp_valid, bound, *,
                         max_iters: int, with_times: bool = False
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Cross-design variant of :func:`fifo_eval_plain` (the reference's
    ``fifo_eval_ref_hetero``): every operand is per row, (C, E*) — each
    row may come from a different graph padded to a shared envelope —
    the deadlock bound is a (C,) f32 tensor, and the back-pressure add is
    the raw stream's literal 1.  Returns (C, 4) f32 rows ``[latency,
    converged, over_bound, iters]`` and, with ``with_times``, the final
    times.  Same stop rule as :func:`fifo_eval_plain`, per row."""
    C, E = rd_lat.shape
    dev = rd_lat.device
    bound = bound.to(torch.float32)
    a_base = torch.where(segst > 0, torch.tensor(NEG, device=dev), delta)
    bp_base = torch.ones_like(rd_lat)
    per_row = (a_base, delta, segst, is_read, has_data, data_idx, rd_lat,
               bp_idx, bp_valid, bp_base)
    t = _step(torch.zeros((C, E), dtype=torch.float32, device=dev),
              *per_row)
    iters = torch.ones(C, dtype=torch.int32, device=dev)
    conv = torch.zeros(C, dtype=torch.bool, device=dev)
    while True:
        active = ~conv & (iters < max_iters) & (t.amax(dim=1) <= bound)
        rows = torch.nonzero(active).flatten()
        if rows.numel() == 0:
            break
        t_old = t[rows]
        t_new = _step(t_old, *(x[rows] for x in per_row))
        t[rows] = t_new
        iters[rows] += 1
        conv[rows] = (t_new == t_old).all(dim=1)
    latency = (t + end_bonus).amax(dim=1)
    over = t.amax(dim=1) > bound
    out = torch.stack([latency, conv.float(), over.float(), iters.float()],
                      dim=1)
    return out, (t if with_times else None)


def fifo_eval_condensed_plain(delta, segst, is_read, has_data, data_idx,
                              end_bonus, rd_lat, bp_idx, bp_valid, bp_base,
                              cert_src, cert_dst, cert_thr, cert_valid, *,
                              max_iters: int, bound: float,
                              with_times: bool = False
                              ) -> Tuple[torch.Tensor,
                                         Optional[torch.Tensor]]:
    """The fused condensed evaluation: per-row operands (C, E_pad),
    certificate slots (C, V_pad).  Returns (C, 5) f32 rows ``[latency,
    converged, over_bound, iters, certified]`` (plus the times).

    Stop rule per row (the reference's ``condensed.py:125-142``): one
    step from zeros, then step while the row is active (not converged,
    not over the bound) and ``iters < max_iters``; ``over`` is checked
    AFTER each step.  ``iters`` counts the steps the row took while
    active: one CUDA block evaluates one row, so this is that block's
    loop count (lane 3 of the reference counts its whole row block's
    loop, which nothing reads)."""
    C, E = rd_lat.shape
    dev = rd_lat.device
    bound = torch.tensor(bound, dtype=torch.float32, device=dev)
    a_base = torch.where(segst > 0, torch.tensor(NEG, device=dev), delta)
    args = (a_base, delta, segst, is_read, has_data, data_idx)
    t0 = torch.zeros((C, E), dtype=torch.float32, device=dev)
    t = _step(t0, *args, rd_lat, bp_idx, bp_valid, bp_base)
    conv = (t == t0).all(dim=1)
    over = t.amax(dim=1) > bound
    iters = torch.ones(C, dtype=torch.int32, device=dev)
    it = 1
    while it < max_iters:
        rows = torch.nonzero(~conv & ~over).flatten()
        if rows.numel() == 0:
            break
        t_old = t[rows]
        t_new = _step(t_old, *args, rd_lat[rows], bp_idx[rows],
                      bp_valid[rows], bp_base[rows])
        t[rows] = t_new
        iters[rows] += 1
        conv[rows] = (t_new == t_old).all(dim=1)
        over[rows] = t_new.amax(dim=1) > bound
        it += 1
    ts = torch.gather(t, 1, cert_src.long())
    td = torch.gather(t, 1, cert_dst.long())
    viol = (cert_valid > 0) & (ts - td > cert_thr)
    cert = conv & ~over & ~viol.any(dim=1)
    latency = (t + end_bonus).amax(dim=1)
    out = torch.stack([latency, conv.float(), over.float(), iters.float(),
                       cert.float()], dim=1)
    return out, (t if with_times else None)
