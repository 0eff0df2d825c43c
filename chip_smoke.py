#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of FIFOAdvisor (``src/repro_torch``) on one
NVIDIA GPU and check it.

    python3 chip_smoke.py                 # the full check (one card)
    python3 chip_smoke.py --out FILE      # also write every line to FILE

Phases, each printing JSON lines (any failure raises and exits nonzero):

1. the card: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. the build: both CUDA kernels compiled with nvcc from ``src/repro_torch/
   csrc`` (seconds, registers and spills from ptxas);
3. each kernel against its plain torch version on the card at the main
   path's shapes: K2 on the raw streams of gemm, FeedForward and
   k15mmtree and on the rungs it serves (both rungs of ResidualBlock, the
   safe rungs of gemm, FeedForward and k15mmtree), on rows inside the
   routing box and rows below its floor; K1 on the aggressive rungs of
   gemm, FeedForward, k15mmseq and k15mmtree; at batches 1, 8, 37 and
   512, with and without times, at max_iters 256 and 2 — every output
   lane and time bit-identical; K2 at the cluster size its chooser picks
   and at every size it allows for the stream (forced through the
   wrapper's ``cluster`` keyword), K1 at the shape its chooser picks and
   at every shape it allows (``shape`` keyword); K1's certificate equal
   to the host ``verify_rows`` on converged rows;
4. the main path: ``FifoAdvisor(design, EvalConfig(backend="cuda")).run(
   "grouped_sa", budget=1000, seed=0)`` on gemm, FeedForward and
   k15mmtree, whose history, frontier and hypervolume must equal the
   numpy backend's, and ``BatchedEvaluator`` on ResidualBlock against
   numpy on 256 random rows, and its rung counts (``n_condensed``,
   ``n_cond_fail``, ``n_fallbacks``) against the plain ``fixpoint``
   backend's on the card; every launch counter is set to 0 just before
   and read just after, and both kernels must have launched (K2's
   launches also by cluster size, K1's by rows per launch);
5. times: each kernel and its plain version, warm, beside the bound (the
   larger of bytes over 3.35 TB/s and float32 operations over 67
   TFLOP/s).  K2 with CUDA events at the 512-row bucket per design (also
   on ResidualBlock's aggressive rung, with times) and at the main path's
   shape: 8 rows below the box's floor on FeedForward and k15mmtree, with
   the time per iteration of the slowest row, the chosen cluster and how
   many clusters of each allowed size the card holds at once.  K1 as a
   CUDA graph of 20 launches (no host overhead) at the main path's 1 and
   8 rows and at the 512-row bucket, each also at max_iters 1 (the
   difference is the iterations after the first);
6. where the main path's time goes: each design's ``grouped_sa`` run
   again under ``torch.profiler`` (wall, device busy time, idle share);

then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout of the repository, it exits nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

#: published peaks of one H100 SXM (data sheet; dense, no sparsity)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
#: float32 operations per event per fixpoint iteration: the edge add, the
#: max with delta, the scan combine (two adds and a max) and max(A, M)
OPS_PER_EVENT_ITER = 6
#: per certificate slot: the difference and the comparison
OPS_PER_CERT_SLOT = 2

K2_DESIGNS = ("gemm", "FeedForward", "k15mmtree")
#: the rungs below FUSED_MIN_COMPRESSION that K2 serves with times
K2_RUNGS = (("ResidualBlock", "aggressive"), ("ResidualBlock", "safe"),
            ("gemm", "safe"), ("FeedForward", "safe"), ("k15mmtree", "safe"))
K1_DESIGNS = ("gemm", "FeedForward", "k15mmseq", "k15mmtree")
MAIN_DESIGNS = ("gemm", "FeedForward", "k15mmtree")
BATCHES = (1, 8, 37, 512)
#: the main path's K2 shape: grouped_sa's batches of at most 8 rows,
#: padded to the 8-row bucket, mostly below the routing box's floor
MAIN_ROWS = 8
MAIN_SHAPE_DESIGNS = ("FeedForward", "k15mmtree")
#: the main path's K1 batches: rows inside the routing box, padded to the
#: 1- and 8-row buckets
K1_MAIN_ROWS = (1, 8)
#: launches per CUDA graph when a kernel is timed without host overhead
GRAPH_REPS = 20
BUDGET = 1000

_out_file = None


def emit(obj) -> None:
    line = json.dumps(obj) if not isinstance(obj, str) else obj
    print(line, flush=True)
    if _out_file is not None:
        _out_file.write(line + "\n")
        _out_file.flush()


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ inputs
def box_rows(g, c: int, seed: int):
    """``c`` depth rows from ``np.random.default_rng(seed)``: rows inside
    the routing box [floor, u] (floor = u // 2, as condensation uses),
    then the all-ones row (deadlock) and the upper-bound row."""
    import numpy as np
    rng = np.random.default_rng(seed)
    u = np.asarray(g.upper_bounds, dtype=np.int64)
    floor = np.maximum(1, u // 2)
    rows = [rng.integers(floor, u + 1) for _ in range(max(c - 2, 1))]
    if c >= 3:
        rows += [np.ones_like(u), u.copy()]
    return np.stack(rows)[:c].astype(np.int32)


def low_rows(g, c: int, seed: int):
    """``c`` depth rows from ``np.random.default_rng(seed)`` below the
    routing box's floor, in [1, max(1, u // 2)]: where most of
    ``grouped_sa``'s rows fall, and so what the raw K2 backstop runs."""
    import numpy as np
    rng = np.random.default_rng(seed)
    u = np.asarray(g.upper_bounds, dtype=np.int64)
    return rng.integers(1, np.maximum(1, u // 2) + 1,
                        size=(c, u.size)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def raw_graph(name: str):
    from repro_torch.core.simgraph import build_simgraph
    from repro_torch.designs import make_design
    return build_simgraph(make_design(name))


@functools.lru_cache(maxsize=None)
def rung(name: str, tag: str):
    """The ``tag`` rung of ``condense_auto`` on design ``name``."""
    from repro_torch.core.condense import condense_auto
    for cg in condense_auto(raw_graph(name)):
        if cg.tag == tag:
            return cg
    raise AssertionError(f"{name} has no {tag} rung")


def kernel_args(graph, rows, dev, cert: bool):
    """The kernels' operand tuples for ``rows`` on ``dev``, plus the
    structural-deadlock flags and the bound."""
    import torch
    from repro_torch.core.backends import operands as O
    ops = O.get_operands(graph, dev)
    d = torch.as_tensor(rows, device=dev)
    rd, bpi, bpv, bpb, structural = O.depth_operands(ops, d)
    args = (ops.delta, ops.seg_start, ops.is_read, ops.has_data,
            ops.data_idx, ops.end_bonus, rd, bpi, bpv, bpb)
    if cert:
        ct = O.get_cert_tables(graph, dev)
        args = args + O.cert_row_operands(ops, ct, d)
    return args, structural, ops.bound


# ------------------------------------------------------------------ checks
class Compare:
    """Collects the largest |kernel - plain| seen per kernel."""

    def __init__(self):
        self.err = {}

    def same(self, name: str, what: str, a, b) -> None:
        import torch
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{name} {what}: {a.shape}/{a.dtype} vs "
                                 f"{b.shape}/{b.dtype}")
        diff = float((a.double() - b.double()).abs().max()) if a.numel() \
            else 0.0
        self.err[name] = max(self.err.get(name, 0.0), diff)
        if not torch.equal(a, b):
            raise AssertionError(f"{name} {what}: kernel and plain version "
                                 f"differ (max abs err {diff})")


def k2_streams():
    """(label, graph) of every stream K2 runs on the main path: the raw
    streams (the backstop), and the rungs below FUSED_MIN_COMPRESSION,
    which go through K2 with times and the host ``verify_rows``."""
    out = [(name, raw_graph(name)) for name in K2_DESIGNS]
    out += [(f"{name}/{tag}", rung(name, tag)) for name, tag in K2_RUNGS]
    return out


def max_cluster(dev) -> int:
    """The largest cluster K2 can launch on ``dev`` (8 or 16)."""
    from repro_torch.kernels.fifo_eval import fifo_eval
    return fifo_eval.max_cluster(dev.index or 0)


def k2_active(dev, e_pad: int) -> dict:
    """{cluster size: clusters resident at once} for a row of ``e_pad``
    events at every size K2 allows: the rows one wave holds, which bounds
    how far the chooser spreads."""
    from repro_torch.kernels.fifo_eval import fifo_eval as k2
    return {s: k2.active_clusters(dev.index or 0, s,
                                  *k2.k2_cta_shape(e_pad, s))
            for s in k2.k2_cluster_sizes(e_pad, max_cluster(dev))}


def check_k2(dev, cmp: Compare) -> None:
    """K2 at the cluster size the chooser picks and at every size it
    allows (forced through the wrapper's ``cluster`` keyword), against
    one plain run per case."""
    import torch
    from repro_torch.kernels.fifo_eval.fifo_eval import (fifo_eval,
                                                         k2_cluster_sizes,
                                                         launch_shape)
    from repro_torch.kernels.fifo_eval.ref import fifo_eval_plain
    for label, g in k2_streams():
        for c in BATCHES:
            for rows_of in (box_rows, low_rows):
                args, _, bound = kernel_args(g, rows_of(g, c, seed=0), dev,
                                             cert=False)
                e_pad = int(args[6].shape[1])
                chosen = launch_shape(c, e_pad, dev)[0]
                sizes = k2_cluster_sizes(e_pad, max_cluster(dev))
                for max_iters in (256, 2):
                    for with_times in (False, True):
                        p_out, p_t = fifo_eval_plain(
                            *args, max_iters=max_iters, bound=bound,
                            with_times=with_times)
                        for cluster in (None,) + sizes:
                            out, t = fifo_eval(*args, max_iters=max_iters,
                                               bound=bound,
                                               with_times=with_times,
                                               cluster=cluster)
                            torch.cuda.synchronize()
                            what = (f"{label} {rows_of.__name__} C={c} "
                                    f"iters={max_iters} t={with_times} "
                                    f"cluster={cluster or chosen}")
                            cmp.same("fifo_eval", what, out, p_out)
                            if with_times:
                                cmp.same("fifo_eval", what + " times", t,
                                         p_t)
                        emit({"phase": "check", "kernel": "fifo_eval",
                              "stream": label, "rows_of": rows_of.__name__,
                              "e_pad": e_pad, "rows": c,
                              "max_iters": max_iters,
                              "with_times": with_times,
                              "clusters": list(sizes), "chosen": chosen,
                              "active": k2_active(dev, e_pad),
                              "equal": True,
                              "converged": int((out[:, 1] > 0).sum()),
                              "over": int((out[:, 2] > 0).sum()),
                              "max_iters_run": int(out[:, 3].max())})


def check_k1(dev, cmp: Compare) -> None:
    """K1 at the shape its chooser picks and at every shape it allows
    (forced through the wrapper's ``shape`` keyword), against one plain
    run per case; its certificate against the host ``verify_rows``."""
    import numpy as np
    import torch
    from repro_torch.core.backends.base import CONVERGED
    from repro_torch.core.condense import verify_rows
    from repro_torch.kernels.fifo_eval.condensed import (fifo_eval_condensed,
                                                         k1_shapes,
                                                         launch_shape)
    from repro_torch.kernels.fifo_eval.ops import _status
    from repro_torch.kernels.fifo_eval.ref import fifo_eval_condensed_plain
    for name in K1_DESIGNS:
        cg = rung(name, "aggressive")
        for c in BATCHES:
            rows = box_rows(cg, c, seed=0)
            args, structural, bound = kernel_args(cg, rows, dev, cert=True)
            e_pad, v_pad = int(args[6].shape[1]), int(args[10].shape[1])
            chosen = launch_shape(c, e_pad, v_pad, dev)
            shapes = k1_shapes(e_pad, v_pad)
            for max_iters in (256, 2):
                for with_times in (False, True):
                    p_out, p_t = fifo_eval_condensed_plain(
                        *args, max_iters=max_iters, bound=bound,
                        with_times=with_times)
                    for shape in (None,) + shapes:
                        out, t = fifo_eval_condensed(
                            *args, max_iters=max_iters, bound=bound,
                            with_times=with_times, shape=shape)
                        torch.cuda.synchronize()
                        what = (f"{name} C={c} iters={max_iters} "
                                f"t={with_times} shape={shape or chosen}")
                        cmp.same("fifo_eval_condensed", what, out, p_out)
                        if with_times:
                            cmp.same("fifo_eval_condensed", what + " times",
                                     t, p_t)
                    n_cert = int((p_out[:, 4] > 0).sum())
                    if with_times:
                        status = _status(p_out, structural).cpu().numpy()
                        cert = ((p_out[:, 4] > 0).cpu().numpy()
                                & (status == CONVERGED))
                        conv = status == CONVERGED
                        want = np.zeros(c, dtype=bool)
                        if conv.any():
                            times = np.rint(p_t.cpu().numpy()).astype(
                                np.int64)
                            want[conv] = verify_rows(
                                cg, rows[conv].astype(np.int64), times[conv])
                        if not np.array_equal(cert, want):
                            raise AssertionError(
                                f"fifo_eval_condensed {name} C={c} iters="
                                f"{max_iters}: certificate differs from "
                                f"verify_rows")
                    emit({"phase": "check", "kernel": "fifo_eval_condensed",
                          "design": name, "e_pad": e_pad, "v_pad": v_pad,
                          "rows": c, "max_iters": max_iters,
                          "with_times": with_times, "chosen": list(chosen),
                          "shapes": len(shapes), "equal": True,
                          "certified": n_cert,
                          "converged": int((p_out[:, 1] > 0).sum()),
                          "max_iters_run": int(p_out[:, 3].max())})


# --------------------------------------------------------------- main path
def reset_counts():
    from repro_torch.kernels.fifo_eval import condensed, fifo_eval, ops
    fifo_eval.fifo_eval.launches = 0
    fifo_eval.fifo_eval.clusters = {}
    condensed.fifo_eval_condensed.launches = 0
    condensed.fifo_eval_condensed.rows = {}
    ops.DISPATCH_COUNTS.clear()


def read_counts() -> dict:
    from repro_torch.kernels.fifo_eval import condensed, fifo_eval, ops
    return {"fifo_eval": fifo_eval.fifo_eval.launches,
            "fifo_eval_clusters": dict(fifo_eval.fifo_eval.clusters),
            "fifo_eval_condensed":
                condensed.fifo_eval_condensed.launches,
            "fifo_eval_condensed_rows":
                dict(condensed.fifo_eval_condensed.rows),
            "dispatch": dict(ops.DISPATCH_COUNTS)}


def main_path(dev) -> dict:
    import numpy as np
    import torch
    from repro_torch.core import BatchedEvaluator, EvalConfig, FifoAdvisor
    from repro_torch.core.simgraph import build_simgraph
    from repro_torch.designs import make_design
    totals = {"fifo_eval": 0, "fifo_eval_condensed": 0}
    k1_rows = {}
    for name in MAIN_DESIGNS:
        reset_counts()
        t0 = time.perf_counter()
        adv = FifoAdvisor(make_design(name), EvalConfig(backend="cuda"))
        res = adv.run("grouped_sa", budget=BUDGET, seed=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        for k in totals:
            totals[k] += counts[k]
        for c, n in counts["fifo_eval_condensed_rows"].items():
            k1_rows.setdefault(name, {})[c] = n
        t1 = time.perf_counter()
        ref = FifoAdvisor(make_design(name), EvalConfig(backend="numpy")
                          ).run("grouped_sa", budget=BUDGET, seed=0)
        ref_wall = time.perf_counter() - t1
        for k in ("configs", "latency", "bram", "deadlock"):
            if not np.array_equal(getattr(res.result, k),
                                  getattr(ref.result, k)):
                raise AssertionError(f"main path {name}: history {k} "
                                     f"differs from the numpy backend")
        if not np.array_equal(res.frontier_points, ref.frontier_points) \
                or res.hypervolume() != ref.hypervolume():
            raise AssertionError(f"main path {name}: frontier differs "
                                 f"from the numpy backend")
        st = adv.evaluator.stats
        emit({"phase": "main_path", "design": name, "optimizer":
              "grouped_sa", "budget": BUDGET, "evals": res.result.n_evals,
              "rows_evaluated": st.n_configs, "wall_s": round(wall, 3),
              "evals_per_s": round(res.result.n_evals / wall, 2),
              "numpy_wall_s": round(ref_wall, 3),
              "frontier_points": res.frontier_points.tolist(),
              "hypervolume": res.hypervolume(),
              "equal_to_numpy": True,
              "launches": {k: counts[k] for k in
                           ("fifo_eval", "fifo_eval_condensed")},
              "fifo_eval_launches_by_cluster":
                  counts["fifo_eval_clusters"],
              "fifo_eval_condensed_launches_by_rows":
                  counts["fifo_eval_condensed_rows"],
              "dispatch": counts["dispatch"],
              "n_condensed": st.n_condensed,
              "n_cond_fail": st.n_cond_fail,
              "n_fallbacks": st.n_fallbacks,
              "rungs": adv.evaluator.condensation_info()})

    # ResidualBlock: aggressive rung below 8x, so no fused K1 — covers
    # K2's with_times path and the host verifier
    reset_counts()
    g = build_simgraph(make_design("ResidualBlock"))
    rng = np.random.default_rng(0)
    u = np.asarray(g.upper_bounds, dtype=np.int64)
    rows = np.stack([rng.integers(1, u + 1) for _ in range(128)]
                    + [np.maximum(1, (u * rng.uniform(0.5, 1.0, u.size))
                                  .astype(np.int64)) for _ in range(128)])
    t0 = time.perf_counter()
    ev = BatchedEvaluator(g, EvalConfig(backend="cuda"))
    got = ev.evaluate(rows)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    for k in totals:
        totals[k] += counts[k]
    want = BatchedEvaluator(g, EvalConfig(backend="numpy")).evaluate(rows)
    for a, b in zip(got, want):
        if not np.array_equal(a, b):
            raise AssertionError("ResidualBlock: cuda evaluator differs "
                                 "from numpy")
    # the rung counts: a K2 that returned wrong times on a rung would have
    # its rows rejected by verify_rows and re-solved on the raw stream, so
    # the results above would still agree; the counts would not
    st = ev.stats
    fx = BatchedEvaluator(g, EvalConfig(backend="fixpoint"))
    for a, b in zip(fx.evaluate(rows), want):
        if not np.array_equal(a, b):
            raise AssertionError("ResidualBlock: fixpoint evaluator "
                                 "differs from numpy")
    for k in ("n_condensed", "n_cond_fail", "n_fallbacks"):
        if getattr(st, k) != getattr(fx.stats, k):
            raise AssertionError(f"ResidualBlock: {k} {getattr(st, k)} on "
                                 f"cuda, {getattr(fx.stats, k)} on fixpoint")
    if st.n_condensed == 0:
        raise AssertionError("ResidualBlock: no row resolved on a rung")
    emit({"phase": "main_path", "design": "ResidualBlock",
          "entry": "BatchedEvaluator", "rows": int(rows.shape[0]),
          "wall_s": round(wall, 3), "equal_to_numpy": True,
          "launches": {k: counts[k] for k in
                       ("fifo_eval", "fifo_eval_condensed")},
          "fifo_eval_launches_by_cluster": counts["fifo_eval_clusters"],
          "fifo_eval_condensed_launches_by_rows":
              counts["fifo_eval_condensed_rows"],
          "dispatch": counts["dispatch"], "n_condensed": st.n_condensed,
          "n_cond_fail": st.n_cond_fail, "n_fallbacks": st.n_fallbacks,
          "counts_equal_to_fixpoint": True,
          "rungs": ev.condensation_info()})
    for k, n in totals.items():
        if n == 0:
            raise AssertionError(f"main path never launched {k}")
    emit({"phase": "main_path_launches", **totals,
          "fifo_eval_condensed_rows_by_design": k1_rows})
    return totals, k1_rows


# ------------------------------------------------------------------ timing
def cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = GRAPH_REPS) -> float:
    """Device time of one call of ``fn`` (kernel launches on the current
    stream): ``reps`` calls captured in one CUDA graph, replayed and timed
    with CUDA events, so that the host's launch overhead is not counted."""
    import torch
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    torch.cuda.synchronize()
    return cuda_ms(g.replay, reps=3) / reps


def bound_ms(args, out, times=None, cert_slots: int = 0):
    """(bound_ms, bound_by): bytes of every input read once and every
    output (``out``, and ``times`` when asked for) written once over the
    memory rate, against the float32 operations of the iterations the
    rows actually ran over the peak."""
    n_bytes = sum(a.numel() * a.element_size() for a in args)
    for o in (out, times):
        if o is not None:
            n_bytes += o.numel() * o.element_size()
    e_pad = args[6].shape[1]
    iters = float(out[:, 3].sum())
    ops = iters * e_pad * OPS_PER_EVENT_ITER
    ops += cert_slots * OPS_PER_CERT_SLOT
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def profile_main_path() -> None:
    """Where the main path's time goes: one fresh ``grouped_sa`` run per
    design (trace, condensation and search) under ``torch.profiler``;
    device busy time is the sum of the device-side activities it records
    (kernels and copies)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import EvalConfig, FifoAdvisor
    from repro_torch.designs import make_design
    for name in MAIN_DESIGNS:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            FifoAdvisor(make_design(name), EvalConfig(backend="cuda")
                        ).run("grouped_sa", budget=BUDGET, seed=0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # device-side entries only: an aten op's own entry also carries
        # the time of the kernels it launched
        by_name = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0) or 0
            if us > 0 and e.device_type == DeviceType.CUDA:
                by_name[e.key] = by_name.get(e.key, 0) + us
        busy = sum(by_name.values()) / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        # a trace with no device activity is a gap of the profiler, not of
        # the path (the launch counters of phase 4 show the kernels ran)
        emit({"phase": "profile", "design": name, "wall_s": wall,
              "device_busy_s": busy if busy > 0 else "not measured",
              "device_idle_share": (1 - busy / wall) if busy > 0
              else "not measured",
              "top_device_us": {k[:60]: v for k, v in top}})


def timings(dev) -> dict:
    from repro_torch.kernels.fifo_eval.condensed import fifo_eval_condensed
    from repro_torch.kernels.fifo_eval.condensed import (
        launch_shape as k1_launch_shape)
    from repro_torch.kernels.fifo_eval.fifo_eval import (fifo_eval,
                                                         launch_shape)
    from repro_torch.kernels.fifo_eval.ref import (fifo_eval_condensed_plain,
                                                   fifo_eval_plain)
    rows_out = {"fifo_eval": [], "fifo_eval_condensed": []}
    # (shape, label, graph, rows, with_times): the main path's 8-row
    # batches below the box's floor, then the 512-row bucket
    k2_cases = [("main_path", name, raw_graph(name),
                 low_rows(raw_graph(name), MAIN_ROWS, seed=0), False)
                for name in MAIN_SHAPE_DESIGNS]
    k2_cases += [("bucket", name, raw_graph(name),
                  box_rows(raw_graph(name), 512, seed=0), False)
                 for name in K2_DESIGNS]
    cg = rung("ResidualBlock", "aggressive")
    k2_cases.append(("bucket", "ResidualBlock/aggressive", cg,
                     box_rows(cg, 512, seed=0), True))
    for shape, label, g, rows, with_times in k2_cases:
        args, _, bound = kernel_args(g, rows, dev, cert=False)
        kw = dict(max_iters=256, bound=bound, with_times=with_times)
        out, t = fifo_eval(*args, **kw)
        ms = cuda_ms(lambda: fifo_eval(*args, **kw), reps=5)
        plain = cuda_ms(lambda: fifo_eval_plain(*args, **kw), reps=1)
        b, by = bound_ms(args, out, times=t)
        c, e_pad = (int(x) for x in args[6].shape)
        slowest = int(out[:, 3].max())
        rows_out["fifo_eval"].append(
            {"shape": shape, "design": label, "rows": c, "e_pad": e_pad,
             "cluster": launch_shape(c, e_pad, dev)[0],
             "active": k2_active(dev, e_pad),
             "with_times": with_times, "iters_sum": int(out[:, 3].sum()),
             "iters_max": slowest, "ms": ms,
             "us_per_iter": ms * 1e3 / slowest, "plain_ms": plain,
             "bound_ms": b, "bound_by": by})
        emit({"phase": "time", "kernel": "fifo_eval",
              **rows_out["fifo_eval"][-1]})
    # K1: the main path's batches (1 or 8 rows inside the routing box,
    # padded to the buckets), then the 512-row bucket; each also at
    # max_iters 1, so that the difference is the iterations after the first
    for name in K1_DESIGNS:
        cg = rung(name, "aggressive")
        for shape, c in [("main_path", c) for c in K1_MAIN_ROWS] + [
                ("bucket", 512)]:
            args, _, bound = kernel_args(cg, box_rows(cg, c, seed=0), dev,
                                         cert=True)
            e_pad, v_pad = int(args[6].shape[1]), int(args[10].shape[1])
            kw = dict(max_iters=256, bound=bound)
            kw1 = dict(max_iters=1, bound=bound)
            out, _ = fifo_eval_condensed(*args, **kw)
            ms = graph_ms(lambda: fifo_eval_condensed(*args, **kw))
            ms1 = graph_ms(lambda: fifo_eval_condensed(*args, **kw1))
            plain = cuda_ms(lambda: fifo_eval_condensed_plain(*args, **kw),
                            reps=1)
            b, by = bound_ms(args, out, cert_slots=args[10].numel())
            rows_out["fifo_eval_condensed"].append(
                {"shape": shape, "design": name, "rows": c, "e_pad": e_pad,
                 "v_pad": v_pad,
                 "launch": list(k1_launch_shape(c, e_pad, v_pad, dev)),
                 "iters_sum": int(out[:, 3].sum()),
                 "iters_max": int(out[:, 3].max()), "ms": ms,
                 "ms_max_iters_1": ms1, "plain_ms": plain, "bound_ms": b,
                 "bound_by": by, "bound_share": b / ms})
            emit({"phase": "time", "kernel": "fifo_eval_condensed",
                  **rows_out["fifo_eval_condensed"][-1]})
    return rows_out


# -------------------------------------------------------------------- main
def main(argv=None) -> int:
    global _out_file
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write every line to this file")
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check needs one GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch", "csrc")):
        print("chip_smoke: run it from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    if not args.out:
        return run()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as _out_file:
        try:
            return run()
        finally:
            _out_file = None


def run() -> int:
    import torch
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    emit({"phase": "card", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    from repro_torch.kernels.fifo_eval import build
    t0 = time.perf_counter()
    build.build(verbose_ptxas=True)
    build.load()
    info = build.BUILD_INFO
    ptxas = None                  # no log when the library was built before
    if info.get("ptxas"):
        regs = [int(x) for x in re.findall(r"Used (\d+) registers",
                                           info["ptxas"])]
        spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                             info["ptxas"])]
        # per instance: "<kernel><K[, clustered]>": [registers, spill bytes]
        names = [re.sub(r".*\d([a-z_]+_kernel)ILi(\d+)E(Lb\d)?.*",
                        r"\1<\2\3>", n).replace("Lb1", ", cluster")
                 .replace("Lb0", "")
                 for n in re.findall(r"Function properties for (\S+)",
                                     info["ptxas"])]
        ptxas = {"kernels": len(regs), "max_registers": max(regs),
                 "max_spill_store_bytes": max(spills, default=0),
                 "per_kernel": {n: [r, sp] for n, r, sp in
                                zip(names, regs, spills)}}
    emit({"phase": "build", "built": info.get("built"),
          "nvcc_seconds": info.get("seconds"),
          "build_and_load_seconds": round(time.perf_counter() - t0, 3),
          "library": os.path.relpath(info["path"], ROOT), "ptxas": ptxas})

    cmp = Compare()
    t0 = time.perf_counter()
    check_k2(dev, cmp)
    check_k1(dev, cmp)
    emit({"phase": "checks_done", "seconds":
          round(time.perf_counter() - t0, 3), "max_abs_err": cmp.err})

    t0 = time.perf_counter()
    launches, k1_rows = main_path(dev)
    emit({"phase": "main_path_done",
          "seconds": round(time.perf_counter() - t0, 3)})

    times = timings(dev)
    profile_main_path()
    sources = {"fifo_eval": ("src/repro_torch/csrc/fifo_eval.cu",
                             "src/repro/kernels/fifo_eval/fifo_eval.py:49"),
               "fifo_eval_condensed": (
                   "src/repro_torch/csrc/condensed.cu",
                   "src/repro/kernels/fifo_eval/condensed.py:75")}
    kernels = []
    for name, (source, replaces) in sources.items():
        # the reported time is the slowest design's 512-row bucket; every
        # design's numbers are in the "time" lines above
        worst = max((r for r in times[name] if r.get("shape") != "main_path"),
                    key=lambda r: r["ms"])
        extra = {}
        if name == "fifo_eval_condensed":
            # K1 also at the main path's shapes (1 and 8 rows)
            keys = ("shape", "design", "rows", "e_pad", "v_pad", "launch",
                    "iters_max", "ms", "ms_max_iters_1", "plain_ms",
                    "bound_ms", "bound_by")
            extra = {"launch": worst["launch"],
                     "launches_by_rows": k1_rows, "shapes": [
                         {k: r[k] for k in keys} for r in times[name]
                         if r["shape"] == "main_path" or r is worst]}
        if name == "fifo_eval":
            # K2 also at the main path's shape, with the chosen clusters
            keys = ("shape", "design", "rows", "e_pad", "cluster",
                    "active", "iters_max", "ms", "us_per_iter", "plain_ms",
                    "bound_ms", "bound_by")
            extra = {"cluster": worst["cluster"], "shapes": [
                {k: r[k] for k in keys} for r in times[name]
                if r["shape"] == "main_path" or r is worst]}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": cmp.err.get(name, 0.0), "ms": worst["ms"],
            "plain_ms": worst["plain_ms"], "bound_ms": worst["bound_ms"],
            "bound_by": worst["bound_by"], "library_ms": None,
            "shape": {k: worst[k] for k in ("design", "rows", "e_pad")},
            "library_note": "no single PyTorch call computes a segmented "
                            "max-plus fixpoint", **extra})
    emit({"kernels": kernels})
    emit({"phase": "done", "seconds": round(time.perf_counter() - t_start,
                                            3)})
    emit(nvidia_smi_line())
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
