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
   path's shapes: K2 on the raw streams of gemm, FeedForward, k15mmtree
   and a stream of 32 MolHIV-shaped molecules through FlowGNN's PNA
   engine (43,050 events, a cluster of 16) and on the rungs it serves (both rungs of ResidualBlock, the
   safe rungs of gemm, FeedForward and k15mmtree), on rows inside the
   routing box and rows below its floor; K1 on the aggressive rungs of
   gemm, FeedForward, k15mmseq and k15mmtree; at batches 1, 8, 37, 128
   (the bucket of ``nsga2``'s batches) and 512, with and without times,
   at max_iters 256 and 2 — every output lane and time bit-identical;
   K2 at the cluster size its chooser picks and at every size it allows
   for the stream (forced through the wrapper's ``cluster`` keyword), K1
   at the shape its chooser picks and at every shape it allows
   (``shape`` keyword); K1's certificate equal to the host
   ``verify_rows`` on converged rows; K2 in its per-design-table mode
   (``fifo_eval_hetero``) on mixed batches of ``mult_by_2(8)``,
   ``mult_by_2(24)``, gemm, FeedForward, k15mmtree and ResidualBlock rows
   (1, 8, 37 and 128 rows) against the plain ``fifo_eval_ref_hetero``, at
   the chooser's cluster and every allowed size; at max_iters 256 rows of
   two designs (one in a 1-row batch) must stop on their own bound;
4. the main path: ``FifoAdvisor(design, EvalConfig(backend="cuda")).run(
   "grouped_sa", budget=1000, seed=0)`` on gemm, FeedForward and
   k15mmtree, whose history, frontier and hypervolume must equal the
   numpy backend's, and ``BatchedEvaluator`` on ResidualBlock against
   numpy on 256 random rows, and its rung counts (``n_condensed``,
   ``n_cond_fail``, ``n_fallbacks``) against the plain ``fixpoint``
   backend's on the card; every launch counter is set to 0 just before
   and read just after, and both kernels must have launched (K2's
   launches also by cluster size, K1's by rows per launch);
5. certification and search: on gemm, FeedForward, k15mmtree and
   ``flowgnn_pna()``, ``FifoAdvisor(design, EvalConfig(backend="cuda",
   local_bounds=True, channel_bounds=True, certified_floor=True))`` —
   its construction certifies (seeded by the channel bounds) — then
   unseeded ``certify_min_depths``, the seeded certification from the
   declared depth caps (what ``min_safe_depths`` does for
   ``FifoAdvisor(upper_bounds=...)``), and ``run(name, budget=300,
   seed=0)`` for ``greedy``, ``nsga2`` and ``vmap_search``, plus
   ``run_all(budget=300)`` on gemm: certified vectors,
   ``CertificationResult`` fields, channel bounds, histories, frontiers
   and hypervolumes must equal the numpy backend's; ``mult_by_2(n)``
   must certify to ``[n-1, 1]``.  Counters are set to 0 around every
   step (K1 and K2 launches by rows per launch, the evaluator's rung
   counts), each step must launch a kernel, and both kernels must have
   launched during certification and during ``vmap_search``; each
   step's wall is printed beside numpy's;
6. campaigns (``Campaign(CampaignSpec(...)).run()``, ``grouped_sa`` and
   ``grouped_random``, budget 300, seed 0): the hetero campaign over
   ``FAST_DESIGNS`` (every full-solve row of a round in one K2 launch in
   its per-design-table mode), the inline and the pooled (two workers,
   ``spawn``) per-design campaigns over ``QUICK_DESIGNS``, and a hetero
   campaign over ``QUICK_DESIGNS`` stopped after 3 rounds and resumed
   from its checkpoint; each store equal, task for task, to the same
   campaign on the numpy backend (history, frontier, hypervolume), each
   wall beside numpy's; ``backend="auto"`` on gemm (chosen backend in
   {numpy, cuda}, results equal to numpy's).  Counters are set to 0
   around each campaign; the hetero campaign must launch K2 in its
   per-design-table mode (launches by rows and by cluster, and the
   dispatcher's ``HeteroStats``, are printed);
7. the fuzz CLI, ``python -m repro_torch.launch.fuzz`` in a fresh process
   per mode, over a temporary copy of ``tests/fuzz_corpus``: ``diff``
   (oracle against worklist, condensed, cuda and cuda-condensed),
   ``bounds`` and ``chaos``, each exiting 0;
8. times: each kernel and its plain version, warm, beside the bound (the
   larger of bytes over 3.35 TB/s and float32 operations over 67
   TFLOP/s).  K2 with CUDA events at the 512-row bucket per design (also
   on ResidualBlock's aggressive rung, with times) and at the main path's
   shape: 8 rows below the box's floor on FeedForward and k15mmtree, at
   phase 5's: one certification probe on each of its designs, and, in its
   per-design-table mode, at phase 6's: the hetero campaign's most
   frequent launch size, its mean rows per launch and the bucket they
   pad to, over ``FAST_DESIGNS`` (the
   bound counts each design's tables once and the per-row operands);
   with the time per iteration of the slowest row, the chosen cluster and
   how many clusters of each allowed size the card holds at once.  K1 as
   a CUDA graph of 20 launches (no host overhead) at the main path's 1
   and 8 rows and at the 512-row bucket, each also at max_iters 1 (the
   difference is the iterations after the first);
9. where the time goes: phase 6's hetero campaign, phase 10's hetero
   service, and on k15mmtree a fresh ``grouped_sa`` run, unseeded
   certification and ``vmap_search``, under ``torch.profiler`` (device
   activity only: wall, device busy time, idle share);
10. the advisory service (``repro_torch.core.service``), 8 sessions:
   gemm, FeedForward, k15mmtree (``make_design``'s sizes, E* = 26496)
   and ``flowgnn_pna()`` (registered as a custom ``Design`` object), each
   with ``grouped_sa`` and ``grouped_random``, budget 300, seed 0; every
   session's history, frontier and hypervolume must equal a solo
   ``FifoAdvisor(design, EvalConfig(backend="numpy")).run(...)``
   (computed once each), and so must a numpy service's.
   ``AdvisoryService(hetero=True)`` on the card (every full-solve row of
   a round in one K2 launch in its per-design-table mode, which must
   launch); the per-design service (each advisor's ``RungCascade``: K1
   and K2 must launch); ``save_snapshot`` of the per-design registry,
   ``load_snapshot`` into a fresh registry on the card, and ``grouped_sa``
   on each restored named design with no fresh evaluation, equal to
   numpy (the manifest must list flowgnn_pna under ``"skipped"``); then
   ``python -m repro_torch.launch.serve --stdio --hetero --snapshot-dir
   DIR`` in a fresh process on a scripted transcript (``hello``, two
   ``open``, ``run``, two ``result``, ``snapshot``, ``shutdown``), equal
   to the same script under ``--backend numpy --device cpu`` with the
   wall-clock fields left out, and a second start on DIR, which must be
   warm and answer from the restored cache; both card processes load the
   kernels from ``REPRO_JIT_CACHE_DIR`` (a copy of phase 2's build) and
   must not build.  Counters are set to 0 around each step; walls beside
   numpy's, launches by rows, ``hetero_stats``, and the cold and warm
   registry-ready seconds are printed;
11. row sharding over a device mesh (``repro_torch.launch.mesh``), every
   shard on the one card: ``BatchedEvaluator`` on gemm, FeedForward and
   k15mmtree with ``EvalConfig(backend="mesh", shards=1)`` and on a mesh
   of 4 shards over ``cuda:0`` (``MeshBackend``, inner ``cuda``), at 512
   rows (half inside the routing box, half below it) and ragged 1 and 37
   rows: latency, BRAM and status equal to the numpy backend's, rung
   counts equal to the unsharded cuda evaluator's, and K1 and K2 launched
   on every shard (each shard's launches counted by ``DISPATCH_COUNTS``
   must add up to the kernels' own counters); ``grouped_sa`` (budget
   300) on gemm through a one-shard mesh against numpy; a hetero campaign
   over ``QUICK_DESIGNS`` on a 2x2 ``("design", "eval")`` mesh over
   ``cuda:0`` against phase 6's numpy store, K2's per-design-table mode
   launched on every shard.  Walls beside the unsharded ones: on one card
   the shards run in turn, so no speed-up is expected;
12. the LLM serving path (``repro_torch.models``, ``repro_torch.train
   .steps``), TF32 off (the flags are printed): ``decode_demo`` on every
   reduced arch at batch 4; each reduced arch on the card against the
   same weights and inputs on the CPU at float32 (prefill logits and
   three teacher-forced decode steps) to the CPU tests' tolerance; and
   qwen2-1.5b at full width (28 layers, d_model 1536, vocab 151936,
   ~1.54 B parameters, materialized on the card from a seeded
   ``torch.Generator``): prefill 4 x 1024 prompt tokens, 32 greedy
   decode steps, at float32 and bfloat16, every step's logits against one
   full forward over prompt and generated tokens at the same positions,
   and ``make_decode_step`` picking the same tokens; prefill seconds,
   decode tokens/s and ``torch.cuda.max_memory_allocated`` are printed;
13. LLM training (``repro_torch.train``), TF32 off (the flags are
   printed): (a) each reduced arch, the same weights and ``SyntheticLM``
   batch on the card and on the CPU, ``loss_fn`` and every gradient leaf
   at float32 to the CPU tests' tolerances; (b) ``python -m
   repro_torch.launch.train`` in fresh processes: qwen2-1.5b 6 steps with
   checkpoints every 3, started twice (the second resumes with nothing
   left), a 3-then-6 split run whose last loss is within 5e-3 of the
   straight one, and minicpm-2b over 100 steps, whose loss must fall;
   (c) qwen2-1.5b at full width (1,543,714,304 parameters, float32
   master weights and AdamW state from ``init_train_state`` with a
   seeded generator on the card), batch 4 x 1024 ``SyntheticLM``
   tokens: the first step's loss equals ``make_eval_step``'s, ``accum=2``
   from a copy of the state gives the same loss, ``grad_norm``, moments
   and updated parameters, and gradients with remat on and off (on 2 x
   1024 tokens) are equal, with less peak memory under remat; 3 steps of
   ``make_train_step`` at float32, then 3 at bf16 on the same batches
   (their first loss within 5e-2 of the float32 eval loss of the state
   they start from): seconds per step and tokens/s (steps 2-3),
   ``max_memory_allocated`` (steps 2-3), loss and ``grad_norm`` beside
   the bound (the larger of 24 N bytes over 3.35 TB/s and 8 N
   operations a token over 67 or 989 TFLOP/s), and one more step of
   each under ``torch.profiler`` (device idle share, largest kernels);

14. placement over several devices and the dry-run
   (``repro_torch.launch.dryrun``): (a) the dry-run's cells at full
   width on fake process groups of 256 and 512 ranks — all four shapes
   of qwen2-1.5b on both meshes (6 ok, 2 skipped), qwen3-moe-30b-a3b
   ``train_4k`` and mamba2-1.3b ``long_500k`` on 16x16 — each ``ok`` or
   ``skipped``, with its memory, flops, collectives, roofline terms and
   seconds; (b) the dry-run on a 1x1 mesh of phase 13's step and phase
   12's prefill (qwen2-1.5b, 4 x 1024 tokens, float32 and bf16) beside
   the ``max_memory_allocated`` those phases printed, and its flops
   beside 8 N tokens (train, remat) and 2 N tokens (prefill); (c) one
   ``make_train_step`` of qwen2-7b as rank 0 of a (data 2, model 4) fake
   group, its shards real tensors on the card and one 4096-token
   sequence per data rank: every local parameter and moment has the
   shape and layout the dry-run gives rank 0 and lies on the card;
   ``max_memory_allocated`` beside the dry-run's total for that cell,
   and the step's seconds (local compute, collectives faked).  The
   dry-run cells run in spawned processes while (c) runs; no process
   group outlives the phase;

Phases 11, 12, 13 and 14 run after phase 7, before 8.  Then the ``{"kernels":
[...]}`` line (with each kernel's launches in phases 4, 5, 6, 10 and
11), the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Without a CUDA device, or outside a
checkout of the repository, it exits nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
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
BF16_OPS_PER_S = 989e12
#: float32 operations per event per fixpoint iteration: the edge add, the
#: max with delta, the scan combine (two adds and a max) and max(A, M)
OPS_PER_EVENT_ITER = 6
#: per certificate slot: the difference and the comparison
OPS_PER_CERT_SLOT = 2

K2_DESIGNS = ("gemm", "FeedForward", "k15mmtree", "flowgnn_pna_stream")
#: the seed of the flowgnn_pna_stream design: 32 MolHIV-shaped molecules,
#: 43,050 events, so K2 runs its rows on a cluster of 16 CTAs
FLOWGNN_STREAM_SEED = 23
#: phase 3's mixed batches for K2's per-design-table mode; the two
#: mult_by_2 designs come first and deadlock below depth n - 1, so rows
#: with different bounds stop on them within 256 iterations
HETERO_DESIGNS = ("mult_by_2(8)", "mult_by_2(24)", "gemm", "FeedForward",
                  "k15mmtree", "ResidualBlock")
HETERO_BATCHES = (1, 8, 37, 128)
#: phase 6: the campaigns' optimizers and budget
CAMPAIGN_OPTIMIZERS = ("grouped_sa", "grouped_random")
CAMPAIGN_BUDGET = 300
#: the rungs below FUSED_MIN_COMPRESSION that K2 serves with times
K2_RUNGS = (("ResidualBlock", "aggressive"), ("ResidualBlock", "safe"),
            ("gemm", "safe"), ("FeedForward", "safe"), ("k15mmtree", "safe"))
K1_DESIGNS = ("gemm", "FeedForward", "k15mmseq", "k15mmtree")
MAIN_DESIGNS = ("gemm", "FeedForward", "k15mmtree")
BATCHES = (1, 8, 37, 128, 512)
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
#: phase 5: the designs, the optimizers and the pruning flags
CERT_DESIGNS = ("gemm", "FeedForward", "k15mmtree", "flowgnn_pna")
#: phase 9: the designs whose main path and phase-5 steps are profiled
PROFILE_DESIGNS = ("k15mmtree",)
SEARCH_OPTIMIZERS = ("greedy", "nsga2", "vmap_search")
SEARCH_BUDGET = 300
PRUNING = {"local_bounds": True, "channel_bounds": True,
           "certified_floor": True}
KNOWN_ANSWER_N = (8, 24, 64)
#: phase 10: the service's designs (flowgnn_pna registered as a custom
#: Design object), optimizers and budget; every session has seed 0
SERVICE_DESIGNS = ("gemm", "FeedForward", "k15mmtree", "flowgnn_pna")
SERVICE_OPTIMIZERS = ("grouped_sa", "grouped_random")
SERVICE_BUDGET = 300
#: phase 11: the designs, the batches (512 random rows, then ragged 1
#: and 37), the shards of the one-card mesh, and grouped_sa's budget
MESH_DESIGNS = ("gemm", "FeedForward", "k15mmtree")
MESH_BATCHES = (512, 1, 37)
MESH_SHARDS = 4
MESH_BUDGET = 300
#: the one card every shard of phase 11's meshes runs on
MESH_DEVICE = "cuda:0"
#: phase 12: the card against the CPU on the reduced archs at float32,
#: to the CPU tests' tolerance (tests/test_torch_models.py RTOL:
#: rtol = tol, atol = tol * max|CPU|)
LLM_F32_TOL = 1e-5
#: phase 12 at full width: qwen2-1.5b, batch 4 x 1024 prompt tokens (two
#: Q_CHUNK chunks), 32 decode steps; each step's logits against one full
#: forward over prompt + generated tokens, to these tolerances (same rule)
LLM_FULL_ARCH = "qwen2-1.5b"
LLM_BATCH = 4
LLM_PROMPT = 1024
LLM_GEN = 32
LLM_FULL_F32_TOL = 1e-4
LLM_FULL_BF16_TOL = 5e-2
#: phase 13: the card against the CPU on the reduced archs at float32, to
#: the CPU tests' tolerances (tests/test_torch_train_steps.py: the loss
#: to rtol 1e-5, each gradient leaf to rtol = atol / max|CPU| = 1e-4)
TRAIN_LOSS_TOL = 1e-5
TRAIN_GRAD_TOL = 1e-4
#: phase 13: the train CLI's 3-then-6 split run against the straight one
#: (the reference's test_train_resume_end_to_end bound)
TRAIN_CLI_SPLIT_TOL = 5e-3
#: phase 13 at full width: qwen2-1.5b, batch 4 x 1024 SyntheticLM tokens,
#: 3 steps at float32 and 3 at bf16 (AdamW, float32 master weights)
TRAIN_BATCH = 4
TRAIN_SEQ = 1024
TRAIN_STEPS = 3
#: the remat on/off comparison takes the first 2 rows of the batch:
#: without remat, 4 x 1024 tokens keep ~40 GB of activations beside the
#: 18.5 GB state and two gradient sets (~75 of the card's 80 GB)
TRAIN_REMAT_ROWS = 2
#: phase 14 (a): the dry-run's cells at full width, longest first
PLACE_CELLS = (("qwen3-moe-30b-a3b", "train_4k", False),
               ("qwen2-1.5b", "prefill_32k", False),
               ("qwen2-1.5b", "prefill_32k", True),
               ("qwen2-1.5b", "train_4k", False),
               ("qwen2-1.5b", "train_4k", True),
               ("qwen2-1.5b", "decode_32k", False),
               ("qwen2-1.5b", "decode_32k", True),
               ("mamba2-1.3b", "long_500k", False),
               ("qwen2-1.5b", "long_500k", False),
               ("qwen2-1.5b", "long_500k", True))
#: phase 14 (c): qwen2-7b (7.6 B parameters: 16 B each of float32 weights
#: and AdamW state do not fit one card) on a (data 2, model 4) mesh of
#: fake ranks, one PLACE_SEQ-token sequence per data rank
PLACE_ARCH = "qwen2-7b"
PLACE_MESH = (2, 4)
PLACE_SEQ = 4096
#: phase 14: the dry-run cells' processes (the card's host has 8 cores;
#: one is left to part (c))
PLACE_JOBS = 7
#: phase 10: the serve CLI's scripted transcript
SERVE_SCRIPT = (
    {"op": "hello", "proto": 2},
    {"op": "open", "design": "gemm", "optimizer": "grouped_sa",
     "budget": SERVICE_BUDGET, "seed": 0},
    {"op": "open", "design": "FeedForward", "optimizer": "grouped_random",
     "budget": SERVICE_BUDGET, "seed": 0},
    {"op": "run"},
    {"op": "result", "session": "s0"},
    {"op": "result", "session": "s1"},
    {"op": "snapshot"},
    {"op": "shutdown"})
#: the warm restart's script: the first session again, from the snapshot
SERVE_WARM_SCRIPT = SERVE_SCRIPT[:2] + (SERVE_SCRIPT[3], SERVE_SCRIPT[4],
                                        SERVE_SCRIPT[-1])
#: reply fields that carry wall-clock seconds: left out of the transcript
#: comparison, and nothing else
WALL_KEYS = frozenset({"retry_after_s", "eval_s", "wall_s", "trace_time_s",
                       "runtime_s", "round_ewma_s"})

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
    return build_simgraph(design_of(name))


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


def hetero_batch(names, c: int, dev, seed: int = 0):
    """A cross-design batch of ``c`` rows spread evenly over the raw
    streams of designs ``names`` (each design's share half below the
    routing box's floor, half inside it): ``(tables, table_of_row,
    depths, operands)``, where ``operands`` are K2's per-row operands
    ``(rd_lat, bp_idx, bp_valid)``, ``bounds`` (C,), the per-row
    tables the plain version reads, and the device memory that
    computing the per-row operands took at its peak (bytes, outputs
    included)."""
    import numpy as np
    import torch
    from repro_torch.core.backends import operands as O
    graphs = [raw_graph(n) for n in names]
    opses = [O.get_operands(g, "cpu") for g in graphs]
    env = (max(o.e_pad for o in opses), max(o.n_fifos for o in opses),
           max(o.n_flat_reads for o in opses))
    tables = O.stack_tables([O.extend_operands(o, *env) for o in opses],
                            dev)
    entries = []
    for i, g in enumerate(graphs):
        n = c // len(graphs) + (i < c % len(graphs))
        if n:
            entries.append((i, np.concatenate(
                [low_rows(g, n - n // 2, seed), box_rows(g, n // 2, seed)])))
    tor, depths = O.stack_rows(entries, env[1])
    tor = torch.as_tensor(tor, device=dev)
    idx = tor.long()
    depths = torch.as_tensor(depths, device=dev)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    rd, bpi, bpv, _, _ = O.hetero_depth_operands(tables, idx, depths)
    peak = torch.cuda.max_memory_allocated(dev) - base
    per_row = [getattr(tables, f)[idx] for f in
               ("delta", "seg_start", "is_read", "has_data", "data_idx",
                "end_bonus")]
    return tables, tor, (rd, bpi, bpv), tables.bound[idx], per_row, peak


def hetero_args(tables, tor, rows, bounds):
    """fifo_eval_hetero's positional operands and keywords."""
    args = (tables.delta, tables.seg_start, tables.is_read,
            tables.has_data, tables.data_idx, tables.end_bonus, *rows)
    return args, {"table_of_row": tor, "bounds": bounds}


def check_k2_hetero(dev, cmp: Compare) -> None:
    """K2's per-design-table mode on mixed batches, at the cluster size
    the chooser picks and at every size it allows, against the plain
    ``fifo_eval_ref_hetero`` on the same per-row operands."""
    import torch
    from repro_torch.kernels.fifo_eval.fifo_eval import (fifo_eval_hetero,
                                                         k2_cluster_sizes,
                                                         launch_shape)
    from repro_torch.kernels.fifo_eval.ref import fifo_eval_ref_hetero
    for c in HETERO_BATCHES:
        tables, tor, rows, bounds, per_row, _ = hetero_batch(
            HETERO_DESIGNS, c, dev)
        args, kw = hetero_args(tables, tor, rows, bounds)
        e_pad = tables.e_pad
        chosen = launch_shape(c, e_pad, dev)[0]
        sizes = k2_cluster_sizes(e_pad, max_cluster(dev))
        for max_iters in (256, 2):
            for with_times in (False, True):
                p_out, p_t = fifo_eval_ref_hetero(
                    *per_row, *rows, bounds, max_iters=max_iters,
                    with_times=with_times)
                for cluster in (None,) + sizes:
                    out, t = fifo_eval_hetero(*args, **kw,
                                              max_iters=max_iters,
                                              with_times=with_times,
                                              cluster=cluster)
                    torch.cuda.synchronize()
                    what = (f"hetero C={c} iters={max_iters} t={with_times}"
                            f" cluster={cluster or chosen}")
                    cmp.same("fifo_eval_hetero", what, out, p_out)
                    if with_times:
                        cmp.same("fifo_eval_hetero", what + " times", t, p_t)
                over = out[:, 2] > 0
                # the per-row stop on bounds[row] must be exercised, on the
                # rows of two designs (two bounds) once the batch has both
                stopped = set(tor[over].tolist())
                if max_iters == 256 and len(stopped) < min(2, c):
                    raise AssertionError(
                        f"hetero C={c}: rows of {len(stopped)} designs "
                        "stopped on their bound")
                emit({"phase": "check", "kernel": "fifo_eval",
                      "mode": "per-design tables",
                      "designs": list(HETERO_DESIGNS), "e_pad": e_pad,
                      "rows": c, "max_iters": max_iters,
                      "with_times": with_times, "clusters": list(sizes),
                      "chosen": chosen, "equal": True,
                      "converged": int((out[:, 1] > 0).sum()),
                      "over": int(over.sum()),
                      "over_designs": len(stopped),
                      "max_iters_run": int(out[:, 3].max())})


# --------------------------------------------------------------- main path
def reset_counts():
    from repro_torch.kernels.fifo_eval import condensed, fifo_eval, ops
    fifo_eval.fifo_eval.launches = 0
    fifo_eval.fifo_eval.clusters = {}
    fifo_eval.fifo_eval.rows = {}
    fifo_eval.fifo_eval_hetero.launches = 0
    fifo_eval.fifo_eval_hetero.clusters = {}
    fifo_eval.fifo_eval_hetero.rows = {}
    condensed.fifo_eval_condensed.launches = 0
    condensed.fifo_eval_condensed.rows = {}
    ops.DISPATCH_COUNTS.clear()


def read_counts() -> dict:
    from repro_torch.kernels.fifo_eval import condensed, fifo_eval, ops
    return {"fifo_eval": fifo_eval.fifo_eval.launches,
            "fifo_eval_clusters": dict(fifo_eval.fifo_eval.clusters),
            "fifo_eval_rows": dict(fifo_eval.fifo_eval.rows),
            "fifo_eval_hetero": fifo_eval.fifo_eval_hetero.launches,
            "fifo_eval_hetero_clusters":
                dict(fifo_eval.fifo_eval_hetero.clusters),
            "fifo_eval_hetero_rows": dict(fifo_eval.fifo_eval_hetero.rows),
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


# ----------------------------------------------- certification and search
def design_of(name: str):
    from repro_torch.designs import (flowgnn_pna, flowgnn_pna_stream,
                                     make_design, molhiv_stream, mult_by_2)
    if name.startswith("mult_by_2("):
        return mult_by_2(int(name[len("mult_by_2("):-1]))
    if name == "flowgnn_pna_stream":
        return flowgnn_pna_stream(molhiv_stream(32, FLOWGNN_STREAM_SEED),
                                  seed=FLOWGNN_STREAM_SEED)
    return flowgnn_pna() if name == "flowgnn_pna" else make_design(name)


def run_step(fn):
    """``fn()`` with every launch counter set to 0 just before and read
    just after: (result, wall seconds, counts)."""
    import torch
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, wall, read_counts()


def wall_of(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def same_cert(label: str, got, want) -> None:
    import numpy as np
    for k in ("depths", "latency", "bram", "n_probes", "n_cache_hits"):
        if not np.array_equal(getattr(got, k), getattr(want, k)):
            raise AssertionError(f"{label}: certification {k} "
                                 f"{getattr(got, k)} on cuda, "
                                 f"{getattr(want, k)} on numpy")


def same_search(label: str, got, want) -> None:
    import numpy as np
    for k in ("configs", "latency", "bram", "deadlock"):
        if not np.array_equal(getattr(got.result, k),
                              getattr(want.result, k)):
            raise AssertionError(f"{label}: history {k} differs from the "
                                 f"numpy backend")
    if got.result.n_evals != want.result.n_evals \
            or not np.array_equal(got.frontier_points, want.frontier_points) \
            or not np.array_equal(got.frontier_configs,
                                  want.frontier_configs) \
            or got.hypervolume() != want.hypervolume():
        raise AssertionError(f"{label}: frontier differs from the numpy "
                             f"backend")


def certify_search() -> dict:
    """Phase 5: certification, bounds and the remaining optimizers on the
    card against the numpy backend.  Returns, per kernel, the phase's
    launches and its launches by rows per launch."""
    import numpy as np
    from repro_torch.core import EvalConfig, FifoAdvisor
    from repro_torch.core.deadlock import certify_min_depths
    from repro_torch.designs import mult_by_2
    kernels = ("fifo_eval", "fifo_eval_condensed")
    by_kind = {kind: dict.fromkeys(kernels, 0)
               for kind in ("construct", "certify", "search", "vmap_search")}
    rows = {k: {} for k in kernels}

    def record(name, step, kind, wall, counts, evals, ref_wall, ev, before,
               **extra):
        launches = {k: counts[k] for k in kernels}
        if not sum(launches.values()):
            raise AssertionError(f"{name} {step}: no kernel launched")
        for k in kernels:
            by_kind[kind][k] += launches[k]
            if step == "vmap_search":
                by_kind["vmap_search"][k] += launches[k]
        for k, key in (("fifo_eval", "fifo_eval_rows"),
                       ("fifo_eval_condensed", "fifo_eval_condensed_rows")):
            for c, n in counts[key].items():
                rows[k][c] = rows[k].get(c, 0) + n
        st = ev.stats
        emit({"phase": "certify_search", "design": name, "step": step,
              "evals": evals, "wall_s": wall,
              "evals_per_s": evals / wall, "numpy_wall_s": ref_wall,
              "equal_to_numpy": True, "launches": launches,
              "fifo_eval_launches_by_rows": counts["fifo_eval_rows"],
              "fifo_eval_launches_by_cluster": counts["fifo_eval_clusters"],
              "fifo_eval_condensed_launches_by_rows":
                  counts["fifo_eval_condensed_rows"],
              **{k: getattr(st, k) - before[k] for k in before}, **extra})

    stat_keys = ("n_configs", "n_condensed", "n_cond_fail", "n_fallbacks")

    def stats_of(ev):
        return {k: getattr(ev.stats, k) for k in stat_keys}

    cuda = EvalConfig(backend="cuda", **PRUNING)
    numpy_cfg = EvalConfig(backend="numpy", **PRUNING)
    for name in CERT_DESIGNS:
        # construction certifies (certified_floor), seeded by the bounds
        before = dict.fromkeys(stat_keys, 0)
        adv, wall, counts = run_step(
            lambda: FifoAdvisor(design_of(name), cuda))
        ref, ref_wall = wall_of(
            lambda: FifoAdvisor(design_of(name), numpy_cfg))
        if not np.array_equal(adv.min_safe_depths(), ref.min_safe_depths()):
            raise AssertionError(f"{name}: min_safe_depths differs")
        same_cert(name, adv.certification, ref.certification)
        cb, ref_cb = adv.channel_bounds(), ref.channel_bounds()
        if not (np.array_equal(cb.lower, ref_cb.lower)
                and np.array_equal(cb.upper, ref_cb.upper)
                and cb.kinds == ref_cb.kinds):
            raise AssertionError(f"{name}: channel bounds differ")
        cert = adv.certification
        record(name, "construct_and_certify", "construct", wall, counts,
               cert.n_probes, ref_wall, adv.evaluator, before,
               n_probes=cert.n_probes, n_cache_hits=cert.n_cache_hits,
               certify_wall_s=cert.wall_s,
               numpy_certify_wall_s=ref.certification.wall_s,
               n_pinned=cb.n_pinned, depths_sum=int(cert.depths.sum()),
               rungs=adv.evaluator.condensation_info())
        caps = np.asarray(adv.graph.upper_bounds, dtype=np.int64)
        for step, kw, ref_kw in (
                ("certify_unseeded", {}, {}),
                ("certify_from_caps", {"upper": caps, "bounds": cb},
                 {"upper": caps, "bounds": ref_cb})):
            before = stats_of(adv.evaluator)
            got, wall, counts = run_step(lambda: certify_min_depths(
                adv.graph, adv.evaluator, **kw))
            want, ref_wall = wall_of(lambda: certify_min_depths(
                ref.graph, ref.evaluator, **ref_kw))
            same_cert(f"{name} {step}", got, want)
            if step == "certify_unseeded" and not np.array_equal(
                    got.depths, adv.min_safe_depths()):
                raise AssertionError(f"{name}: unseeded certification "
                                     f"differs from the seeded one")
            record(name, step, "certify", wall, counts, got.n_probes,
                   ref_wall, adv.evaluator, before, n_probes=got.n_probes)
        for opt in SEARCH_OPTIMIZERS:
            before = stats_of(adv.evaluator)
            res, wall, counts = run_step(
                lambda: adv.run(opt, budget=SEARCH_BUDGET, seed=0))
            want, ref_wall = wall_of(
                lambda: ref.run(opt, budget=SEARCH_BUDGET, seed=0))
            same_search(f"{name} {opt}", res, want)
            record(name, opt, "search", wall, counts, res.result.n_evals,
                   ref_wall, adv.evaluator, before, budget=SEARCH_BUDGET,
                   hypervolume=res.hypervolume(),
                   frontier_points=res.frontier_points.tolist())
        if name == "gemm":
            before = stats_of(adv.evaluator)
            got, wall, counts = run_step(
                lambda: adv.run_all(budget=SEARCH_BUDGET))
            want, ref_wall = wall_of(
                lambda: ref.run_all(budget=SEARCH_BUDGET))
            if list(got) != list(want):
                raise AssertionError("gemm run_all: optimizers differ")
            for k in got:
                same_search(f"gemm run_all {k}", got[k], want[k])
            record(name, "run_all", "search", wall, counts,
                   sum(r.result.n_evals for r in got.values()), ref_wall,
                   adv.evaluator, before, optimizers=list(got))
    for n in KNOWN_ANSWER_N:
        got = FifoAdvisor(mult_by_2(n), EvalConfig(backend="cuda")
                          ).min_safe_depths().tolist()
        if got != [n - 1, 1]:
            raise AssertionError(f"mult_by_2({n}) certified to {got}")
        emit({"phase": "certify_search", "design": f"mult_by_2({n})",
              "step": "known_answer", "certified": got, "equal": True})
    # the certification steps proper (construction also evaluates the
    # baselines) and vmap_search must have run both kernels
    for kind in ("certify", "vmap_search"):
        for k in kernels:
            if by_kind[kind][k] == 0:
                raise AssertionError(f"{k} never launched during {kind}")
    emit({"phase": "certify_search_launches", "by_kind": by_kind,
          "by_rows": rows})
    return {k: {"launches": sum(by_kind[kind][k] for kind in
                                ("construct", "certify", "search")),
                "by_rows": rows[k]} for k in kernels}


# --------------------------------------------------------------- campaigns
def campaign_spec(designs, **kw):
    from repro_torch.core.campaign import CampaignSpec
    return CampaignSpec(designs=tuple(designs),
                        optimizers=CAMPAIGN_OPTIMIZERS,
                        budget=CAMPAIGN_BUDGET, seed=0, **kw)


def same_store(label: str, got, want) -> None:
    """Every task's history, frontier and hypervolume equal."""
    if list(got.keys()) != list(want.keys()):
        raise AssertionError(f"{label}: tasks differ")
    for k in want.keys():
        same_search(f"{label} {k}", got[k], want[k])


def campaign_phase(dev) -> dict:
    """Phase 6: campaigns on the card against the same campaigns on the
    numpy backend.  Returns the hetero campaign's counts and stats."""
    import dataclasses
    import shutil
    import tempfile
    import numpy as np
    from repro_torch.core import EvalConfig, FifoAdvisor
    from repro_torch.core.campaign import Campaign
    from repro_torch.designs import FAST_DESIGNS, QUICK_DESIGNS, make_design
    cuda, numpy_cfg = EvalConfig(backend="cuda"), EvalConfig(backend="numpy")
    ref_fast, ref_fast_wall = wall_of(lambda: Campaign(campaign_spec(
        FAST_DESIGNS, eval=numpy_cfg, workers=0), device=dev).run())
    ref_quick, ref_quick_wall = wall_of(lambda: Campaign(campaign_spec(
        QUICK_DESIGNS, eval=numpy_cfg, workers=0), device=dev).run())
    kernels = ("fifo_eval", "fifo_eval_condensed", "fifo_eval_hetero")
    totals = dict.fromkeys(kernels, 0)

    def report(mode, designs, store, want, wall, ref_wall, counts, **extra):
        same_store(f"campaign {mode}", store, want)
        for k in kernels:
            totals[k] += counts[k]
        emit({"phase": "campaign", "mode": mode, "designs": list(designs),
              "tasks": len(store), "evals": store.total_evals(),
              "wall_s": wall, "numpy_wall_s": ref_wall,
              "equal_to_numpy": True,
              "launches": {k: counts[k] for k in kernels},
              "fifo_eval_launches_by_rows": counts["fifo_eval_rows"],
              "fifo_eval_hetero_launches_by_rows":
                  counts["fifo_eval_hetero_rows"],
              "fifo_eval_hetero_launches_by_cluster":
                  counts["fifo_eval_hetero_clusters"],
              "fifo_eval_condensed_launches_by_rows":
                  counts["fifo_eval_condensed_rows"], **extra})

    # the slice's path: every full-solve row of a round in one K2 launch
    def hetero():
        camp = Campaign(campaign_spec(FAST_DESIGNS, eval=cuda, hetero=True,
                                      workers=0), device=dev)
        return camp, camp.run()
    (camp, store), wall, counts = run_step(hetero)
    if counts["fifo_eval_hetero"] == 0:
        raise AssertionError("the hetero campaign launched no K2 in its "
                             "per-design-table mode")
    stats = dataclasses.asdict(camp.hetero.stats)
    report("hetero", FAST_DESIGNS, store, ref_fast, wall, ref_fast_wall,
           counts, rounds=camp.round, hetero_stats=stats,
           e_pad=camp.hetero.e_pad)
    out = {"counts": counts, "stats": stats, "totals": totals,
           "quick_numpy": (ref_quick, ref_quick_wall)}

    # per-design campaigns: inline, and pooled (spawn: CUDA is up)
    for mode, workers in (("inline", 0), ("pooled", 2)):
        def per_design():
            camp = Campaign(campaign_spec(QUICK_DESIGNS, eval=cuda,
                                          workers=workers), device=dev)
            method = camp.pool.start_method if camp.pool else None
            return camp, camp.run(), method
        (camp, store, method), wall, counts = run_step(per_design)
        if mode == "inline" and not (counts["fifo_eval"]
                                     + counts["fifo_eval_condensed"]):
            raise AssertionError("the inline campaign launched no kernel")
        if mode == "pooled" and method != "spawn":
            raise AssertionError(f"pooled campaign started its workers "
                                 f"with {method!r}, not spawn")
        report(mode, QUICK_DESIGNS, store, ref_quick, wall, ref_quick_wall,
               counts, start_method=method, pool_stats=camp.pool_stats)

    # stop a hetero campaign after 3 rounds, resume it from its checkpoint
    tmp = tempfile.mkdtemp(prefix="chip_smoke_campaign_")
    try:
        path = os.path.join(tmp, "camp.npz")

        def stop_and_resume():
            first = Campaign(campaign_spec(QUICK_DESIGNS, eval=cuda,
                                           hetero=True, checkpoint_every=2),
                             checkpoint_path=path, device=dev)
            first.run(max_rounds=3)
            if first.finished:
                raise AssertionError("checkpoint: finished in 3 rounds")
            return Campaign.resume(path, device=dev).run()
        store, wall, counts = run_step(stop_and_resume)
        report("checkpoint_resume", QUICK_DESIGNS, store, ref_quick, wall,
               ref_quick_wall, counts, stopped_after_rounds=3)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # backend="auto": the evaluator races numpy against the kernels
    adv, wall, counts = run_step(lambda: FifoAdvisor(
        make_design("gemm"), EvalConfig(backend="auto"), device=dev))
    cal = adv.evaluator.calibration
    if cal["chosen"] not in ("numpy", "cuda") \
            or set(cal["probe_s"]) != {"numpy", "cuda"}:
        raise AssertionError(f"auto calibration {cal}")
    if adv.evaluator.config.backend != cal["chosen"]:
        raise AssertionError("auto: config.backend is not the chosen one")
    res = adv.run("grouped_sa", budget=CAMPAIGN_BUDGET, seed=0)
    ref = FifoAdvisor(make_design("gemm"), numpy_cfg).run(
        "grouped_sa", budget=CAMPAIGN_BUDGET, seed=0)
    same_search("auto gemm grouped_sa", res, ref)
    for k in kernels:
        totals[k] += counts[k]
    emit({"phase": "campaign", "mode": "auto_backend", "design": "gemm",
          "calibration": cal, "construct_wall_s": wall,
          "launches": {k: counts[k] for k in kernels},
          "evals": res.result.n_evals, "equal_to_numpy": True,
          "frontier_points": np.asarray(res.frontier_points).tolist()})
    return out


def fuzz_phase() -> None:
    """Phase 7: the fuzz CLI in a fresh process per mode (so that
    ``chaos`` may fork), over a temporary copy of the corpus."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fuzz_")
    try:
        corpus = os.path.join(tmp, "corpus")
        shutil.copytree(os.path.join(ROOT, "tests", "fuzz_corpus"), corpus)
        env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        for mode, extra in (
                ("diff", ["--seeds", "0:40", "--backends",
                          "worklist,condensed,cuda,cuda-condensed"]),
                ("bounds", ["--seeds", "0:200"]),
                ("chaos", ["--seeds", "0:10"])):
            summary = os.path.join(tmp, f"{mode}.json")
            cmd = [sys.executable, "-m", "repro_torch.launch.fuzz",
                   "--quick", "--mode", mode, "--corpus", corpus,
                   "--out", summary, *extra]
            t0 = time.perf_counter()
            r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                               text=True, timeout=600)
            if r.returncode != 0:
                raise AssertionError(f"fuzz --mode {mode} exited "
                                     f"{r.returncode}:\n{r.stdout[-3000:]}"
                                     f"\n{r.stderr[-3000:]}")
            with open(summary) as f:
                res = json.load(f)
            emit({"phase": "fuzz", "mode": mode, "rc": r.returncode,
                  "seconds": time.perf_counter() - t0,
                  "n_designs": res["n_designs"], "n_rows": res["n_rows"],
                  "backends": res["backends"], "wall_s": res["wall_s"],
                  "disagreements": len(res["mismatches"]),
                  "corpus_unchanged": sorted(os.listdir(corpus)) == sorted(
                      os.listdir(os.path.join(ROOT, "tests",
                                              "fuzz_corpus")))})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ----------------------------------------------------------------- service
def same_session(label: str, got, want) -> None:
    """A session's history, frontier and hypervolume equal a solo run's
    (``n_evals`` counts cache misses, which sessions on one design share,
    so it is not compared)."""
    import numpy as np
    for k in ("configs", "latency", "bram", "deadlock"):
        if not np.array_equal(getattr(got.result, k),
                              getattr(want.result, k)):
            raise AssertionError(f"{label}: history {k} differs from the "
                                 f"solo numpy run")
    if not np.array_equal(got.frontier_points, want.frontier_points) \
            or not np.array_equal(got.frontier_configs,
                                  want.frontier_configs) \
            or got.hypervolume() != want.hypervolume():
        raise AssertionError(f"{label}: frontier differs from the solo "
                             f"numpy run")


def service_mix():
    return [(d, o) for d in SERVICE_DESIGNS for o in SERVICE_OPTIMIZERS]


def run_service(dev, config, hetero: bool):
    """Open the phase's 8 sessions on a fresh service and run them to
    completion: (service, {(design, optimizer): DseResult})."""
    from repro_torch.core.service import AdvisoryService
    svc = AdvisoryService(config=config, hetero=hetero, device=dev)
    sessions = {}
    for d, o in service_mix():
        obj = design_of(d) if d == "flowgnn_pna" else None
        sessions[(d, o)] = svc.open_session(
            d, optimizer=o, budget=SERVICE_BUDGET, seed=0, design_obj=obj)
    svc.run_until_idle()
    return svc, {k: s.dse_result() for k, s in sessions.items()}


def strip_wall(obj):
    if isinstance(obj, dict):
        return {k: strip_wall(v) for k, v in obj.items()
                if k not in WALL_KEYS}
    if isinstance(obj, list):
        return [strip_wall(v) for v in obj]
    return obj


def serve(args, script, env, cwd: str) -> tuple:
    """``python -m repro_torch.launch.serve --stdio ARGS`` in a fresh
    process in ``cwd``, fed ``script``: (frames, stderr, seconds)."""
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--stdio",
         *args], input="".join(json.dumps(m) + "\n" for m in script),
        cwd=cwd, env=env, capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"serve {args} exited {r.returncode}:\n"
                             f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    frames = [json.loads(x) for x in r.stdout.splitlines()]
    return frames, r.stderr, time.perf_counter() - t0


def serve_line(stderr: str, what: str) -> str:
    lines = [x for x in stderr.splitlines() if x.startswith(what)]
    if len(lines) != 1:
        raise AssertionError(f"serve: expected one {what!r} line in\n"
                             f"{stderr[-3000:]}")
    return lines[0]


def ready_seconds(stderr: str) -> float:
    return float(re.match(r"registry ready in ([0-9.]+)s",
                          serve_line(stderr, "registry ready")).group(1))


def serve_cli(tmp: str) -> dict:
    """Step 4: the serve CLI in fresh processes.  The card's server
    (``--hetero``, default ``--backend cuda --device cuda``) must answer
    the scripted transcript as the numpy server on the CPU does, once the
    wall-clock fields are left out; a second start on the same snapshot
    directory must be warm and answer from the restored cache.  Each
    server runs in a directory of its own with ``--snapshot-dir snap``,
    so the replies name the same directory.  Both card processes build
    into ``REPRO_JIT_CACHE_DIR``, seeded with a copy of the library phase
    2 built: each must load it, neither may build."""
    import shutil
    from repro_torch.kernels.fifo_eval import build
    cache = os.path.join(tmp, "jit-cache")
    lib = build.BUILD_INFO["path"]
    os.makedirs(os.path.join(cache, build.source_hash()))
    shutil.copy(lib, os.path.join(cache, build.source_hash()))
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.pop("REPRO_TORCH_BUILD_DIR", None)
    card_env = dict(env, REPRO_JIT_CACHE_DIR=cache)
    card_dir, numpy_dir = (os.path.join(tmp, d) for d in ("card", "numpy"))
    os.makedirs(card_dir)
    os.makedirs(numpy_dir)
    card_args = ["--hetero", "--snapshot-dir", "snap"]
    got, err, wall = serve(card_args, SERVE_SCRIPT, card_env, card_dir)
    want, ref_err, ref_wall = serve(
        ["--backend", "numpy", "--device", "cpu", "--snapshot-dir",
         "snap"], SERVE_SCRIPT, env, numpy_dir)
    if strip_wall(got) != strip_wall(want):
        raise AssertionError(f"serve: the card's transcript differs from "
                             f"numpy's:\n{got}\n{want}")
    replies = [f for f in got if "event" not in f]
    if [f.get("ok") for f in replies] != [True] * len(SERVE_SCRIPT):
        raise AssertionError(f"serve: a request failed: {replies}")
    again, warm_err, warm_wall = serve(card_args, SERVE_WARM_SCRIPT,
                                       card_env, card_dir)
    warm = [f for f in again if "event" not in f]
    if "(warm, 2 restored)" not in serve_line(warm_err, "registry ready"):
        raise AssertionError(f"serve: the second start is not warm:\n"
                             f"{warm_err[-3000:]}")
    if warm[3]["result"]["n_evals"] != 0 \
            or warm[3]["result"]["frontier"] != \
            replies[4]["result"]["frontier"]:
        raise AssertionError("serve: the warm start's answer differs")
    kernels = []
    for e in (err, warm_err):
        line = serve_line(e, "kernels ")
        if not line.startswith("kernels loaded") or cache not in line:
            raise AssertionError(f"serve: the kernels were not loaded "
                                 f"from {cache}: {line}")
        kernels.append(line)
    out = {"transcript_frames": len(got), "equal_to_numpy": True,
           "cold_wall_s": wall, "numpy_wall_s": ref_wall,
           "warm_wall_s": warm_wall,
           "registry_ready_cold_s": ready_seconds(err),
           "registry_ready_warm_s": ready_seconds(warm_err),
           "registry_ready_numpy_s": ready_seconds(ref_err),
           "kernels": kernels,
           "run_rounds": replies[3]["rounds"],
           "warm_n_evals": warm[3]["result"]["n_evals"]}
    emit({"phase": "service", "step": "serve_cli", **out})
    return out


def service_phase(dev) -> dict:
    """Phase 10: the advisory service on the card.  Returns the launches
    of the hetero and the per-design services and the hetero stats."""
    import dataclasses
    import shutil
    import tempfile
    from repro_torch.core import EvalConfig, FifoAdvisor
    from repro_torch.core.service import load_snapshot, save_snapshot
    cuda, numpy_cfg = EvalConfig(backend="cuda"), EvalConfig(backend="numpy")
    t0 = time.perf_counter()
    solo = {(d, o): FifoAdvisor(design_of(d), numpy_cfg).run(
        o, budget=SERVICE_BUDGET, seed=0) for d, o in service_mix()}
    solo_wall = time.perf_counter() - t0
    (_, ref), numpy_wall = wall_of(lambda: run_service(dev, numpy_cfg,
                                                       False))
    for key, dse in ref.items():
        same_session(f"numpy service {key}", dse, solo[key])
    kernels = ("fifo_eval", "fifo_eval_condensed", "fifo_eval_hetero")
    totals = dict.fromkeys(kernels, 0)
    out = {}

    def report(step, svc, results, wall, counts, **extra):
        for key, dse in results.items():
            same_session(f"{step} service {key}", dse, solo[key])
        for k in kernels:
            totals[k] += counts[k]
        regs = svc.registry
        escalated = sum(regs[n].evaluator.stats.n_fallbacks for n in regs)
        stats = svc.batcher.stats()
        emit({"phase": "service", "step": step,
              "sessions": len(results),
              "evals": sum(d.result.n_evals for d in results.values()),
              "rounds": svc.batcher.rounds, "wall_s": wall,
              "numpy_wall_s": numpy_wall, "solo_numpy_wall_s": solo_wall,
              "equal_to_numpy": True,
              "launches": {k: counts[k] for k in kernels},
              "fifo_eval_launches_by_rows": counts["fifo_eval_rows"],
              "fifo_eval_hetero_launches_by_rows":
                  counts["fifo_eval_hetero_rows"],
              "fifo_eval_hetero_launches_by_cluster":
                  counts["fifo_eval_hetero_clusters"],
              "fifo_eval_condensed_launches_by_rows":
                  counts["fifo_eval_condensed_rows"],
              "escalated_per_design": escalated,
              "hetero_stats": stats.get("hetero_stats"), **extra})
        out[step] = {"counts": counts, "stats": stats.get("hetero_stats")}

    # 1. every session's full-solve rows of a round in one K2 launch in
    # its per-design-table mode
    (svc, results), wall, counts = run_step(
        lambda: run_service(dev, cuda, True))
    if counts["fifo_eval_hetero"] == 0:
        raise AssertionError("the hetero service launched no K2 in its "
                             "per-design-table mode")
    report("hetero", svc, results, wall, counts,
           e_pad=svc.batcher.router.hetero.e_pad)
    svc.close()

    # 2. per-design: each advisor's RungCascade, so K1 and K2
    (svc, results), wall, counts = run_step(
        lambda: run_service(dev, cuda, False))
    for k in ("fifo_eval", "fifo_eval_condensed"):
        if counts[k] == 0:
            raise AssertionError(f"the per-design service never launched "
                                 f"{k}")
    report("per_design", svc, results, wall, counts)

    # 3. warm restart from a snapshot of the per-design registry
    tmp = tempfile.mkdtemp(prefix="chip_smoke_service_")
    try:
        snap = os.path.join(tmp, "snapshot")
        manifest, save_wall = wall_of(lambda: save_snapshot(svc.registry,
                                                            snap))
        svc.close()
        if manifest["skipped"] != ["flowgnn_pna"]:
            raise AssertionError(f"snapshot skipped {manifest['skipped']}")
        reg, load_wall = wall_of(lambda: load_snapshot(snap, device=dev))
        named = [d for d in SERVICE_DESIGNS if d != "flowgnn_pna"]
        if sorted(reg.names()) != sorted(named):
            raise AssertionError(f"restored {reg.names()}")

        def warm_runs():
            return {d: reg[d].run("grouped_sa", budget=SERVICE_BUDGET,
                                  seed=0) for d in named}
        warm, warm_wall, counts = run_step(warm_runs)
        for d, dse in warm.items():
            if dse.result.n_evals != 0:
                raise AssertionError(f"warm {d}: {dse.result.n_evals} "
                                     f"fresh evaluations")
            same_session(f"warm {d}", dse, solo[(d, "grouped_sa")])

        def cold_registry():
            from repro_torch.core.service import DesignRegistry
            cold = DesignRegistry(cuda, device=dev)
            for d in named:
                cold.register(d)
            return cold
        _, cold_wall = wall_of(cold_registry)
        emit({"phase": "service", "step": "warm_restart",
              "restored": reg.names(), "skipped": manifest["skipped"],
              "save_s": save_wall, "registry_ready_warm_s": load_wall,
              "registry_ready_cold_s": cold_wall,
              "grouped_sa_wall_s": warm_wall, "n_evals": 0,
              "launches": {k: counts[k] for k in kernels},
              "equal_to_numpy": True})

        # 4. the serve CLI, cold and warm, against numpy's
        out["serve_cli"] = serve_cli(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["totals"] = totals
    return out


# ------------------------------------------------------- mesh (phase 11)
def shard_counts(prefix: str, n: int) -> list:
    """Each shard's launches of closure kind ``prefix`` (DISPATCH_COUNTS
    counts one per shard and call; on the card each is one kernel)."""
    from repro_torch.kernels.fifo_eval import ops
    return [ops.DISPATCH_COUNTS.get(f"{prefix}@shard{i}", 0)
            for i in range(n)]


def check_shards(label: str, counts: dict, n: int, kinds) -> dict:
    """Every shard launched each closure kind of ``kinds`` (``{kind:
    kernel counter}``), and the kernel counters equal the shards' sum
    plus the unsharded launches (the escalation tier's, on the mesh's
    first device: every call counts once under ``kind``, a sharded one
    also once under each shard)."""
    by_shard = {}
    for kind, kernel in kinds.items():
        per = [counts["dispatch"].get(f"{kind}@shard{i}", 0)
               for i in range(n)]
        if min(per) == 0:
            raise AssertionError(f"{label}: {kernel} never launched on "
                                 f"some shard: {per}")
        unsharded = counts["dispatch"].get(kind, 0) - per[0]
        if sum(per) + unsharded != counts[kernel]:
            raise AssertionError(f"{label}: {kernel} launched "
                                 f"{counts[kernel]} times, the shards "
                                 f"{per}, unsharded {unsharded}")
        by_shard[kernel] = per
    return by_shard


def mesh_rows(g, seed: int):
    """MESH_BATCHES[0] rows: half inside the routing box (K1's rung), half
    below its floor (K2's backstop), shuffled so every shard gets both."""
    import numpy as np
    half = MESH_BATCHES[0] // 2
    rows = np.concatenate([box_rows(g, half, seed),
                           low_rows(g, half, seed + 1)])
    return rows[np.random.default_rng(seed).permutation(len(rows))]


def mesh_phase(dev, quick_numpy) -> dict:
    """Phase 11: row sharding over a mesh of devices on the one card.
    ``quick_numpy`` is phase 6's numpy campaign over QUICK_DESIGNS.
    Returns the kernels' launches, by shard and by rows."""
    import dataclasses
    import numpy as np
    from repro_torch.core import BatchedEvaluator, EvalConfig, FifoAdvisor
    from repro_torch.core.campaign import Campaign
    from repro_torch.designs import QUICK_DESIGNS, make_design
    from repro_torch.launch.mesh import make_campaign_mesh, make_eval_mesh
    cuda, numpy_cfg = EvalConfig(backend="cuda"), EvalConfig(backend="numpy")
    kernels = ("fifo_eval", "fifo_eval_condensed", "fifo_eval_hetero")
    totals = dict.fromkeys(kernels, 0)
    by_shard = {}
    by_rows = {"fifo_eval": {}, "fifo_eval_condensed": {}}
    evaluators = {
        "shards1": lambda g: BatchedEvaluator(
            g, EvalConfig(backend="mesh", shards=1), device=dev),
        f"cuda0x{MESH_SHARDS}": lambda g: BatchedEvaluator(
            g, EvalConfig(backend="mesh"), mesh=make_eval_mesh(
                MESH_SHARDS, devices=[MESH_DEVICE] * MESH_SHARDS))}
    rung_keys = ("n_condensed", "n_cond_fail", "n_fallbacks")
    for name in MESH_DESIGNS:
        g = raw_graph(name)
        rows = mesh_rows(g, seed=11)
        want = {c: BatchedEvaluator(g, numpy_cfg).evaluate(rows[:c])
                for c in MESH_BATCHES}
        BatchedEvaluator(g, cuda, device=dev)     # condenses g once

        def solo():
            ev = BatchedEvaluator(g, cuda, device=dev)
            return ev, [ev.evaluate(rows[:c]) for c in MESH_BATCHES]
        (ev, res), solo_wall, _ = run_step(solo)
        solo_rungs = {k: getattr(ev.stats, k) for k in rung_keys}
        for setup, make in evaluators.items():
            def sharded():
                ev = make(g)
                return ev, [ev.evaluate(rows[:c]) for c in MESH_BATCHES]
            (ev, res), wall, counts = run_step(sharded)
            n = ev._impl.n_shards
            for c, got in zip(MESH_BATCHES, res):
                for a, b in zip(got, want[c]):
                    if not np.array_equal(a, b):
                        raise AssertionError(f"mesh {setup} {name} {c} "
                                             f"rows: differs from numpy")
            rungs = {k: getattr(ev.stats, k) for k in rung_keys}
            if rungs != solo_rungs:
                raise AssertionError(f"mesh {setup} {name}: rung counts "
                                     f"{rungs}, unsharded {solo_rungs}")
            shards = check_shards(f"mesh {setup} {name}", counts, n,
                                  {"batched": "fifo_eval",
                                   "condensed": "fifo_eval_condensed"})
            for k in kernels:
                totals[k] += counts[k]
            for k in by_rows:
                for r, m in counts[k + "_rows"].items():
                    by_rows[k][r] = by_rows[k].get(r, 0) + m
            for k, per in shards.items():
                by_shard.setdefault(setup, {}).setdefault(k, [0] * n)
                by_shard[setup][k] = [a + b for a, b in
                                      zip(by_shard[setup][k], per)]
            emit({"phase": "mesh", "design": name, "setup": setup,
                  "shards": n, "batches": list(MESH_BATCHES),
                  "wall_s": wall, "unsharded_wall_s": solo_wall,
                  "equal_to_numpy": True, "rungs": rungs,
                  "rungs_equal_to_unsharded": True,
                  "launches_by_shard": shards,
                  "launches_by_rows": {k: counts[k + "_rows"]
                                       for k in by_rows}})

    # the advisor on a one-shard mesh against numpy
    def advisor():
        return FifoAdvisor(make_design("gemm"), EvalConfig(
            backend="mesh", shards=1), device=dev).run(
            "grouped_sa", budget=MESH_BUDGET, seed=0)
    res, wall, counts = run_step(advisor)
    ref, ref_wall = wall_of(lambda: FifoAdvisor(
        make_design("gemm"), numpy_cfg).run("grouped_sa",
                                            budget=MESH_BUDGET, seed=0))
    same_search("mesh gemm grouped_sa", res, ref)
    for k in kernels:
        totals[k] += counts[k]
    emit({"phase": "mesh", "design": "gemm", "setup": "shards1",
          "optimizer": "grouped_sa", "budget": MESH_BUDGET,
          "wall_s": wall, "numpy_wall_s": ref_wall, "equal_to_numpy": True,
          "launches": {k: counts[k] for k in kernels}})

    # a hetero campaign on a 2x2 ("design", "eval") mesh over cuda:0
    ref_store, ref_wall = quick_numpy
    _, solo_wall, _ = run_step(lambda: Campaign(campaign_spec(
        QUICK_DESIGNS, eval=cuda, hetero=True, workers=0),
        device=dev).run())

    def campaign():
        mesh = make_campaign_mesh(2, 2, devices=[MESH_DEVICE] * 4)
        camp = Campaign(campaign_spec(QUICK_DESIGNS, eval=cuda, hetero=True,
                                      workers=0), device=dev, mesh=mesh)
        return camp, camp.run()
    (camp, store), wall, counts = run_step(campaign)
    same_store("mesh hetero campaign", store, ref_store)
    shards = check_shards("mesh hetero campaign", counts, 4,
                          {"hetero": "fifo_eval_hetero"})
    for k in kernels:
        totals[k] += counts[k]
    by_shard["campaign_2x2"] = shards
    emit({"phase": "mesh", "mode": "hetero_campaign", "mesh": [2, 2],
          "designs": list(QUICK_DESIGNS), "wall_s": wall,
          "unsharded_wall_s": solo_wall, "numpy_wall_s": ref_wall,
          "equal_to_numpy": True, "launches_by_shard": shards,
          "fifo_eval_hetero_launches_by_rows":
              counts["fifo_eval_hetero_rows"],
          "hetero_stats": dataclasses.asdict(camp.hetero.stats),
          "note": "every shard runs on the one card, in turn: no speed-up "
                  "is expected"})
    return {"totals": totals, "by_shard": by_shard, "by_rows": by_rows}


def synced(dev, out):
    """``out`` once the card has finished the work queued for it."""
    import torch
    torch.cuda.synchronize(dev)
    return out


# ------------------------------------------------- LLM serving (phase 12)
def llm_inputs(cfg, b: int, s: int, n_decode: int, seed: int):
    """(prompt tokens (b, s - F), frontend embeds or None, decode tokens
    (b, n_decode)) from a seeded numpy generator."""
    import numpy as np
    rng = np.random.default_rng(seed)
    F = cfg.frontend_tokens
    toks = rng.integers(0, cfg.vocab, (b, s - F)).astype(np.int64)
    embeds = (rng.standard_normal((b, F, cfg.d_model)).astype(np.float32)
              if F else None)
    dec = rng.integers(0, cfg.vocab, (b, n_decode)).astype(np.int64)
    return toks, embeds, dec


def llm_logits(cfg, params, toks, embeds, dec, dev, cdt) -> list:
    """The prefill step's last logits, then each teacher-forced decode
    step's logits, on ``dev`` (float32 numpy)."""
    import torch
    from repro_torch.models.transformer import forward
    from repro_torch.train.steps import make_prefill_step
    s = toks.shape[1] + cfg.frontend_tokens
    e = None if embeds is None else torch.as_tensor(embeds, device=dev)
    last, cache = make_prefill_step(cfg, s + dec.shape[1], cdt=cdt)(
        params, torch.as_tensor(toks, device=dev), e)
    out = [last.float().cpu().numpy()]
    with torch.no_grad():
        for j in range(dec.shape[1]):
            logits, cache = forward(
                cfg, params, torch.as_tensor(dec[:, j:j + 1], device=dev),
                cache=cache, cache_index=s + j, cdt=cdt)
            out.append(logits[:, -1].float().cpu().numpy())
    return out


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    import numpy as np
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def within(got, want, tol: float) -> bool:
    """``np.allclose`` at ``rtol=tol, atol=tol * max|want|`` (the CPU
    tests' rule)."""
    import numpy as np
    want = np.asarray(want, np.float64)
    return bool(np.allclose(np.asarray(got, np.float64), want, rtol=tol,
                            atol=tol * float(np.abs(want).max())))


def llm_bounds(cfg, n_params: int, cdt) -> dict:
    """The least time the card could take for phase 12's full-width
    prefill and for one decode step: the larger of the bytes over the HBM
    rate and the products over the peak rate of their type (the
    projections in ``cdt``, the unembedding in float32; causal attention
    counted over whole (Q, S) tiles, as the port computes it).  Bytes:
    the float32 weights read once (in bf16 also the cast copy written
    and read), the cache read and the logits written."""
    import torch
    vpad = -(-cfg.vocab // 16) * 16
    d, L, hd = cfg.d_model, cfg.n_layers, cfg.head_dim_
    bf16 = cdt == torch.bfloat16
    peak = BF16_OPS_PER_S if bf16 else F32_OPS_PER_S
    esize = 2 if bf16 else 4
    weights = 4 * n_params + (4 * n_params if bf16 else 0)
    unembed = 2 * d * vpad                       # float32 flops per token
    proj = 2 * n_params - unembed                # cdt flops per token

    def bound(tokens, ctx, cache_bytes):
        attn = 4 * L * cfg.n_heads * hd * tokens * ctx
        ops_s = (proj * tokens + attn) / peak + unembed * tokens \
            / F32_OPS_PER_S
        bytes_s = (weights + cache_bytes + 4 * tokens * vpad) \
            / HBM_BYTES_PER_S
        return max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s
                                     else "bytes")
    tokens = LLM_BATCH * LLM_PROMPT
    pre, pre_by = bound(tokens, LLM_PROMPT, 0)
    cache = 2 * L * LLM_BATCH * (LLM_PROMPT + LLM_GEN) * \
        cfg.n_kv_heads * hd * esize
    step, step_by = bound(LLM_BATCH, LLM_PROMPT + LLM_GEN, cache)
    return {"prefill_bound_s": pre, "prefill_bound_by": pre_by,
            "decode_step_bound_s": step, "decode_bound_by": step_by,
            "decode_bound_tok_per_s": LLM_BATCH / step}


def llm_phase(dev) -> dict:
    """Phase 12: the LLM serving path on the card (see the docstring)."""
    import numpy as np
    import torch
    from repro_torch.configs import ARCHS, get_arch
    from repro_torch.launch import decode_demo
    from repro_torch.models import params as pm
    from repro_torch.models.transformer import forward, model_specs
    from repro_torch.train.steps import make_decode_step, make_prefill_step
    flags = decode_demo.no_tf32()
    emit({"phase": "llm", "step": "tf32_off", **flags})
    cpu = torch.device("cpu")
    out = {}
    # (a) the demo on every reduced arch, batch 4
    for arch in sorted(ARCHS):
        with contextlib.redirect_stdout(sys.stderr):    # its own prints
            r, wall = wall_of(lambda: decode_demo.main(
                ["--arch", arch, "--batch", "4", "--device", str(dev)]))
        vpad = -(-get_arch(arch).reduced().vocab // 16) * 16
        if set(r) != {"prefill_s", "decode_s", "tok_per_s", "tokens"} \
                or r["tokens"].shape != (4, 16) \
                or not ((r["tokens"] >= 0) & (r["tokens"] < vpad)).all():
            raise AssertionError(f"decode_demo {arch}: {r}")
        emit({"phase": "llm", "step": "decode_demo", "arch": arch,
              "wall_s": wall, "prefill_s": r["prefill_s"],
              "decode_s": r["decode_s"], "tok_per_s": r["tok_per_s"],
              "tokens0": r["tokens"][0].tolist()})
    # (b) each reduced arch: the card against the CPU, same weights and
    # inputs, float32
    worst = 0.0
    for arch in sorted(ARCHS):
        cfg = get_arch(arch).reduced()
        host = pm.materialize(model_specs(cfg),
                              torch.Generator().manual_seed(0))
        card = pm.tree_map(lambda t: t.to(dev), host)
        inputs = llm_inputs(cfg, 2, 16, 3, seed=7)
        want = llm_logits(cfg, host, *inputs, cpu, torch.float32)
        got = llm_logits(cfg, card, *inputs, dev, torch.float32)
        errs = [rel_err(g, w) for g, w in zip(got, want)]
        if not all(within(g, w, LLM_F32_TOL) for g, w in zip(got, want)):
            raise AssertionError(f"{arch}: card and CPU logits differ "
                                 f"beyond {LLM_F32_TOL}: {errs}")
        worst = max(worst, max(errs))
        emit({"phase": "llm", "step": "card_vs_cpu", "arch": arch,
              "tol": LLM_F32_TOL, "max_err_over_max": max(errs),
              "equal_within_tol": True})
    out["card_vs_cpu_max_err"] = worst
    # (c) qwen2-1.5b at full width
    cfg = get_arch(LLM_FULL_ARCH)
    torch.cuda.reset_peak_memory_stats(dev)
    params, init_s = wall_of(lambda: pm.materialize(
        model_specs(cfg), torch.Generator(device=dev).manual_seed(0)))
    torch.cuda.synchronize(dev)
    n_params = sum(t.numel() for t in pm.tree_leaves(params))
    toks, _, _ = llm_inputs(cfg, LLM_BATCH, LLM_PROMPT, 0, seed=1)
    prompt = torch.as_tensor(toks, device=dev)
    failed = []
    for cdt, tol in ((torch.float32, LLM_FULL_F32_TOL),
                     (torch.bfloat16, LLM_FULL_BF16_TOL)):
        torch.cuda.reset_peak_memory_stats(dev)
        prefill = make_prefill_step(cfg, LLM_PROMPT + LLM_GEN, cdt=cdt)
        decode = make_decode_step(cfg, cdt=cdt)

        (last, cache), prefill_s = wall_of(
            lambda: synced(dev, prefill(params, prompt)))
        tok = torch.argmax(last, -1).to(torch.int32)[:, None]
        gen = [tok]
        step_logits = []
        t0 = time.perf_counter()
        with torch.no_grad():
            for i in range(LLM_GEN):
                logits, cache = forward(cfg, params, tok, cache=cache,
                                        cache_index=LLM_PROMPT + i,
                                        cdt=cdt)
                step_logits.append(logits[:, -1].float())
                tok = torch.argmax(logits[:, -1], -1).to(
                    torch.int32)[:, None]
                gen.append(tok)
        torch.cuda.synchronize(dev)
        decode_s = time.perf_counter() - t0
        # the decode step as a user calls it, from the same cache state
        _, cache2 = prefill(params, prompt)
        t1 = time.perf_counter()
        tok2 = gen[0]
        for i in range(LLM_GEN):
            nxt, cache2 = decode(params, cache2, tok2, LLM_PROMPT + i)
            tok2 = nxt[:, None]
            if not torch.equal(tok2, gen[i + 1]):
                raise AssertionError(f"{LLM_FULL_ARCH} {cdt}: decode step "
                                     f"{i} picked other tokens than the "
                                     f"forward it wraps")
        torch.cuda.synchronize(dev)
        decode_step_s = time.perf_counter() - t1
        peak = torch.cuda.max_memory_allocated(dev)
        del cache, cache2
        # one full forward over prompt + generated tokens; causal, so
        # padding it to a whole number of Q_CHUNK chunks changes nothing
        # at the positions compared
        seq = torch.cat([prompt.to(torch.int32)] + gen[:-1], dim=1)
        from repro_torch.models.attention import Q_CHUNK
        pad = -seq.shape[1] % Q_CHUNK
        seq = torch.cat([seq, torch.zeros((LLM_BATCH, pad),
                                          dtype=seq.dtype, device=dev)], 1)
        with torch.no_grad():
            full, _ = forward(cfg, params, seq, return_cache=False,
                              cdt=cdt)
            want = full[:, LLM_PROMPT:LLM_PROMPT + LLM_GEN].float()
            want_last = full[:, LLM_PROMPT - 1].float()
            got = torch.stack(step_logits, dim=1)
            want, want_last, got = (want.cpu().numpy(),
                                    want_last.cpu().numpy(),
                                    got.cpu().numpy())
        del full
        errs = {"decode": rel_err(got, want),
                "prefill_last": rel_err(last.float().cpu().numpy(),
                                        want_last)}
        argmax_agree = float((got.argmax(-1) == want.argmax(-1)).mean())
        ok = within(got, want, tol) and within(
            last.float().cpu().numpy(), want_last, tol)
        row = {"phase": "llm", "step": "full_width", "arch": LLM_FULL_ARCH,
               "cdt": str(cdt).replace("torch.", ""), "n_params": n_params,
               "layers": cfg.n_layers, "d_model": cfg.d_model,
               "vocab": cfg.vocab, "batch": LLM_BATCH,
               "prompt": LLM_PROMPT, "generated": LLM_GEN,
               "materialize_s": init_s, "prefill_s": prefill_s,
               "decode_s": decode_s,
               "decode_tok_per_s": LLM_BATCH * LLM_GEN / decode_s,
               "decode_step_s": decode_step_s,
               "decode_step_tok_per_s": LLM_BATCH * LLM_GEN / decode_step_s,
               "max_memory_allocated": peak,
               **llm_bounds(cfg, n_params, cdt), "tol": tol,
               "max_err_over_max": errs, "argmax_agree": argmax_agree,
               "decode_vs_forward_within_tol": ok}
        emit(row)
        if not ok:
            failed.append(f"{LLM_FULL_ARCH} {cdt}: decode logits differ "
                          f"from the full forward beyond {tol}: {errs}")
        out[row["cdt"]] = row
    if failed:
        raise AssertionError("; ".join(failed))
    return out


# ------------------------------------------------- LLM training (phase 13)
def train_batch(raw: dict, dev) -> dict:
    """A ``SyntheticLM`` batch as tensors on ``dev``."""
    import torch
    return {k: torch.as_tensor(v, device=dev) for k, v in raw.items()}


def train_grads(cfg, params, batch, cdt, remat: bool = True):
    """(loss, aux, gradient leaves) of ``loss_fn`` over every parameter
    leaf, as the train step takes them."""
    import torch
    from repro_torch.models import params as pm
    from repro_torch.train.steps import loss_fn
    live = pm.tree_map(lambda t: t.detach().requires_grad_(), params)
    loss, aux = loss_fn(cfg, live, batch, cdt, remat=remat)
    grads = torch.autograd.grad(loss, pm.tree_leaves(live))
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads


def dev_err(got, want) -> float:
    """max |got - want| over max |want|, on the tensors' device."""
    want = want.double()
    return float((got.double() - want).abs().max() / want.abs().max())


def dev_within(got, want, tol: float, keep=None) -> bool:
    """``within`` on the tensors' device; ``keep`` masks the elements
    compared (the scale stays the whole leaf's)."""
    import torch
    scale = float(want.abs().max())
    if keep is not None:
        got, want = got[keep], want[keep]
    return bool(torch.allclose(got.double(), want.double(), rtol=tol,
                               atol=tol * scale))


def run_cli(cmds: dict, env) -> dict:
    """Run ``python -m repro_torch.launch.train ARGS`` for every entry of
    ``cmds`` at once, each in a fresh process; returns each one's stdout
    and the dict it prints last.  Any process that fails stops them all."""
    import ast
    procs = {}
    try:
        for name, args in cmds.items():
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.train", *args],
                env=env, cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
        out = {}
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=600)
            if p.returncode != 0:
                raise AssertionError(f"train CLI {cmds[name]} exited "
                                     f"{p.returncode}:\n{stdout[-3000:]}\n"
                                     f"{stderr[-3000:]}")
            out[name] = {"stdout": stdout, **ast.literal_eval(
                stdout.strip().splitlines()[-1])}
        return out
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def train_cli(tmp: str) -> dict:
    """Phase 13 (b): the train CLI resumes, a split run matches a straight
    one, and MiniCPM's loss falls."""
    env = dict(os.environ, PYTHONPATH=SRC)

    def qwen(steps: int, ckpt: str) -> list:
        return ["--arch", "qwen2-1.5b", "--steps", str(steps), "--batch",
                "2", "--seq", "32", "--ckpt", os.path.join(tmp, ckpt),
                "--save-every", "3", "--log-every", "100"]
    t0 = time.perf_counter()
    first = run_cli({"straight": qwen(6, "a"), "split3": qwen(3, "b"),
                     "minicpm": ["--arch", "minicpm-2b", "--steps", "100"]},
                    env)
    second = run_cli({"again": qwen(6, "a"), "split6": qwen(6, "b")}, env)
    wall = time.perf_counter() - t0
    straight, minicpm = first["straight"], first["minicpm"]
    again, split = second["again"], second["split6"]
    gap = abs(split["last_loss"] - straight["last_loss"])
    checks = {
        "resumed_with_nothing_left": again["steps"] == 0
        and "resumed from step 6" in again["stdout"],
        "split_resumed_at_3": split["steps"] == 3
        and "resumed from step 3" in split["stdout"],
        "split_matches_straight": gap < TRAIN_CLI_SPLIT_TOL,
        "minicpm_loss_falls": minicpm["last_loss"] < minicpm["first_loss"]}
    row = {"phase": "train", "step": "cli", "wall_s": wall,
           "straight_last_loss": straight["last_loss"],
           "split_last_loss": split["last_loss"], "split_gap": gap,
           "split_tol": TRAIN_CLI_SPLIT_TOL,
           "minicpm_first_loss": minicpm["first_loss"],
           "minicpm_last_loss": minicpm["last_loss"], **checks}
    emit(row)
    if not all(checks.values()):
        raise AssertionError(f"train CLI: {row}")
    return row


def train_bound(n_params: int, cdt) -> dict:
    """The least time the card could take for one full-width train step:
    the larger of 8 N operations a token (forward, backward, and remat's
    second forward) over the peak rate of ``cdt``, and the bytes of the
    float32 parameters and both AdamW moments, each read and written once
    (24 N), over the HBM rate."""
    import torch
    peak = BF16_OPS_PER_S if cdt == torch.bfloat16 else F32_OPS_PER_S
    ops_s = 8 * n_params * TRAIN_BATCH * TRAIN_SEQ / peak
    bytes_s = 24 * n_params / HBM_BYTES_PER_S
    return {"bound_s": max(ops_s, bytes_s),
            "bound_by": "operations" if ops_s >= bytes_s else "bytes",
            "bound_tok_per_s": TRAIN_BATCH * TRAIN_SEQ / max(ops_s,
                                                             bytes_s)}


def train_full_width(dev) -> dict:
    """Phase 13 (c): qwen2-1.5b at full width, float32 master weights and
    AdamW state on the card.  The state is not checkpointed here: its
    parameters and moments alone are 18.5 GB of ``.npy`` files, which
    would take longer to write than the whole phase may (phase 13 (b)
    and the CPU tests hold the checkpoints)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import params as pm
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.steps import (init_train_state, make_eval_step,
                                         make_train_step)
    cfg = get_arch(LLM_FULL_ARCH)
    (params, opt), init_s = wall_of(lambda: synced(dev, init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)))
    n_params = sum(t.numel() for t in pm.tree_leaves(params))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH, seed=0), arch=cfg)
    batches = [train_batch(data.batch(s), dev) for s in range(TRAIN_STEPS)]
    out = {"n_params": n_params, "init_s": init_s}
    failed = []

    # the eval step on the initial state
    ev = synced(dev, make_eval_step(cfg, cdt=torch.float32)(params,
                                                            batches[0]))
    # remat on and off: the same gradients, less memory with remat
    half = {k: v[:TRAIN_REMAT_ROWS] for k, v in batches[0].items()}
    grads, peaks, secs = {}, {}, {}
    for remat in (True, False):
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        (_, _, grads[remat]), secs[remat] = wall_of(lambda: synced(
            dev, train_grads(cfg, params, half, torch.float32,
                             remat=remat)))
        peaks[remat] = torch.cuda.max_memory_allocated(dev) - base
    remat_err = max(dev_err(a, b) for a, b in zip(grads[True],
                                                   grads[False]))
    remat_ok = all(dev_within(a, b, LLM_FULL_F32_TOL)
                   for a, b in zip(grads[True], grads[False]))
    del grads
    row = {"phase": "train", "step": "remat", "arch": LLM_FULL_ARCH,
           "batch": TRAIN_REMAT_ROWS, "seq": TRAIN_SEQ,
           "grads_max_err_over_max": remat_err, "tol": LLM_FULL_F32_TOL,
           "equal_within_tol": remat_ok,
           "peak_bytes_above_state_remat": peaks[True],
           "peak_bytes_above_state_no_remat": peaks[False],
           "grad_s_remat": secs[True], "grad_s_no_remat": secs[False]}
    emit(row)
    if not remat_ok:
        failed.append(f"remat on/off gradients differ: {remat_err}")
    if not peaks[True] < peaks[False]:
        failed.append(f"remat does not lower peak memory: {peaks}")
    out["remat"] = row

    # accum=2 from a copy of the same state, against the first accum=1
    # step below
    params2 = pm.tree_map(lambda t: t.clone(), params)
    opt2 = pm.tree_map(lambda t: t.clone(), opt)
    params2, opt2, met2 = synced(dev, make_train_step(
        cfg, OptConfig(), cdt=torch.float32, accum=2)(params2, opt2,
                                                      batches[0]))

    for cdt in (torch.float32, torch.bfloat16):
        step = make_train_step(cfg, OptConfig(), cdt=cdt)
        if cdt == torch.bfloat16:
            # the float32 loss of the state the bf16 steps start from, on
            # their first batch (which the float32 steps trained on)
            ev = make_eval_step(cfg, cdt=torch.float32)(params, batches[0])
        times, mets = [], []
        for i in range(TRAIN_STEPS):
            (params, opt, met), s = wall_of(lambda: synced(
                dev, step(params, opt, batches[i])))
            times.append(s)
            mets.append({k: float(v) for k, v in met.items()})
            if cdt == torch.float32 and i == 0:
                checks = train_first_step_checks(ev, met, met2, params, opt,
                                                 params2, opt2)
                del params2, opt2
                emit({"phase": "train", "step": "first_step_checks",
                      **checks})
                failed += [f"{k}: {checks}" for k, v in checks.items()
                           if v is False]
                out["first_step"] = checks
            if i == 0:
                # the peak of the steady steps: the first float32 step
                # runs beside the accum=2 copy of the state
                torch.cuda.reset_peak_memory_stats(dev)
        peak = torch.cuda.max_memory_allocated(dev)
        s_per_step = sum(times[1:]) / (len(times) - 1)
        name = str(cdt).replace("torch.", "")
        # one more step under the profiler: how far the host holds the
        # card back
        (params, opt, _), wall, busy, top = profiled(
            lambda: step(params, opt, batches[0]))
        emit_profile(LLM_FULL_ARCH, f"train_step_{name}", wall, busy, top)
        row = {"phase": "train", "step": "full_width", "arch": LLM_FULL_ARCH,
               "cdt": name, "n_params": n_params, "layers": cfg.n_layers,
               "d_model": cfg.d_model, "vocab": cfg.vocab,
               "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
               "step_s": times, "s_per_step": s_per_step,
               "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / s_per_step,
               "max_memory_allocated": peak,
               "loss": [m["loss"] for m in mets],
               "grad_norm": [m["grad_norm"] for m in mets],
               "lr": [m["lr"] for m in mets],
               "profiled_step_s": wall,
               "device_idle_share": (1 - busy / wall) if busy is not None
               else "not measured", **train_bound(n_params, cdt)}
        if cdt == torch.bfloat16:
            row.update(float32_eval_loss=float(ev["loss"]),
                       bf16_vs_float32_loss_err=rel_err(
                           row["loss"][0], float(ev["loss"])),
                       tol=LLM_FULL_BF16_TOL)
            if not within(row["loss"][0], float(ev["loss"]),
                          LLM_FULL_BF16_TOL):
                failed.append(f"bf16 loss {row['loss'][0]} is not the "
                              f"float32 loss {float(ev['loss'])}")
        emit(row)
        if not all(torch.isfinite(torch.tensor(row["loss"] +
                                               row["grad_norm"]))):
            failed.append(f"{name}: loss or grad_norm not finite: {row}")
        out[name] = row
    if failed:
        raise AssertionError("; ".join(failed))
    return out


def train_first_step_checks(ev, met, met2, params, opt, params2,
                            opt2) -> dict:
    """The first float32 step against the eval step on the same state
    and batch, and against ``accum=2`` from a copy of that state: loss,
    ``grad_norm``, both moments and, where the update is well conditioned
    (the reference test's rule: ``|m| > 1e-3 max|m|`` on the leaf, or
    ``m == 0``), the updated parameters."""
    from repro_torch.models import params as pm
    tol = LLM_FULL_F32_TOL
    out = {"eval_loss": float(ev["loss"]), "train_loss": float(met["loss"]),
           "accum2_loss": float(met2["loss"]),
           "grad_norm": float(met["grad_norm"]),
           "accum2_grad_norm": float(met2["grad_norm"]), "tol": tol}
    out["eval_equal"] = within(out["train_loss"], out["eval_loss"],
                               TRAIN_LOSS_TOL)
    out["accum_loss_equal"] = within(out["accum2_loss"], out["train_loss"],
                                     TRAIN_LOSS_TOL)
    out["accum_grad_norm_equal"] = within(out["accum2_grad_norm"],
                                          out["grad_norm"], tol)
    errs = {"m": 0.0, "v": 0.0, "params": 0.0}
    ok = True
    kept = total = 0
    for name, a_tree, b_tree in (("m", opt["m"], opt2["m"]),
                                 ("v", opt["v"], opt2["v"])):
        for a, b in zip(pm.tree_leaves(a_tree), pm.tree_leaves(b_tree)):
            errs[name] = max(errs[name], dev_err(a, b))
            ok &= dev_within(a, b, tol)
    for a, b, m in zip(pm.tree_leaves(params), pm.tree_leaves(params2),
                       pm.tree_leaves(opt2["m"])):
        m = m.abs()
        keep = (m == 0) | (m > 1e-3 * m.max())
        kept, total = kept + int(keep.sum()), total + keep.numel()
        errs["params"] = max(errs["params"], float(
            (a - b)[keep].abs().max() / b.abs().max()))
        ok &= dev_within(a, b, tol, keep)
    out.update(accum_max_err_over_max=errs, accum_compared_share=kept / total,
               accum_state_equal=ok)
    return out


def train_phase(dev) -> dict:
    """Phase 13: LLM training on the card (see the docstring)."""
    import tempfile
    import torch
    from repro_torch.configs import ARCHS, get_arch
    from repro_torch.launch import decode_demo
    from repro_torch.models import params as pm
    from repro_torch.train.data import DataConfig, SyntheticLM
    from repro_torch.train.steps import init_train_state
    emit({"phase": "train", "step": "tf32_off", **decode_demo.no_tf32()})
    cpu = torch.device("cpu")
    out = {}
    # (a) each reduced arch: loss and every gradient leaf, the card
    # against the CPU, same weights and batch, float32
    worst = 0.0
    for arch in sorted(ARCHS):
        cfg = get_arch(arch).reduced()
        host, _ = init_train_state(cfg, torch.Generator().manual_seed(0))
        card = pm.tree_map(lambda t: t.to(dev), host)
        F = cfg.frontend_tokens
        raw = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=16 - F,
                                     global_batch=4, seed=3),
                          arch=cfg).batch(0)
        want_loss, want_aux, want = train_grads(
            cfg, host, train_batch(raw, cpu), torch.float32)
        got_loss, got_aux, got = train_grads(
            cfg, card, train_batch(raw, dev), torch.float32)
        errs = [rel_err(g.cpu().numpy(), w.numpy())
                for g, w in zip(got, want)]
        loss_err = rel_err(got_loss.cpu().numpy(), want_loss.numpy())
        ok = (within(got_loss.cpu().numpy(), want_loss.numpy(),
                     TRAIN_LOSS_TOL)
              and float(got_aux["tokens"]) == float(want_aux["tokens"])
              and all(within(g.cpu().numpy(), w.numpy(), TRAIN_GRAD_TOL)
                      for g, w in zip(got, want)))
        emit({"phase": "train", "step": "card_vs_cpu", "arch": arch,
              "loss": float(want_loss), "loss_err": loss_err,
              "loss_tol": TRAIN_LOSS_TOL, "grad_leaves": len(errs),
              "grad_max_err_over_max": max(errs), "grad_tol": TRAIN_GRAD_TOL,
              "equal_within_tol": ok})
        if not ok:
            raise AssertionError(f"{arch}: card and CPU loss or gradients "
                                 f"differ: loss {loss_err}, grads {errs}")
        worst = max(worst, max(errs))
    out["card_vs_cpu_max_err"] = worst
    # (b) the train CLI in fresh processes
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        out["cli"] = train_cli(tmp)
    # (c) qwen2-1.5b at full width
    out.update(train_full_width(dev))
    return out


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


def profiled(fn):
    """``fn()`` under ``torch.profiler``: (result, wall seconds, device
    busy seconds or None, the six largest device entries in µs).  Device
    busy time is the sum of the device-side activities the profiler
    records (kernels and copies).  Only device activity is recorded:
    host ops would slow the run and their summary takes longer than the
    run itself."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0) or 0
        if us > 0 and e.device_type == DeviceType.CUDA:
            by_name[e.key] = by_name.get(e.key, 0) + us
    busy = sum(by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return out, wall, (busy if busy > 0 else None), \
        {k[:60]: v for k, v in top}


def emit_profile(design: str, step: str, wall: float, busy, top) -> None:
    # a trace with no device activity is a gap of the profiler, not of
    # the path (the launch counters of phases 4 and 5 show the kernels ran)
    emit({"phase": "profile", "design": design, "step": step,
          "wall_s": wall,
          "device_busy_s": busy if busy is not None else "not measured",
          "device_idle_share": (1 - busy / wall) if busy is not None
          else "not measured", "top_device_us": top})


def profile_paths(dev) -> None:
    """Where the time goes: phase 6's hetero campaign (construction
    included), phase 10's hetero service (construction included), then
    for each design of :data:`PROFILE_DESIGNS` a fresh
    ``grouped_sa`` run (trace, condensation and search) and, on a fresh
    advisor, phase 5's unseeded certification and ``vmap_search``, each
    under ``torch.profiler``."""
    from repro_torch.core import EvalConfig, FifoAdvisor
    from repro_torch.core.campaign import Campaign
    from repro_torch.core.deadlock import certify_min_depths
    from repro_torch.designs import FAST_DESIGNS
    _, wall, busy, top = profiled(lambda: Campaign(campaign_spec(
        FAST_DESIGNS, eval=EvalConfig(backend="cuda"), hetero=True,
        workers=0), device=dev).run())
    emit_profile("FAST_DESIGNS", "hetero_campaign", wall, busy, top)
    (svc, _), wall, busy, top = profiled(lambda: run_service(
        dev, EvalConfig(backend="cuda"), True))
    svc.close()
    emit_profile("SERVICE_DESIGNS", "hetero_service", wall, busy, top)
    for name in PROFILE_DESIGNS:
        _, wall, busy, top = profiled(lambda: FifoAdvisor(
            design_of(name), EvalConfig(backend="cuda")).run(
                "grouped_sa", budget=BUDGET, seed=0))
        emit_profile(name, "grouped_sa", wall, busy, top)
        adv = FifoAdvisor(design_of(name),
                          EvalConfig(backend="cuda", **PRUNING))
        _, wall, busy, top = profiled(
            lambda: certify_min_depths(adv.graph, adv.evaluator))
        emit_profile(name, "certify_unseeded", wall, busy, top)
        _, wall, busy, top = profiled(
            lambda: adv.run("vmap_search", budget=SEARCH_BUDGET, seed=0))
        emit_profile(name, "vmap_search", wall, busy, top)


def time_k2_hetero(dev, campaign: dict) -> list:
    """K2's per-design-table mode over FAST_DESIGNS at the hetero
    campaign's most frequent launch size, at its mean real rows per
    launch and at the dispatcher's bucket for that many rows, against its
    plain version and its bound (each design's tables counted once, plus
    the per-row operands)."""
    import torch
    from repro_torch.core.backends import HeteroDispatcher
    from repro_torch.designs import FAST_DESIGNS
    from repro_torch.kernels.fifo_eval.fifo_eval import (fifo_eval_hetero,
                                                         launch_shape)
    from repro_torch.kernels.fifo_eval.ref import fifo_eval_ref_hetero
    stats, by_rows = campaign["stats"], campaign["counts"][
        "fifo_eval_hetero_rows"]
    typical = max(by_rows.items(), key=lambda kv: (kv[1], kv[0]))[0]
    mean = max(1, round(stats["n_rows"] / stats["n_dispatches"]))
    bucket = next(b for b in HeteroDispatcher.BUCKETS if b >= mean)
    out_rows = []
    for shape, c in (("campaign_typical", typical), ("campaign_mean", mean),
                     ("campaign_mean_bucket", bucket)):
        tables, tor, rows, bounds, per_row, peak = hetero_batch(
            FAST_DESIGNS, c, dev)
        args, kw = hetero_args(tables, tor, rows, bounds)
        out, _ = fifo_eval_hetero(*args, **kw, max_iters=256)
        ms = cuda_ms(lambda: fifo_eval_hetero(*args, **kw, max_iters=256),
                     reps=5)
        plain = cuda_ms(lambda: fifo_eval_ref_hetero(
            *per_row, *rows, bounds, max_iters=256), reps=1)
        b, by = bound_ms(args + (tor, bounds), out)
        slowest = int(out[:, 3].max())
        out_rows.append(
            {"shape": shape, "design": "FAST_DESIGNS (per-design tables)",
             "designs": tables.n_designs, "rows": c, "e_pad": tables.e_pad,
             "cluster": launch_shape(c, tables.e_pad, dev)[0],
             "active": k2_active(dev, tables.e_pad),
             "iters_sum": int(out[:, 3].sum()), "iters_max": slowest,
             "ms": ms, "us_per_iter": ms * 1e3 / slowest, "plain_ms": plain,
             "bound_ms": b, "bound_by": by,
             "depth_operands_peak_mib": peak / 2**20})
        emit({"phase": "time", "kernel": "fifo_eval",
              "mode": "per-design tables", **out_rows[-1]})
    # the device memory the per-row operands take at the campaign's
    # largest launch
    largest = max(by_rows)
    peak = hetero_batch(FAST_DESIGNS, largest, dev)[-1]
    emit({"phase": "memory", "kernel": "fifo_eval",
          "mode": "per-design tables", "rows": largest,
          "depth_operands_peak_mib": peak / 2**20})
    return out_rows


def timings(dev) -> dict:
    from repro_torch.kernels.fifo_eval.condensed import fifo_eval_condensed
    from repro_torch.kernels.fifo_eval.condensed import (
        launch_shape as k1_launch_shape)
    from repro_torch.kernels.fifo_eval.fifo_eval import (fifo_eval,
                                                         launch_shape)
    from repro_torch.kernels.fifo_eval.ref import (fifo_eval_condensed_plain,
                                                   fifo_eval_plain)
    import numpy as np
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
    # phase 5's shape: one certification probe, the unseeded descent's
    # start row (max(max_occupancy, 1))
    k2_cases += [("cert_probe", name, raw_graph(name),
                  np.maximum(raw_graph(name).max_occupancy, 1)[None, :]
                  .astype(np.int32), False) for name in CERT_DESIGNS]
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


# ------------------------------------- placement and dry-run (phase 14)
def place_step(dev) -> dict:
    """Phase 14 (c): one train step of PLACE_ARCH as rank 0 of a fake
    group over PLACE_MESH, its shards real tensors on the card."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import params as pm
    from repro_torch.models.sharding import use_ctx
    from repro_torch.models.transformer import model_specs
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.steps import make_train_step

    cfg = get_arch(PLACE_ARCH)
    specs = model_specs(cfg)
    world = PLACE_MESH[0] * PLACE_MESH[1]
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, size=(PLACE_MESH[0], PLACE_SEQ + 1))
    with fake_world(world):
        mesh = make_production_mesh(shape=PLACE_MESH)
        with use_ctx(mesh) as ctx:
            shs = pm.shardings(specs, ctx)
            # each leaf drawn whole on the card, cut to rank 0's shard
            gen = torch.Generator(device=dev).manual_seed(0)
            params = {}
            for key in sorted(specs):
                params[key] = pm.place(
                    pm.materialize({key: specs[key]}, gen)[key], shs[key])
            opt = init_opt_state(params)
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            tok_sh = ctx.sharding(("batch", "seq"))
            batch = {k: pm.place({"t": torch.as_tensor(v, device=dev)},
                                 {"t": tok_sh})["t"]
                     for k, v in (("tokens", toks[:, :-1]),
                                  ("labels", toks[:, 1:]))}
            step = make_train_step(cfg, OptConfig())
            t0 = time.perf_counter()
            params, opt, metrics = step(params, opt, batch)
            torch.cuda.synchronize(dev)
            step_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated(dev)
            want = pm.shape_structs(specs, ctx)
            bad = []
            for tree in (params, opt["m"], opt["v"]):
                for t, w in zip(pm.tree_leaves(tree), pm.tree_leaves(want)):
                    local = t.to_local()
                    if (local.shape != w.to_local().shape
                            or t.placements != w.placements
                            or t.shape != w.shape
                            or local.device.type != dev.type):
                        bad.append((tuple(t.shape), tuple(local.shape),
                                    str(local.device)))
            n_local = sum(t.to_local().numel()
                          for t in pm.tree_leaves(params))
            state = base
            del params, opt, metrics, batch, want
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"phase 14 (c): {len(bad)} local shards differ "
                             f"from the dry-run's rank 0: {bad[:4]}")
    return {"arch": PLACE_ARCH, "mesh": list(PLACE_MESH),
            "tokens_per_data_rank": PLACE_SEQ,
            "n_params": pm.n_params(specs), "rank0_params": n_local,
            "state_bytes": state, "max_memory_allocated": peak,
            "step_s": step_s, "timing": "local compute, collectives faked",
            "shards_match_dry_run": True,
            "process_group_left": torch.distributed.is_initialized()}


def placement_phase(dev, llm: dict, train: dict) -> dict:
    """Phase 14: placement over several devices and the dry-run (see the
    docstring)."""
    import threading
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun

    cells = [dict(arch_name=a, shape_name=s, multi_pod=mp, device="cuda")
             for a, s, mp in PLACE_CELLS]
    local = [dict(arch_name=LLM_FULL_ARCH,
                  shape_name=ShapeConfig(f"{kind}_{TRAIN_BATCH}x{TRAIN_SEQ}",
                                         TRAIN_SEQ, TRAIN_BATCH, kind),
                  mesh_shape=(1, 1), device="cuda", cdt=cdt)
             for kind in ("train", "prefill")
             for cdt in (torch.float32, torch.bfloat16)]
    seven = dict(arch_name=PLACE_ARCH,
                 shape_name=ShapeConfig(f"train_{PLACE_MESH[0]}x{PLACE_SEQ}",
                                        PLACE_SEQ, PLACE_MESH[0], "train"),
                 mesh_shape=PLACE_MESH, device="cuda")
    jobs = cells[:5] + [seven] + cells[5:] + local      # longest first
    recs, pool_error = [], []

    def run_pool():
        try:
            recs.extend(dryrun.run_cells(jobs, PLACE_JOBS))
        except BaseException as e:     # raised again below, in this phase
            pool_error.append(e)
    t0 = time.perf_counter()
    pool = threading.Thread(target=run_pool)
    pool.start()
    try:
        step = place_step(dev)
    finally:
        step_wall = time.perf_counter() - t0
        pool.join()
        for r in recs:          # every record, also when (c) failed
            if r["status"] == "error":
                emit({"phase": "placement", "part": "error", **r})
    cells_wall = time.perf_counter() - t0
    if pool_error:
        raise pool_error[0]
    rec_of = dict(zip(map(id, jobs), recs))
    failed = [r for r in recs if r["status"] == "error"]
    if failed:
        raise AssertionError(f"phase 14: {len(failed)} dry-run cells "
                             f"failed: {[(r['arch'], r['shape'], r['mesh']) for r in failed]}")

    def brief(r):
        return {k: r.get(k) for k in (
            "arch", "shape", "mesh", "kind", "status", "chips", "memory",
            "hlo_flops", "compiled_flops_per_device", "hlo_bytes",
            "collectives", "collective_bytes_per_device", "roofline",
            "model_flops", "useful_compute_ratio", "lower_s", "reason")}
    for c in cells:
        emit({"phase": "placement", "part": "a", **brief(rec_of[id(c)])})
    statuses = [rec_of[id(c)]["status"] for c in cells]
    if statuses.count("ok") != 8 or statuses.count("skipped") != 2:
        raise AssertionError(f"phase 14 (a): statuses {statuses}")

    n = get_arch(LLM_FULL_ARCH).n_params()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    ratios = {}
    for c in local:
        r = rec_of[id(c)]
        name = str(c["cdt"]).replace("torch.", "")
        kind = r["kind"]
        measured = (train if kind == "train" else llm)[name][
            "max_memory_allocated"]
        per = 8 if kind == "train" else 2
        row = {"phase": "placement", "part": "b", "arch": LLM_FULL_ARCH,
               "kind": kind, "cdt": name, "batch": TRAIN_BATCH,
               "seq": TRAIN_SEQ, "memory": r["memory"],
               "measured_max_memory_allocated": measured,
               "predicted_over_measured": r["memory"]["total"] / measured,
               "hlo_flops": r["hlo_flops"], f"{per}_n_tokens": per * n * tokens,
               "flops_over_n_tokens_rule": r["hlo_flops"] / (per * n * tokens),
               "lower_s": r["lower_s"]}
        emit(row)
        ratios[f"{kind}_{name}"] = row["predicted_over_measured"]

    pred = rec_of[id(seven)]
    emit({"phase": "placement", "part": "c", **step,
          "dry_run_memory": pred["memory"],
          "measured_over_predicted": step["max_memory_allocated"]
          / pred["memory"]["total"],
          "dry_run_lower_s": pred["lower_s"]})
    if step["process_group_left"] or torch.distributed.is_initialized():
        raise AssertionError("phase 14: a process group outlived its part")
    return {"cells_wall_s": cells_wall, "step_wall_s": step_wall,
            "memory_ratios": ratios,
            "cell_seconds": {f"{r['arch']}|{r['shape']}|{r['mesh']}":
                             r.get("lower_s") for r in recs}}


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
    check_k2_hetero(dev, cmp)
    check_k1(dev, cmp)
    emit({"phase": "checks_done", "seconds":
          round(time.perf_counter() - t0, 3), "max_abs_err": cmp.err})

    t0 = time.perf_counter()
    launches, k1_rows = main_path(dev)
    emit({"phase": "main_path_done",
          "seconds": round(time.perf_counter() - t0, 3)})

    t0 = time.perf_counter()
    cert_search = certify_search()
    emit({"phase": "certify_search_done",
          "seconds": round(time.perf_counter() - t0, 3)})

    t0 = time.perf_counter()
    campaign = campaign_phase(dev)
    emit({"phase": "campaign_done",
          "seconds": round(time.perf_counter() - t0, 3)})
    t0 = time.perf_counter()
    fuzz_phase()
    emit({"phase": "fuzz_done", "seconds": round(time.perf_counter() - t0,
                                                 3)})
    # phases 11-14 run here, before the timings, the profiler and
    # the service: run after them, the host-bound full-width decode loop
    # took twice as long
    t0 = time.perf_counter()
    mesh = mesh_phase(dev, campaign["quick_numpy"])
    emit({"phase": "mesh_done",
          "seconds": round(time.perf_counter() - t0, 3)})
    t0 = time.perf_counter()
    llm = llm_phase(dev)
    torch.cuda.empty_cache()
    emit({"phase": "llm_done", "seconds": round(time.perf_counter() - t0, 3),
          "full_width": {k: llm[k]["decode_tok_per_s"]
                         for k in ("float32", "bfloat16")}})
    t0 = time.perf_counter()
    train = train_phase(dev)
    torch.cuda.empty_cache()
    emit({"phase": "train_done",
          "seconds": round(time.perf_counter() - t0, 3),
          "full_width_tokens_per_s": {k: train[k]["tokens_per_s"]
                                      for k in ("float32", "bfloat16")}})

    t0 = time.perf_counter()
    placement = placement_phase(dev, llm, train)
    torch.cuda.empty_cache()
    emit({"phase": "placement_done",
          "seconds": round(time.perf_counter() - t0, 3), **placement})

    t0 = time.perf_counter()
    times = timings(dev)
    hetero_times = time_k2_hetero(dev, campaign)
    emit({"phase": "times_done",
          "seconds": round(time.perf_counter() - t0, 3)})
    t0 = time.perf_counter()
    profile_paths(dev)
    emit({"phase": "profile_done",
          "seconds": round(time.perf_counter() - t0, 3)})
    t0 = time.perf_counter()
    service = service_phase(dev)
    emit({"phase": "service_done",
          "seconds": round(time.perf_counter() - t0, 3)})
    sources = {"fifo_eval": ("src/repro_torch/csrc/fifo_eval.cu",
                             "src/repro/kernels/fifo_eval/fifo_eval.py:49"),
               "fifo_eval_condensed": (
                   "src/repro_torch/csrc/condensed.cu",
                   "src/repro/kernels/fifo_eval/condensed.py:75")}
    kernels = []
    for name, (source, replaces) in sources.items():
        # the reported time is the slowest design's 512-row bucket; every
        # design's numbers are in the "time" lines above
        worst = max((r for r in times[name] if r.get("shape") == "bucket"),
                    key=lambda r: r["ms"])
        extra = {}
        if name == "fifo_eval_condensed":
            # K1 also at the main path's shapes (1 and 8 rows)
            keys = ("shape", "design", "rows", "e_pad", "v_pad", "launch",
                    "iters_max", "ms", "ms_max_iters_1", "plain_ms",
                    "bound_ms", "bound_by")
            extra = {"launch": worst["launch"],
                     "launches_by_rows": k1_rows,
                     "campaign_launches":
                         campaign["totals"]["fifo_eval_condensed"],
                     "shapes": [
                         {k: r[k] for k in keys} for r in times[name]
                         if r["shape"] == "main_path" or r is worst]}
        if name == "fifo_eval":
            # K2 also at the main path's shape, with the chosen clusters,
            # and in its per-design-table mode on the campaign's path
            keys = ("shape", "design", "rows", "e_pad", "cluster",
                    "active", "iters_max", "ms", "us_per_iter", "plain_ms",
                    "bound_ms", "bound_by")
            counts = campaign["counts"]
            extra = {"cluster": worst["cluster"], "shapes": [
                {k: r[k] for k in keys} for r in times[name]
                if r["shape"] in ("main_path", "cert_probe")
                or r is worst] + hetero_times,
                "campaign_launches": campaign["totals"]["fifo_eval"],
                "hetero_launches": counts["fifo_eval_hetero"],
                "hetero_launches_by_rows": counts["fifo_eval_hetero_rows"],
                "hetero_launches_by_cluster":
                    counts["fifo_eval_hetero_clusters"],
                "hetero_stats": campaign["stats"]}
        # the service phase: both services' launches (K2's
        # per-design-table launches apart, under "fifo_eval")
        extra["service_launches"] = service["totals"][name]
        extra["service_launches_by_rows"] = {
            step: service[step]["counts"][name + "_rows"]
            for step in ("hetero", "per_design")}
        if name == "fifo_eval":
            extra["service_hetero_launches"] = \
                service["totals"]["fifo_eval_hetero"]
            extra["service_hetero_launches_by_rows"] = \
                service["hetero"]["counts"]["fifo_eval_hetero_rows"]
            extra["service_hetero_stats"] = service["hetero"]["stats"]
        # phase 11: the launches on the meshes, by shard and by rows
        extra["mesh_launches"] = mesh["totals"][name]
        extra["mesh_launches_by_shard"] = {
            setup: per[name] for setup, per in mesh["by_shard"].items()
            if name in per}
        extra["mesh_launches_by_rows"] = mesh["by_rows"][name]
        if name == "fifo_eval":
            extra["mesh_hetero_launches"] = mesh["totals"]["fifo_eval_hetero"]
            extra["mesh_hetero_launches_by_shard"] = \
                mesh["by_shard"]["campaign_2x2"]["fifo_eval_hetero"]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "cert_search_launches": cert_search[name]["launches"],
            "cert_search_launches_by_rows": cert_search[name]["by_rows"],
            "max_abs_err": max(cmp.err.get(name, 0.0),
                               cmp.err.get(name + "_hetero", 0.0)),
            "ms": worst["ms"],
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
