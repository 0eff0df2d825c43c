# A frozen copy of src/repro_torch/designs/streamhls.py, imports renamed: part of the
# benchmark's yardstick, which later changes to the program do not move.
"""The Stream-HLS benchmark suite (paper Tables II/III), re-derived.

24 designs: the 21 of Table II plus ``gesummv``, ``k7mmtree_balanced`` and
``ResMLP`` from Table III.  Task-graph *structures* follow the published
kernels (PolyBench linear algebra + small DNN blocks lowered to dataflow);
trip counts are scaled down, far below the published kernels' and below
what the evaluator's float32-exact domain would allow:
``portbench/configs/streamhls.json`` gives the sizes and why the
benchmark runs them.

Each factory returns a fresh :class:`~portbench.inputs.design.Design`; the
registry ``STREAMHLS_DESIGNS`` maps name -> factory.
"""

from __future__ import annotations

from typing import Callable, Dict, List

from portbench.inputs.design import Design
from portbench.inputs.builder import (buffered_matmul_stage, conv_stage,
                                   fork_stage, join_stage, map_stage,
                                   matmul_stage, matvec_stage, producer,
                                   sink, streams)


def _vals(n: int, seed: int = 1) -> List[float]:
    """Deterministic pseudo-random input values (affect only functional
    checks for these static-control designs)."""
    out = []
    x = seed * 2654435761 % 2**32
    for _ in range(n):
        x = (1103515245 * x + 12345) % 2**31
        out.append((x % 1000) / 500.0 - 1.0)
    return out


_relu = lambda v: v if v > 0 else 0.0


# ---------------------------------------------------------------------------
# PolyBench linear algebra
# ---------------------------------------------------------------------------

def gemm(m: int = 32, k: int = 32, n: int = 32, lanes: int = 8) -> Design:
    """C = alpha*A@B + beta*C."""
    d = Design("gemm")
    a = streams(d, "a", lanes)
    c_in = streams(d, "c_in", lanes)
    ab = streams(d, "ab", lanes)
    c_out = streams(d, "c_out", lanes)
    producer(d, "load_a", a, _vals(m * k))
    producer(d, "load_c", c_in, _vals(m * n, seed=2))
    matmul_stage(d, "mm", a, ab, m, k, n)
    join_stage(d, "scale_add", ab, c_in, c_out, m * n,
               fn=lambda x, y: 1.5 * x + 1.2 * y)
    sink(d, "store_c", c_out, m * n, result_key="C")
    return d


def atax(m: int = 96, n: int = 96, lanes: int = 2) -> Design:
    """y = A^T (A x)."""
    d = Design("atax")
    x = streams(d, "x", lanes)
    tmp = streams(d, "tmp", lanes)
    y = streams(d, "y", lanes)
    producer(d, "load_x", x, _vals(n))
    matvec_stage(d, "ax", x, tmp, rows=m, cols=n, reuse_input=True)
    matvec_stage(d, "aty", tmp, y, rows=n, cols=m, reuse_input=True)
    sink(d, "store_y", y, n, result_key="y")
    return d


def bicg(m: int = 96, n: int = 96, lanes: int = 2) -> Design:
    """s = A^T r ; q = A p (two independent streaming matvecs)."""
    d = Design("bicg")
    r = streams(d, "r", lanes)
    p = streams(d, "p", lanes)
    s = streams(d, "s", lanes)
    q = streams(d, "q", lanes)
    producer(d, "load_r", r, _vals(m))
    producer(d, "load_p", p, _vals(n, seed=2))
    matvec_stage(d, "at_r", r, s, rows=n, cols=m, reuse_input=True)
    matvec_stage(d, "a_p", p, q, rows=m, cols=n, reuse_input=True)
    sink(d, "store_s", s, n, result_key="s")
    sink(d, "store_q", q, m, result_key="q")
    return d


def mvt(n: int = 96, lanes: int = 2) -> Design:
    """x1 += A y1 ; x2 += A^T y2."""
    d = Design("mvt")
    y1 = streams(d, "y1", lanes)
    y2 = streams(d, "y2", lanes)
    t1 = streams(d, "t1", lanes)
    t2 = streams(d, "t2", lanes)
    x1i = streams(d, "x1_in", lanes)
    x2i = streams(d, "x2_in", lanes)
    x1o = streams(d, "x1_out", lanes)
    x2o = streams(d, "x2_out", lanes)
    producer(d, "load_y1", y1, _vals(n))
    producer(d, "load_y2", y2, _vals(n, seed=2))
    producer(d, "load_x1", x1i, _vals(n, seed=3))
    producer(d, "load_x2", x2i, _vals(n, seed=4))
    matvec_stage(d, "a_y1", y1, t1, rows=n, cols=n, reuse_input=True)
    matvec_stage(d, "at_y2", y2, t2, rows=n, cols=n, reuse_input=True)
    join_stage(d, "add_x1", x1i, t1, x1o, n)
    join_stage(d, "add_x2", x2i, t2, x2o, n)
    sink(d, "store_x1", x1o, n, result_key="x1")
    sink(d, "store_x2", x2o, n, result_key="x2")
    return d


def gesummv(n: int = 96, lanes: int = 2) -> Design:
    """y = alpha*A@x + beta*B@x."""
    d = Design("gesummv")
    x = streams(d, "x", lanes)
    xa = streams(d, "xa", lanes)
    xb = streams(d, "xb", lanes)
    ta = streams(d, "ta", lanes)
    tb = streams(d, "tb", lanes)
    y = streams(d, "y", lanes)
    producer(d, "load_x", x, _vals(n))
    fork_stage(d, "dup_x", x, xa, xb, n)
    matvec_stage(d, "a_x", xa, ta, rows=n, cols=n, reuse_input=True)
    matvec_stage(d, "b_x", xb, tb, rows=n, cols=n, reuse_input=True)
    join_stage(d, "sum", ta, tb, y, n,
               fn=lambda a, b: 1.5 * a + 1.2 * b)
    sink(d, "store_y", y, n, result_key="y")
    return d


# ---------------------------------------------------------------------------
# matmul chains / trees (k2mm .. k15mm*)
# ---------------------------------------------------------------------------

def _kmm_seq(name: str, dims: List[int], lanes: int = 4,
             relu: bool = False) -> Design:
    """Chain of len(dims)-1 matmuls: X(m0 x m1) @ W1(m1 x m2) @ ..."""
    d = Design(name)
    m0 = dims[0]
    cur = streams(d, "x0", lanes)
    producer(d, "load_x0", cur, _vals(m0 * dims[1]))
    for s in range(1, len(dims) - 1):
        k, n = dims[s], dims[s + 1]
        out = streams(d, f"x{s}", lanes)
        matmul_stage(d, f"mm{s}", cur, out, m=m0, k=k, n=n)
        if relu and s < len(dims) - 2:
            ract = streams(d, f"r{s}", lanes)
            map_stage(d, f"relu{s}", out, ract, m0 * n, fn=_relu)
            out = ract
        cur = out
    sink(d, "store", cur, m0 * dims[-1], result_key="out")
    return d


def _kmm_tree(name: str, n_leaves: int, chain: List[int],
              inner: List[int], lanes: int = 4,
              relu: bool = False, b_col_order: bool = True) -> Design:
    """Balanced reduction tree over a matrix chain product: leaf t computes
    X_t @ W_t with X_t of shape (chain[t] x inner[t]) and W_t local of
    shape (inner[t] x chain[t+1]); pairs are combined bottom-up (left
    operand streamed, right operand buffered).  n_leaves*2-1 matmuls total
    (8 leaves -> k15mm, 4 leaves -> k7mm).  ``chain`` adjacency guarantees
    every tree node's operand shapes are compatible."""
    assert len(chain) == n_leaves + 1 and len(inner) >= n_leaves
    d = Design(name)
    level: List = []
    for i in range(n_leaves):
        m, k, n = chain[i], inner[i], chain[i + 1]
        src = streams(d, f"in{i}", lanes)
        out = streams(d, f"l0_{i}", lanes)
        producer(d, f"load{i}", src, _vals(m * k, seed=i + 1))
        matmul_stage(d, f"leaf{i}", src, out, m=m, k=k, n=n)
        level.append((out, m, n))
    lvl = 1
    while len(level) > 1:
        nxt = []
        for j in range(0, len(level), 2):
            (a, ma, na), (b, mb, nb) = level[j], level[j + 1]
            out = streams(d, f"l{lvl}_{j // 2}", lanes)
            # combine: A (ma x na) streamed, B (mb x nb) buffered
            buffered_matmul_stage(d, f"node{lvl}_{j // 2}", a, b, out,
                                  m=ma, k=na, n=nb, b_col_order=b_col_order)
            cur = (out, ma, nb)
            if relu and len(level) > 2:
                ract = streams(d, f"lr{lvl}_{j // 2}", lanes)
                map_stage(d, f"relu{lvl}_{j // 2}", out, ract, ma * nb,
                          fn=_relu)
                cur = (ract, ma, nb)
            nxt.append(cur)
        level = nxt
        lvl += 1
    out, m, n = level[0]
    sink(d, "store", out, m * n, result_key="out")
    return d


# Balanced: every chain/inner dim equal -> all stream rates match.
_CH8_BAL, _IN8_BAL = [24] * 9, [24] * 8
_CH4_BAL, _IN4_BAL = [24] * 5, [24] * 4
# Imbalanced: uneven chain dims -> producer/consumer rate mismatches.
_CH8_IMB = [28, 12, 32, 16, 24, 18, 22, 12, 28]
_IN8_IMB = [16, 30, 12, 24, 18, 28, 16, 22]
_CH4_IMB = [28, 12, 32, 16, 24]
_IN4_IMB = [16, 30, 12, 24]


def k2mm() -> Design:
    return _kmm_seq("k2mm", [24, 24, 24, 24], lanes=4)


def k3mm() -> Design:
    return _kmm_seq("k3mm", [24, 24, 24, 24, 24], lanes=4)


def k7mmseq_balanced() -> Design:
    return _kmm_seq("k7mmseq_balanced", [20] * 8)


def k7mmseq_unbalanced() -> Design:
    return _kmm_seq("k7mmseq_unbalanced", [20, 28, 10, 32, 14, 24, 16, 20])


def k7mmtree_balanced() -> Design:
    return _kmm_tree("k7mmtree_balanced", 4, _CH4_BAL, _IN4_BAL,
                     b_col_order=False)


def k7mmtree_unbalanced() -> Design:
    return _kmm_tree("k7mmtree_unbalanced", 4, _CH4_IMB, _IN4_IMB,
                     b_col_order=False)


def k15mmseq() -> Design:
    return _kmm_seq("k15mmseq", [16] * 16)


def k15mmseq_imbalanced() -> Design:
    return _kmm_seq("k15mmseq_imbalanced",
                    [16, 22, 10, 26, 12, 20, 10, 28, 16, 12, 22, 10, 20, 16, 12, 16])


def k15mmseq_relu() -> Design:
    return _kmm_seq("k15mmseq_relu", [16] * 16, relu=True)


def k15mmseq_relu_imbalanced() -> Design:
    return _kmm_seq("k15mmseq_relu_imbalanced",
                    [16, 22, 10, 26, 12, 20, 10, 28, 16, 12, 22, 10, 20, 16, 12, 16],
                    relu=True)


def k15mmtree() -> Design:
    return _kmm_tree("k15mmtree", 8, _CH8_BAL, _IN8_BAL)


def k15mmtree_imbalanced() -> Design:
    return _kmm_tree("k15mmtree_imbalanced", 8, _CH8_IMB, _IN8_IMB)


def k15mmtree_relu() -> Design:
    return _kmm_tree("k15mmtree_relu", 8, _CH8_BAL, _IN8_BAL, relu=True)


def k15mmtree_relu_imbalanced() -> Design:
    return _kmm_tree("k15mmtree_relu_imbalanced", 8, _CH8_IMB, _IN8_IMB,
                     relu=True)


# ---------------------------------------------------------------------------
# DNN blocks
# ---------------------------------------------------------------------------

def feedforward(seq: int = 32, dim: int = 16, hidden: int = 64,
                lanes: int = 8) -> Design:
    """Transformer FFN with residual: y = x + W2 relu(W1 x)."""
    d = Design("FeedForward")
    x = streams(d, "x", lanes)
    skip = streams(d, "skip", lanes)
    main = streams(d, "main", lanes)
    h = streams(d, "h", lanes)
    hr = streams(d, "hr", lanes)
    o = streams(d, "o", lanes)
    y = streams(d, "y", lanes)
    producer(d, "load_x", x, _vals(seq * dim))
    fork_stage(d, "fork", x, skip, main, seq * dim)
    matmul_stage(d, "w1", main, h, m=seq, k=dim, n=hidden)
    map_stage(d, "relu", h, hr, seq * hidden, fn=_relu)
    matmul_stage(d, "w2", hr, o, m=seq, k=hidden, n=dim)
    join_stage(d, "residual", skip, o, y, seq * dim)
    sink(d, "store", y, seq * dim, result_key="y")
    return d


def autoencoder(seq: int = 24, dims=(32, 16, 8, 16, 32), lanes: int = 4
                ) -> Design:
    """Encoder-decoder MLP stack with ReLUs between layers."""
    d = Design("Autoencoder")
    cur = streams(d, "x", lanes)
    producer(d, "load", cur, _vals(seq * dims[0]))
    for i in range(len(dims) - 1):
        out = streams(d, f"z{i}", lanes)
        matmul_stage(d, f"fc{i}", cur, out, m=seq, k=dims[i], n=dims[i + 1])
        if i < len(dims) - 2:
            act = streams(d, f"a{i}", lanes)
            map_stage(d, f"relu{i}", out, act, seq * dims[i + 1], fn=_relu)
            cur = act
        else:
            cur = out
    sink(d, "store", cur, seq * dims[-1], result_key="y")
    return d


def residual_block(length: int = 768, taps: int = 9, lanes: int = 4
                   ) -> Design:
    """conv->relu->conv with a skip path: the skip FIFO must buffer the
    main path's latency — the canonical FIFO-sizing trap."""
    d = Design("ResidualBlock")
    x = streams(d, "x", lanes)
    skip = streams(d, "skip", lanes)
    main = streams(d, "main", lanes)
    c1 = streams(d, "c1", lanes)
    r1 = streams(d, "r1", lanes)
    c2 = streams(d, "c2", lanes)
    y = streams(d, "y", lanes)
    yr = streams(d, "yr", lanes)
    producer(d, "load", x, _vals(length))
    fork_stage(d, "fork", x, skip, main, length)
    conv_stage(d, "conv1", main, c1, length, taps)
    map_stage(d, "relu1", c1, r1, length, fn=_relu, extra_delay=1)
    conv_stage(d, "conv2", r1, c2, length, taps)
    join_stage(d, "residual", skip, c2, y, length)
    map_stage(d, "relu2", y, yr, length, fn=_relu)
    sink(d, "store", yr, length, result_key="y")
    return d


def depth_sep_conv_block(length: int = 160, channels: int = 8,
                         taps: int = 5) -> Design:
    """Depthwise (per-channel) convs feeding a pointwise 1x1 combine."""
    d = Design("DepthSepConvBlock")
    xin = streams(d, "xin", channels)
    dw = streams(d, "dw", channels)
    pw = streams(d, "pw", channels)
    y = streams(d, "y", channels)
    producer(d, "load", xin, _vals(length * channels))
    for c in range(channels):
        conv_stage(d, f"dwconv{c}", [xin[c]], [dw[c]], length, taps)

    def pointwise(ctx, dw=tuple(dw), pw=tuple(pw), n=length, C=channels):
        for i in range(n):
            acc = 0.0
            for c in range(C):
                yield ctx.delay(1)
                v = yield ctx.read(dw[c])
                acc += 0.1 * v
            for c in range(C):
                yield ctx.write(pw[c], acc)
    d.add_task("pointwise", pointwise)
    map_stage(d, "relu", pw, y, length * channels, fn=_relu)
    sink(d, "store", y, length * channels, result_key="y")
    return d


def resmlp(seq: int = 16, dim: int = 16, blocks: int = 2, lanes: int = 8
           ) -> Design:
    """Stacked MLP blocks, each with a residual skip (ResMLP-style)."""
    d = Design("ResMLP")
    cur = streams(d, "x", lanes)
    producer(d, "load", cur, _vals(seq * dim))
    for b in range(blocks):
        skip = streams(d, f"skip{b}", lanes)
        main = streams(d, f"main{b}", lanes)
        h = streams(d, f"h{b}", lanes)
        hr = streams(d, f"hr{b}", lanes)
        o = streams(d, f"o{b}", lanes)
        y = streams(d, f"y{b}", lanes)
        fork_stage(d, f"fork{b}", cur, skip, main, seq * dim)
        matmul_stage(d, f"fc{b}a", main, h, m=seq, k=dim, n=dim * 4)
        map_stage(d, f"relu{b}", h, hr, seq * dim * 4, fn=_relu)
        matmul_stage(d, f"fc{b}b", hr, o, m=seq, k=dim * 4, n=dim)
        join_stage(d, f"residual{b}", skip, o, y, seq * dim)
        cur = y
    sink(d, "store", cur, seq * dim, result_key="y")
    return d


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

STREAMHLS_DESIGNS: Dict[str, Callable[[], Design]] = {
    "atax": atax,
    "Autoencoder": autoencoder,
    "bicg": bicg,
    "DepthSepConvBlock": depth_sep_conv_block,
    "FeedForward": feedforward,
    "gemm": gemm,
    "gesummv": gesummv,
    "k2mm": k2mm,
    "k3mm": k3mm,
    "k7mmseq_balanced": k7mmseq_balanced,
    "k7mmseq_unbalanced": k7mmseq_unbalanced,
    "k7mmtree_balanced": k7mmtree_balanced,
    "k7mmtree_unbalanced": k7mmtree_unbalanced,
    "k15mmseq": k15mmseq,
    "k15mmseq_imbalanced": k15mmseq_imbalanced,
    "k15mmseq_relu": k15mmseq_relu,
    "k15mmseq_relu_imbalanced": k15mmseq_relu_imbalanced,
    "k15mmtree": k15mmtree,
    "k15mmtree_imbalanced": k15mmtree_imbalanced,
    "k15mmtree_relu": k15mmtree_relu,
    "k15mmtree_relu_imbalanced": k15mmtree_relu_imbalanced,
    "mvt": mvt,
    "ResidualBlock": residual_block,
    "ResMLP": resmlp,
}

TABLE_II_DESIGNS = [n for n in STREAMHLS_DESIGNS
                    if n not in ("gesummv", "k7mmtree_balanced", "ResMLP")]

#: representative fast subset shared by the benchmarks (FULL=1 runs
#: everything) and the campaign CLI's ``--designs fast``
FAST_DESIGNS = ("atax", "gemm", "gesummv", "FeedForward", "Autoencoder",
                "k7mmtree_balanced", "k15mmseq", "k15mmtree",
                "ResidualBlock", "mvt")

#: CI smoke pair (QUICK=1 / the campaign CLI's ``--designs quick``)
QUICK_DESIGNS = ("gemm", "FeedForward")


def make_design(name: str) -> Design:
    return STREAMHLS_DESIGNS[name]()
