"""Designs with data-dependent control flow (paper Fig. 2 + §IV-D).

These are the designs for which the paper argues *only* runtime analysis
can size FIFOs deadlock-free: FIFO op counts and interleavings depend on
values known only at kernel runtime (the argument ``n``; the graph fed to
the GNN accelerator).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core.design import Design


def mult_by_2(n: int = 64) -> Design:
    """Paper Fig. 2, verbatim: producer fills stream x with n items, then
    stream y; consumer alternates x/y reads.  Deadlock-free sizing REQUIRES
    knowing n — static analysis cannot."""
    d = Design("mult_by_2", args={"n": n})
    d.fifo("x", width=32)
    d.fifo("y", width=32)

    @d.task("producer", data_dependent=True)
    def producer(ctx):
        n = ctx.arg("n")
        for _ in range(n):
            yield ctx.delay(1)
            yield ctx.write("x", 1)
        for _ in range(n):
            yield ctx.delay(1)
            yield ctx.write("y", 1)

    @d.task("consumer", data_dependent=True)
    def consumer(ctx):
        n = ctx.arg("n")
        s = 0
        for _ in range(n):
            yield ctx.delay(1)
            a = yield ctx.read("x")
            b = yield ctx.read("y")
            s += a + b
        ctx.result("sum", s)

    return d


# ---------------------------------------------------------------------------
# FlowGNN PNA-like accelerator
# ---------------------------------------------------------------------------

def _random_graph(n_nodes: int, n_edges: int, seed: int
                  ) -> Tuple[List[Tuple[int, int]], List[int]]:
    """Deterministic random multigraph with skewed in-degrees (hub nodes);
    edges sorted by destination (the FlowGNN gather contract).  Source
    indices remain arbitrary — that is the deadlock mechanism below.
    Returns (edges, in_degrees)."""
    x = (seed * 2654435761 + 12345) % 2**31
    edges = []
    for _ in range(n_edges):
        x = (1103515245 * x + 12345) % 2**31
        u = x % n_nodes
        x = (1103515245 * x + 12345) % 2**31
        if x % 4 == 0:   # ~25% of edges land on a small hub set
            v = (x // 7) % max(n_nodes // 16, 1)
        else:
            v = (x // 7) % n_nodes
        edges.append((u, v))
    edges.sort(key=lambda e: e[1])
    deg = [0] * n_nodes
    for _, v in edges:
        deg[v] += 1
    return edges, deg


def _gather_engine(d: Design, aggs: Sequence[str],
                   cost: Dict[str, Tuple[int, int]], lanes: int,
                   node_depth: int, widths: Dict[str, int],
                   node_items: Callable, message: Callable,
                   aggregate: Callable, combine: Callable) -> None:
    """Declare the FlowGNN gather engine on ``d``: its queues, then the
    tasks edge_loader, node_loader, scatter, one aggregator a kind in
    ``aggs``, ``combine`` (the caller's program) and store.

    node_loader streams per node, in node order, the ``(skip, feature,
    degree)`` that ``node_items(ctx)`` gives: the skip item to combine on
    ``skip_q``, the feature into ``feat_q``, the in-degree to every
    aggregator (data-dependent trip counts).  scatter walks the
    dest-sorted edge stream; edge (u, v) needs feature u, so scatter
    pulls ``feat_q`` forward to u and writes ``message(feature)`` to lane
    ``v % lanes`` of every aggregator — how far ahead of the aggregation
    frontier the loader must run is a property of the RUNTIME GRAPH (an
    early edge with a late source forces deep buffering).  Undersized
    deg/skip queues then deadlock the engine through the cycle scatter ->
    feat_q -> node_loader -> deg_q -> aggregator -> msg -> scatter.  Static
    analysis cannot bound any of this; the paper's §IV-D argument.

    An aggregator of kind ``a`` takes ``cost[a]`` = (cycles a message,
    epilogue cycles) and writes ``aggregate(a, msgs)`` of a node's
    messages in arrival order to ``agg_<a>``.  ``widths`` gives the bits
    of an item of ``edges``, ``feat``, ``skip``, ``deg``, ``msg``, ``agg``
    and ``out``.  Declared depths model the hand-sized original
    accelerator (the case study's "user-defined Baseline-Max"):
    ``node_depth`` for the node-sized control queues, 64-deep message
    lanes.
    """
    d.fifo("edges_q", width=widths["edges"], depth=32)
    d.fifo("feat_q", width=widths["feat"], depth=node_depth)
    d.fifo("skip_q", width=widths["skip"], depth=node_depth)
    deg_qs = [d.fifo(f"deg_{a}", width=widths["deg"], depth=node_depth)
              for a in aggs]
    msg = {a: d.fifo_array(f"msg_{a}", lanes, width=widths["msg"], depth=64)
           for a in aggs}
    agg = {a: d.fifo(f"agg_{a}", width=widths["agg"], depth=16)
           for a in aggs}
    d.fifo("out_q", width=widths["out"], depth=16)

    @d.task("edge_loader", data_dependent=True)
    def edge_loader(ctx):
        for (u, v) in ctx.arg("edges"):
            yield ctx.delay(1)
            yield ctx.write("edges_q", (u, v))

    @d.task("node_loader", data_dependent=True)
    def node_loader(ctx):
        for skip, feat, dv in node_items(ctx):
            yield ctx.delay(1)
            yield ctx.write("skip_q", skip)
            yield ctx.write("feat_q", feat)
            for q in deg_qs:
                yield ctx.write(q, dv)

    @d.task("scatter", data_dependent=True)
    def scatter(ctx):
        feats: List = []
        for _ in range(len(ctx.arg("edges"))):
            yield ctx.delay(1)
            (u, v) = yield ctx.read("edges_q")
            while len(feats) <= u:           # pull features forward to u
                f = yield ctx.read("feat_q")
                feats.append(f)
            yield ctx.delay(1)
            m = message(feats[u])
            for a in aggs:
                yield ctx.write(msg[a][v % lanes], m)

    def make_aggregator(a: str, q: str):
        per_msg, epilogue = cost[a]

        def prog(ctx):
            for v in range(len(ctx.arg("deg"))):
                yield ctx.delay(1)
                dv = yield ctx.read(q)
                msgs = []
                for _ in range(dv):          # data-dependent trip count
                    m = yield ctx.read(msg[a][v % lanes])
                    yield ctx.delay(per_msg)
                    msgs.append(m)
                yield ctx.delay(epilogue)
                yield ctx.write(agg[a], aggregate(a, msgs))
        return prog

    for a, q in zip(aggs, deg_qs):
        d.add_task(f"agg_{a}", make_aggregator(a, q), data_dependent=True)
    d.add_task("combine", combine, data_dependent=True)

    @d.task("store", data_dependent=True)
    def store(ctx):
        for _ in range(len(ctx.arg("deg"))):
            yield ctx.delay(1)
            yield ctx.read("out_q")


# The three PNA aggregator kinds our model instantiates; std keeps running
# moments and is costlier per message.
_AGGS = ("mean", "max", "std")
_AGG_COST = {"mean": (1, 1), "max": (1, 1), "std": (3, 4)}


def _running_sum(kind: str, msgs: List[float]) -> float:
    acc = 0.0
    for m in msgs:
        acc += m
    return acc


def flowgnn_pna(n_nodes: int = 64, n_edges: int = 256, lanes: int = 4,
                seed: int = 7) -> Design:
    """PNA message-passing layer in the FlowGNN dataflow style
    (:func:`_gather_engine`) over one random graph, three aggregators that
    each sum their messages, scalar items.

    Declared depths model the hand-sized original accelerator:
    node-count-sized control queues.
    """
    edges, deg = _random_graph(n_nodes, n_edges, seed)
    d = Design("flowgnn_pna", args={"edges": edges, "deg": deg})

    def node_items(ctx):
        for v, dv in enumerate(ctx.arg("deg")):
            yield 0.001 * v, 0.01 * v, dv

    def combine(ctx):
        n_v = len(ctx.arg("deg"))
        total = 0.0
        for _ in range(n_v):
            self_feat = yield ctx.read("skip_q")
            vals = [self_feat]
            for a in _AGGS:
                x = yield ctx.read(f"agg_{a}")
                vals.append(x)
            yield ctx.delay(6)               # per-node update MLP
            y = sum(vals) / 4.0
            total += y
            yield ctx.write("out_q", y)
        ctx.result("checksum", total)

    _gather_engine(d, _AGGS, _AGG_COST, lanes, n_nodes,
                   dict(edges=64, feat=256, skip=256, deg=16, msg=32,
                        agg=32, out=32),
                   node_items, lambda f: f + 1.0, _running_sum, combine)
    return d


# ---------------------------------------------------------------------------
# FlowGNN's PNA engine over a stream of graphs
# ---------------------------------------------------------------------------

#: PNA's four aggregators (Corso et al., arXiv:2004.05718) and three degree
#: scalers; ``combine`` weighs the self feature and every aggregator under
#: every scaler
PNA_AGGS = ("mean", "max", "min", "std")
PNA_SCALERS = ("identity", "amplification", "attenuation")
#: (cycles a message, epilogue cycles) of each aggregator: std keeps two
#: running moments and takes a square root; min costs what max costs
PNA_AGG_COST = {"mean": (1, 1), "max": (1, 1), "min": (1, 1), "std": (3, 4)}
#: ``combine``'s cycles a node: the update MLP (6) and the two degree
#: scalers, a log and a divide (2)
PNA_COMBINE_DELAY = 6 + 2
#: PNA's std adds this before its square root
PNA_STD_EPS = 1e-5
#: the node embedding's width, one queue item carrying a whole embedding
PNA_DIM = 80
#: bits of one word: an embedding element, a degree, a node id
WORD_BITS = 32


def pna_aggregate(kind: str, msgs: List[np.ndarray], dim: int) -> np.ndarray:
    """One PNA aggregator over a node's messages (each ``(dim,)``), zeros
    for a node without messages."""
    if not msgs:
        return np.zeros(dim)
    m = np.stack(msgs)
    if kind == "max":
        return m.max(axis=0)
    if kind == "min":
        return m.min(axis=0)
    mean = m.sum(axis=0) / len(msgs)
    if kind == "mean":
        return mean
    var = (m * m).sum(axis=0) / len(msgs) - mean * mean
    return np.sqrt(np.maximum(var, 0.0) + PNA_STD_EPS)


def pna_scalers(deg: int, delta: float) -> Tuple[float, float, float]:
    """Identity, amplification ``log(d+1)/delta`` and attenuation
    ``delta/log(d+1)``, the degree clamped to at least 1 (as PyTorch
    Geometric's ``PNAConv`` does)."""
    ld = math.log(max(deg, 1) + 1)
    return 1.0, ld / delta, delta / ld


def flowgnn_pna_stream(graphs: Sequence[Tuple[int, Sequence[Tuple[int, int]]]],
                       lanes: int = 4, seed: int = 0) -> Design:
    """FlowGNN's PNA engine (Sarkar et al., arXiv:2204.13103) streaming
    ``graphs`` back to back, one layer of PNA on :data:`PNA_DIM`-wide node
    embeddings.

    ``graphs`` is a list of ``(n_nodes, directed_edges)``; node ids are
    offset so the graphs run through one engine one after another, and
    the edges are sorted by destination (FlowGNN's gather contract).  The
    engine is :func:`_gather_engine` with PNA's four aggregators (each
    computing its aggregate over whole embeddings) and a ``combine`` that
    reads the self embedding with the degree on ``skip_q`` and the four
    aggregates, applies the three scalers with ``delta`` the stream's mean
    ``log(d + 1)``, and maps the 13 embeddings through one linear layer
    (a stand-in for the update MLP).  The per-node outputs are
    ``ctx.result("out")``, each ``(PNA_DIM,)``.

    A queue item is as wide as what it carries, in :data:`WORD_BITS`-bit
    words: an embedding on ``feat_q``, the message lanes, ``agg_*`` and
    ``out_q``; an embedding and a degree on ``skip_q``; a degree on
    ``deg_*``; two node ids on ``edges_q``.  Node embeddings are uniform in
    [-1, 1) and the linear layer's weights uniform in ``±1/sqrt(13 *
    PNA_DIM)`` (``torch.nn.Linear``'s bound), drawn from ``seed``.  The
    node-sized control queues (``feat_q``, ``skip_q``, ``deg_*``) are
    declared as deep as the largest graph, as a hand-sized accelerator is
    sized for the largest graph it accepts.
    """
    edges: List[Tuple[int, int]] = []
    sizes = []
    base = 0
    for n, es in graphs:
        edges.extend((base + u, base + v) for u, v in es)
        sizes.append(int(n))
        base += int(n)
    edges.sort(key=lambda e: (e[1], e[0]))
    deg = [0] * base
    for _, v in edges:
        deg[v] += 1
    n_in = (1 + len(PNA_AGGS) * len(PNA_SCALERS)) * PNA_DIM
    rng = np.random.default_rng(int(seed) % 2 ** 64)
    x = rng.uniform(-1.0, 1.0, (base, PNA_DIM))
    weights = rng.uniform(-1.0, 1.0, (n_in, PNA_DIM)) / math.sqrt(n_in)
    delta = sum(math.log(dv + 1) for dv in deg) / max(base, 1)
    d = Design("flowgnn_pna_stream", args={
        "graphs": [(n, list(es)) for n, es in graphs], "edges": edges,
        "deg": deg, "x": x, "weights": weights, "delta": delta,
        "lanes": lanes, "seed": int(seed)})

    def node_items(ctx):
        for xv, dv in zip(ctx.arg("x"), ctx.arg("deg")):
            yield (xv, dv), xv, dv

    def combine(ctx):
        w, delta = ctx.arg("weights"), ctx.arg("delta")
        out = []
        for _ in range(len(ctx.arg("deg"))):
            xv, dv = yield ctx.read("skip_q")
            aggs = []
            for a in PNA_AGGS:
                y = yield ctx.read(f"agg_{a}")
                aggs.append(y)
            yield ctx.delay(PNA_COMBINE_DELAY)
            scale = pna_scalers(dv, delta)
            y = np.concatenate([xv] + [val * s for val in aggs
                                       for s in scale]) @ w
            out.append(y)
            yield ctx.write("out_q", y)
        ctx.result("out", out)

    emb = PNA_DIM * WORD_BITS
    _gather_engine(d, PNA_AGGS, PNA_AGG_COST, lanes,
                   max(max(sizes, default=1), 2),
                   dict(edges=2 * WORD_BITS, feat=emb, skip=emb + WORD_BITS,
                        deg=WORD_BITS, msg=emb, agg=emb, out=emb),
                   node_items, lambda f: f,
                   lambda a, msgs: pna_aggregate(a, msgs, PNA_DIM), combine)
    return d
