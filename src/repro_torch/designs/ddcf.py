"""Designs with data-dependent control flow (paper Fig. 2 + §IV-D).

These are the designs for which the paper argues *only* runtime analysis
can size FIFOs deadlock-free: FIFO op counts and interleavings depend on
values known only at kernel runtime (the argument ``n``; the graph fed to
the GNN accelerator).
"""

from __future__ import annotations

from typing import List, Tuple

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


# The three PNA aggregator kinds our model instantiates; std keeps running
# moments and is costlier per message.
_AGGS = ("mean", "max", "std")
_AGG_COST = {"mean": (1, 1), "max": (1, 1), "std": (3, 4)}


def flowgnn_pna(n_nodes: int = 64, n_edges: int = 256, lanes: int = 4,
                seed: int = 7) -> Design:
    """PNA message-passing layer in the FlowGNN dataflow style.

    node_loader streams per-node data in node order: the self-feature
    (skip path to the combine stage), the in-degree (to each aggregator —
    data-dependent trip counts), and the node's FEATURE into ``feat_q``.
    scatter walks the dest-sorted edge stream; edge (u, v) needs feature u,
    so scatter pulls ``feat_q`` forward to u — how far ahead of the
    aggregation frontier the loader must run is a property of the RUNTIME
    GRAPH (an early edge with a late source forces deep buffering).
    Undersized deg/skip queues then deadlock the engine through the cycle
    scatter -> feat_q -> node_loader -> deg_q -> aggregator -> msg ->
    scatter.  Static analysis cannot bound any of this; the paper's §IV-D
    argument.

    Declared depths model the hand-sized original accelerator (the case
    study's "user-defined Baseline-Max": generous node-count-sized control
    queues, 64-deep message lanes).
    """
    edges, deg = _random_graph(n_nodes, n_edges, seed)
    d = Design("flowgnn_pna", args={"edges": edges, "deg": deg})

    d.fifo("edges_q", width=64, depth=32)
    d.fifo("feat_q", width=256, depth=n_nodes)
    d.fifo("skip_q", width=256, depth=n_nodes)
    deg_qs = [d.fifo(f"deg_{a}", width=16, depth=n_nodes) for a in _AGGS]
    msg = {a: d.fifo_array(f"msg_{a}", lanes, width=32, depth=64)
           for a in _AGGS}
    agg = {a: d.fifo(f"agg_{a}", width=32, depth=16) for a in _AGGS}
    d.fifo("out_q", width=32, depth=16)

    @d.task("edge_loader", data_dependent=True)
    def edge_loader(ctx):
        for (u, v) in ctx.arg("edges"):
            yield ctx.delay(1)
            yield ctx.write("edges_q", (u, v))

    @d.task("node_loader", data_dependent=True)
    def node_loader(ctx):
        for v, dv in enumerate(ctx.arg("deg")):
            yield ctx.delay(1)
            yield ctx.write("skip_q", 0.001 * v)
            yield ctx.write("feat_q", 0.01 * v)
            for q in deg_qs:
                yield ctx.write(q, dv)

    @d.task("scatter", data_dependent=True)
    def scatter(ctx):
        n_e = len(ctx.arg("edges"))
        feats: List[float] = []
        for _ in range(n_e):
            yield ctx.delay(1)
            (u, v) = yield ctx.read("edges_q")
            while len(feats) <= u:           # pull features forward to u
                f = yield ctx.read("feat_q")
                feats.append(f)
            yield ctx.delay(1)
            for a in _AGGS:
                yield ctx.write(msg[a][v % lanes], feats[u] + 1.0)

    def make_aggregator(a: str, q: str):
        per_msg, epilogue = _AGG_COST[a]

        def prog(ctx, a=a, q=q, per_msg=per_msg, epilogue=epilogue):
            n_v = len(ctx.arg("deg"))
            for v in range(n_v):
                yield ctx.delay(1)
                dv = yield ctx.read(q)
                acc = 0.0
                for _ in range(dv):          # data-dependent trip count
                    m = yield ctx.read(msg[a][v % lanes])
                    yield ctx.delay(per_msg)
                    acc += m
                yield ctx.delay(epilogue)
                yield ctx.write(agg[a], acc)
        return prog

    for a in _AGGS:
        d.add_task(f"agg_{a}", make_aggregator(a, f"deg_{a}"),
                   data_dependent=True)

    @d.task("combine", data_dependent=True)
    def combine(ctx):
        n_v = len(ctx.arg("deg"))
        total = 0.0
        for _ in range(n_v):
            self_feat = yield ctx.read("skip_q")
            vals = [self_feat]
            for a in _AGGS:
                x = yield ctx.read(agg[a])
                vals.append(x)
            yield ctx.delay(6)               # per-node update MLP
            y = sum(vals) / 4.0
            total += y
            yield ctx.write("out_q", y)
        ctx.result("checksum", total)

    @d.task("store", data_dependent=True)
    def store(ctx):
        n_v = len(ctx.arg("deg"))
        for _ in range(n_v):
            yield ctx.delay(1)
            yield ctx.read("out_q")

    return d
