# A frozen copy of src/repro_torch/designs/moe.py, imports renamed: the
# factory the dsv2_lite_moe configuration names, part of the benchmark's
# yardstick, which later changes to the program do not move.
"""DeepSeek-V2-Lite's MoE layer as an expert-by-expert dataflow engine.

The layer is DeepSeekMoE's (DeepSeek-V2, arXiv:2405.04434, §2.2)::

    h'_t = u_t + sum_{i<=N_s} FFN^s_i(u_t) + sum_{i<=N_r} g_{i,t} FFN^r_i(u_t)
    g_{i,t} = s_{i,t} if s_{i,t} in TopK({s_{j,t}}, K_r) else 0
    s_{i,t} = Softmax_i(u_t^T e_i)

at DeepSeek-V2-Lite's published widths (its ``config.json``: hidden 2048,
64 routed experts of width 1408 with 6 a token, 2 shared experts run as
one MLP of width 2 x 1408, a softmax gate with greedy top-k, no
renormalisation, routed scaling factor 1).

The engine lays each block of tokens out expert by expert, as Edge-MoE
does (Sarkar et al., ICCAD 2023, arXiv:2305.18691), so that each
expert's weights are loaded once a block: a router writes each token
into the queues of its chosen experts, each of ``pes`` expert PEs serves
its experts one after another (expert ``e`` on PE ``e % pes``), draining
an expert's queue to the block's end marker before it starts the next,
and a combine stage drains the PEs one after another, then the shared
expert's queue.  A queue served later fills while its PE is still busy
on an earlier expert; if it is too shallow the router blocks, the end
marker the PE waits for is never written, and the engine deadlocks.  So
an expert queue's least safe depth is about the number of tokens the
block routes to it: fixed by arithmetic on the token values (the gate's
scores and top-k), and different for every expert and every stream.

The router's scores are computed inside the traced program, in float64
(the published gate is float32; float64 keeps the design and the plain
reference on the same side of every top-k boundary).  The experts'
values are not computed: they steer no control, and their cycles are
charged in full (:func:`stage_cycles`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

from portbench.inputs.design import Design

#: DeepSeek-V2-Lite's MoE layer (config.json): ``hidden_size``,
#: ``n_routed_experts``, ``num_experts_per_tok``, ``moe_intermediate_size``
#: and ``n_shared_experts``
DSV2_LITE = dict(hidden=2048, n_experts=64, top_k=6, inter=1408, n_shared=2)
#: bits of one word of a queue item: bf16 (assumed)
WORD_BITS = 16
#: MACs a cycle of one PE (assumed)
MACS_PER_CYCLE = 4096
#: HBM bytes a cycle of one PE (assumed)
HBM_BYTES_PER_CYCLE = 192
#: bytes a cycle of the loader's, combine's and store's stream port (assumed)
PORT_BYTES_PER_CYCLE = 64
#: engine clock cycles in one cycle of the schedule: every stage cost at
#: the published widths is a multiple of it, so the costs stay exact while
#: a whole stream's summed costs stay inside float32's exact integers
TICK_CYCLES = 32
#: topic centroids the token states are drawn around, and the Zipf
#: exponent of a document segment's topic (assumed)
TOPICS = 16
ZIPF_S = 1.0
#: document segments a stream, each of ``n_tokens // 8`` to
#: ``n_tokens // 2`` tokens (assumed; 128-512 of 1,024)
SEGMENTS = 4
#: the noise around a token's topic centroid, relative to the centroid's
#: unit-variance elements (assumed): a block's busiest expert then takes
#: 2-4 times the block's mean
NOISE_SIGMA = 2.9


def stage_cycles(hidden: int, n_experts: int, inter: int,
                 n_shared: int) -> Dict[str, int]:
    """Engine clock cycles of each stage: the router a token
    (``hidden * n_experts`` MACs), a routed expert on a token (its three
    ``hidden x inter`` matrices), the expert's weight load (those
    matrices in bf16 over the PE's HBM share), the shared expert on a
    token and its weight load (width ``n_shared * inter``), and one item
    of the loader, combine and store (a ``hidden``-wide bf16 state over
    the stream port)."""
    def per(n, rate):
        return -(-int(n) // rate)
    ffn, shared = 3 * hidden * inter, 3 * hidden * n_shared * inter
    return {"router": per(hidden * n_experts, MACS_PER_CYCLE),
            "expert": per(ffn, MACS_PER_CYCLE),
            "load": per(2 * ffn, HBM_BYTES_PER_CYCLE),
            "shared": per(shared, MACS_PER_CYCLE),
            "shared_load": per(2 * shared, HBM_BYTES_PER_CYCLE),
            "item": per(2 * hidden, PORT_BYTES_PER_CYCLE)}


def stage_ticks(hidden: int, n_experts: int, inter: int,
                n_shared: int) -> Dict[str, int]:
    """:func:`stage_cycles` in cycles of the schedule
    (:data:`TICK_CYCLES` engine cycles each), rounded up."""
    cycles = stage_cycles(hidden, n_experts, inter, n_shared)
    return {k: -(-c // TICK_CYCLES) for k, c in cycles.items()}


def _segment_lengths(rng: np.random.Generator, n_tokens: int) -> List[int]:
    """:data:`SEGMENTS` lengths of ``n_tokens // 8`` to ``n_tokens // 2``
    tokens summing to ``n_tokens``: the first ones uniform, redrawn until
    the last fits."""
    lo, hi = n_tokens // 8, n_tokens // 2
    while True:
        head = [int(x) for x in rng.integers(lo, hi + 1, SEGMENTS - 1)]
        last = n_tokens - sum(head)
        if lo <= last <= hi:
            return head + [last]


def token_stream(n_tokens: int, hidden: int, n_experts: int,
                 seed: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(states, gate, topics)`` drawn from ``seed``: the gate's weights
    ``(n_experts, hidden)`` uniform in ``±1/sqrt(hidden)``
    (``torch.nn.Linear``'s bound), and ``n_tokens`` RMS-normalised token
    states ``(n_tokens, hidden)``, each its segment's topic centroid
    (``N(0, I)``, one of :data:`TOPICS`, drawn Zipf(:data:`ZIPF_S`)) plus
    :data:`NOISE_SIGMA` times ``N(0, I)`` noise; ``topics`` is each
    token's topic."""
    rng = np.random.default_rng(int(seed) % 2 ** 64)
    gate = rng.uniform(-1.0, 1.0, (n_experts, hidden)) / math.sqrt(hidden)
    centroids = rng.standard_normal((TOPICS, hidden))
    lengths = _segment_lengths(rng, n_tokens)
    p = 1.0 / np.arange(1, TOPICS + 1) ** ZIPF_S
    picked = rng.choice(TOPICS, size=SEGMENTS, p=p / p.sum())
    topics = np.repeat(picked, lengths)
    x = centroids[topics] + NOISE_SIGMA * rng.standard_normal(
        (n_tokens, hidden))
    x /= np.sqrt(np.mean(x * x, axis=1, keepdims=True))
    return x, gate, topics


def route(u: np.ndarray, gate: np.ndarray,
          top_k: int) -> Tuple[List[int], List[float]]:
    """The DeepSeek-V2 gate on one token in float64: softmax over the
    experts' scores ``gate @ u``, the greedy top ``top_k``, gates not
    renormalised, factor 1.  Returns the chosen experts in index order
    and their gates."""
    logits = gate @ u
    s = np.exp(logits - logits.max())
    s /= s.sum()
    chosen = sorted(int(e) for e in np.argpartition(-s, top_k - 1)[:top_k])
    return chosen, [float(s[e]) for e in chosen]


def moe_engine(states: np.ndarray, gate: np.ndarray, *, block: int,
               pes: int, top_k: int, inter: int, n_shared: int,
               name: str = "moe_engine", **args) -> Design:
    """The expert-by-expert engine (module docstring) over the token
    ``states`` ``(n_tokens, hidden)``, in blocks of ``block`` tokens (the
    last may be short), routed by the gate's weights ``gate``
    ``(n_experts, hidden)`` and served by ``pes`` PEs; ``inter`` and
    ``n_shared`` size the experts' costs (:func:`stage_ticks`), and
    ``args`` join the design's arguments.

    Tasks: ``loader`` writes each token's state to ``tok_q`` and
    ``shr_q``; ``router`` reads ``tok_q``, routes the token
    (:func:`route`) and writes ``(u_t, t, g)`` to ``x[e]`` for each
    chosen ``e`` in index order, and at each block's end an end marker
    (None) to every ``x[e]``; ``pe[p]`` serves experts ``e ≡ p (mod
    pes)`` in index order, draining ``x[e]`` to the marker, loading the
    expert's weights before its first token of the block and writing
    ``(t, e, g)`` to ``y[p]`` a token, then a marker to ``y[p]`` once the
    block's experts are done; ``shared`` reads ``shr_q`` and writes each
    token's ``t`` to ``s_q`` (its weights loaded once a block);
    ``combine`` drains ``y[0]`` ... ``y[pes - 1]`` to their markers,
    reads the block's ``s_q`` items, then writes the block's records to
    ``out_q`` in token order; ``store`` reads ``out_q``.  Each token's
    ``(expert ids, gates)`` in the order ``combine`` received them are
    ``ctx.result("routes")``.

    A queue item is as wide as the record it carries, in
    :data:`WORD_BITS`-bit words: a state on ``tok_q``, ``shr_q`` and
    ``out_q``; a state, ``t`` and ``g`` on ``x[e]``; the expert's output
    (not computed), ``t``, ``e`` and ``g`` on ``y[p]``; the shared
    expert's output and ``t`` on ``s_q``.  Declared depths are what a
    hand-sized engine takes to be safe for any routing (Baseline-Max):
    ``x[e]`` ``block + 1``, ``y[p]`` ``top_k * block + 1``, ``s_q``
    ``block``, the rest 16.
    """
    n_tokens, hidden = states.shape
    n_experts = gate.shape[0]
    if n_experts % pes:
        raise ValueError("n_experts must be whole PEs")
    ticks = stage_ticks(hidden=hidden, n_experts=n_experts, inter=inter,
                        n_shared=n_shared)
    d = Design(name, args={
        **args, "states": states, "gate": gate, "block": block,
        "pes": pes, "top_k": top_k, "ticks": ticks})
    state_bits = hidden * WORD_BITS
    d.fifo("tok_q", width=state_bits, depth=16)
    d.fifo("shr_q", width=state_bits, depth=16)
    xq = d.fifo_array("x", n_experts, width=state_bits + 2 * WORD_BITS,
                      depth=block + 1)
    yq = d.fifo_array("y", pes, width=state_bits + 3 * WORD_BITS,
                      depth=top_k * block + 1)
    d.fifo("s_q", width=state_bits + WORD_BITS, depth=block)
    d.fifo("out_q", width=state_bits, depth=16)
    blocks = [range(b, min(b + block, n_tokens))
              for b in range(0, n_tokens, block)]

    @d.task("loader", data_dependent=True)
    def loader(ctx):
        for u in ctx.arg("states"):
            yield ctx.delay(ticks["item"])
            yield ctx.write("tok_q", u)
            yield ctx.write("shr_q", u)

    @d.task("router", data_dependent=True)
    def router(ctx):
        w = ctx.arg("gate")
        for tokens in blocks:
            for t in tokens:
                u = yield ctx.read("tok_q")
                yield ctx.delay(ticks["router"])
                for e, g in zip(*route(u, w, top_k)):
                    yield ctx.write(xq[e], (u, t, g))
            for q in xq:
                yield ctx.write(q, None)

    def make_pe(p: int):
        def pe(ctx):
            for _ in blocks:
                for e in range(p, n_experts, pes):
                    item = yield ctx.read(xq[e])
                    if item is not None:
                        yield ctx.delay(ticks["load"])
                    while item is not None:
                        _, t, g = item
                        yield ctx.delay(ticks["expert"])
                        yield ctx.write(yq[p], (t, e, g))
                        item = yield ctx.read(xq[e])
                yield ctx.write(yq[p], None)
        return pe

    for p in range(pes):
        d.add_task(f"pe[{p}]", make_pe(p), data_dependent=True)

    @d.task("shared", data_dependent=True)
    def shared(ctx):
        for t in range(n_tokens):
            if t % block == 0:
                yield ctx.delay(ticks["shared_load"])
            yield ctx.read("shr_q")
            yield ctx.delay(ticks["shared"])
            yield ctx.write("s_q", t)

    @d.task("combine", data_dependent=True)
    def combine(ctx):
        routes: List[Tuple[Tuple[int, ...], Tuple[float, ...]]] = []
        for tokens in blocks:
            got: List[List[Tuple[int, float]]] = [[] for _ in tokens]
            for q in yq:
                item = yield ctx.read(q)
                while item is not None:
                    t, e, g = item
                    yield ctx.delay(ticks["item"])
                    got[t - tokens.start].append((e, g))
                    item = yield ctx.read(q)
            for _ in tokens:
                yield ctx.read("s_q")
                yield ctx.delay(ticks["item"])
            for t, pairs in zip(tokens, got):
                ids, gs = (tuple(v) for v in zip(*pairs))
                routes.append((ids, gs))
                yield ctx.write("out_q", (t, ids, gs))
        ctx.result("routes", routes)

    @d.task("store", data_dependent=True)
    def store(ctx):
        for _ in range(n_tokens):
            yield ctx.read("out_q")
            yield ctx.delay(ticks["item"])

    return d


def routed_moe_stream(n_tokens: int, block: int, pes: int, seed: int, *,
                      hidden: int, n_experts: int, top_k: int, inter: int,
                      n_shared: int,
                      name: str = "routed_moe_stream") -> Design:
    """:func:`moe_engine` over the stream of ``n_tokens`` token states
    and the gate that :func:`token_stream` draws from ``seed``, at the
    widths given; the design's arguments also hold each token's topic
    and the seed."""
    x, gate, topics = token_stream(n_tokens, hidden, n_experts, seed)
    return moe_engine(x, gate, block=block, pes=pes, top_k=top_k,
                      inter=inter, n_shared=n_shared, name=name,
                      topics=topics, seed=int(seed))


def dsv2_lite_moe_stream(n_tokens: int = 1024, block: int = 256,
                         pes: int = 8, seed: int = 0) -> Design:
    """DeepSeek-V2-Lite's MoE layer (:data:`DSV2_LITE`) as the
    expert-by-expert engine (:func:`routed_moe_stream`) over a stream of
    ``n_tokens`` token states drawn from ``seed``."""
    return routed_moe_stream(n_tokens, block, pes, seed,
                             name="dsv2_lite_moe_stream", **DSV2_LITE)
