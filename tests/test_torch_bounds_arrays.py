"""The bounds engine's array passes against the reference package's
per-event loops, run on the port's own graphs: the need-DP, pair
feasibility on every candidate of every multi-FIFO pair's grids (siblings
at their top candidates), and the pair bounds with the ``local_bounds``
span's counts.  The designs are the Stream-HLS ones where pair pruning
has work, a MolHIV stream, and hand-built graphs: a task that writes and
reads its own FIFOs (a pair of one segment), and reads whose
``data_src`` is not earlier than the read."""

import dataclasses

import numpy as np
import pytest

from repro.core import bounds as ref_bounds
from repro.core import prune as ref_prune

from repro_torch import obs
from repro_torch.core import EvalConfig
from repro_torch.core.bounds import _required_write_ranks, channel_bounds
from repro_torch.core.design import READ, Design
from repro_torch.core.optimizers import EvalContext
from repro_torch.core.prune import (local_lower_bounds, pair_feasible,
                                    task_pairs)
from repro_torch.core.simgraph import build_simgraph
from repro_torch.core.simulate import BatchedEvaluator
from repro_torch.designs import (flowgnn_pna_stream, make_design,
                                 molhiv_stream, mult_by_2)


def _self_loop(n: int = 8) -> Design:
    """Task ``loop`` writes ``a`` and ``b`` and reads each back two
    iterations behind (depth 3 runs, 2 deadlocks), then drains; ``src`` feeds
    ``sink`` over ``c`` and ``e`` in opposite orders (depth n runs on one
    of them)."""
    d = Design("self_loop")
    for name in ("a", "b", "c", "e"):
        d.fifo(name, width=32)

    @d.task("loop")
    def loop(ctx):
        for i in range(n):
            yield ctx.write("a", i)
            yield ctx.write("b", i)
            if i >= 2:
                yield ctx.read("a")
                yield ctx.read("b")
        for _ in range(2):
            yield ctx.read("b")
            yield ctx.read("a")

    @d.task("src")
    def src(ctx):
        for i in range(n):
            yield ctx.write("c", i)
        for i in range(n):
            yield ctx.write("e", i)

    @d.task("sink")
    def sink(ctx):
        for _ in range(n):
            yield ctx.delay(1)
            yield ctx.read("e")
            yield ctx.read("c")

    return d


# (id, factory, whether some checked depth vector is infeasible)
DESIGNS = [
    ("k15mmtree", lambda: make_design("k15mmtree"), True),
    ("FeedForward", lambda: make_design("FeedForward"), False),
    ("k15mmseq", lambda: make_design("k15mmseq"), False),
    ("molhiv_stream_32_23",
     lambda: flowgnn_pna_stream(molhiv_stream(32, 23), seed=23), False),
    ("mult_by_2_16", lambda: mult_by_2(16), True),
    ("self_loop", _self_loop, True),
]
IDS = [c[0] for c in DESIGNS]


def _graph_and_grids(factory):
    g = build_simgraph(factory())
    cand = EvalContext(g, BatchedEvaluator(
        g, EvalConfig(backend="numpy"))).candidates
    return g, cand


def _multi_pairs(g):
    return [(p, fs) for p, fs in task_pairs(g).items() if len(fs) > 1]


@pytest.mark.parametrize("name,factory,has_infeasible", DESIGNS, ids=IDS)
def test_pair_feasible_equals_reference(name, factory, has_infeasible):
    g, cand = _graph_and_grids(factory)
    pairs = _multi_pairs(g)
    assert pairs
    assert task_pairs(g) == ref_prune.task_pairs(g)
    assert list(task_pairs(g)) == list(ref_prune.task_pairs(g))
    answers = []
    for pair, fifos in pairs:
        top = {f: int(cand[f][-1]) for f in fifos}
        for f in fifos:
            for c in cand[f]:
                depths = {**top, f: int(c)}
                got = pair_feasible(g, pair, fifos, depths)
                assert isinstance(got, bool)
                assert got == ref_prune.pair_feasible(g, pair, fifos,
                                                      depths), (pair, f, c)
                answers.append(got)
    assert any(answers)
    assert (not all(answers)) == has_infeasible


def test_pair_feasible_on_one_segment_at_every_depth():
    """The self-loop pair at every depth from 1 past its need, each FIFO
    alone and both together, and the cross pair read both ways round."""
    g = build_simgraph(_self_loop())
    pairs = dict(_multi_pairs(g))
    assert (0, 0) in pairs and (1, 2) in pairs
    seen = set()
    for pair, fifos in pairs.items():
        for order in (pair, pair[::-1]):
            for d in range(1, 11):
                for depths in ({fifos[0]: d, fifos[1]: 10},
                               {fifos[0]: 10, fifos[1]: d},
                               {f: d for f in fifos}):
                    got = pair_feasible(g, order, fifos, depths)
                    assert got == ref_prune.pair_feasible(
                        g, order, fifos, depths), (order, depths)
                    seen.add((pair, got))
    assert seen == {((0, 0), True), ((0, 0), False),
                    ((1, 2), True), ((1, 2), False)}


@pytest.mark.parametrize("name,factory,has_infeasible", DESIGNS, ids=IDS)
def test_local_bounds_and_span_counts_equal_reference(
        name, factory, has_infeasible, monkeypatch):
    g, cand = _graph_and_grids(factory)
    calls = []
    real = ref_prune.pair_feasible

    def counted(*args):
        calls.append(args[1])
        return real(*args)

    monkeypatch.setattr(ref_prune, "pair_feasible", counted)
    want = ref_prune.local_lower_bounds(g, cand)
    obs.clear()
    obs.enable()
    try:
        got = local_lower_bounds(g, cand)
        summ = obs.summary()
    finally:
        obs.disable()
        obs.clear()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert (got > 2).any() == has_infeasible
    assert summ["local_bounds"]["attrs"] == {
        "fifos": g.n_fifos, "pairs": len(_multi_pairs(g)),
        "checks": len(calls)}


@pytest.mark.parametrize("name,factory,has_infeasible", DESIGNS, ids=IDS)
def test_need_dp_equals_reference(name, factory, has_infeasible):
    g = build_simgraph(factory())
    got, want = _required_write_ranks(g), ref_bounds._required_write_ranks(g)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _late_sources(g):
    """``g`` with the reads' ``data_src`` moved to the read itself, to a
    later event of its own segment, to an event of a later segment, to
    -1, and (kept) to earlier events of its own and other segments."""
    src = g.data_src.copy()
    reads = np.flatnonzero(g.kind == READ)
    starts = np.flatnonzero(g.seg_start)
    end_of = np.append(starts[1:], g.n_events)[
        np.searchsorted(starts, reads, side="right") - 1]
    for i, r in enumerate(reads):
        mode = i % 5
        if mode == 0:
            src[r] = r
        elif mode == 1 and r + 1 < end_of[i]:
            src[r] = end_of[i] - 1
        elif mode == 2 and end_of[i] < g.n_events:
            src[r] = g.n_events - 1
        elif mode == 3:
            src[r] = -1
    return dataclasses.replace(g, data_src=src), src


@pytest.mark.parametrize("factory", [_self_loop, lambda: mult_by_2(6)],
                         ids=["self_loop", "mult_by_2_6"])
def test_need_dp_ignores_sources_not_before_the_read(factory):
    g, src = _late_sources(build_simgraph(factory()))
    later = src >= np.arange(g.n_events)
    reads = g.kind == READ
    assert (later & reads).any() and (src[reads] == -1).any()
    got, want = _required_write_ranks(g), ref_bounds._required_write_ranks(g)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    got_b, want_b = channel_bounds(g), ref_bounds.channel_bounds(g)
    for k in ("lower", "upper", "slack"):
        a, b = getattr(got_b, k), getattr(want_b, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert got_b.kinds == want_b.kinds
