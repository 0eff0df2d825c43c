"""The certifier's speculative bisection (``certify._descend`` with
``levels`` above 1): one evaluator call carries the next levels of a
FIFO's bisection tree, and the walk follows the one-row search's path
through the answers.  On the CPU the walk is forced through ``_descend``'s
``levels``; the result, the probe and hit counts, the cache's rows in
their order and the escalated rows must equal the one-row search's and
the reference's, and the evaluator calls must fall to about a third."""

import types

import numpy as np
import pytest
import torch

from repro.core import EvalConfig as RefEvalConfig
from repro.core.backends import ConfigCache as RefConfigCache
from repro.core.bounds import channel_bounds as ref_channel_bounds
from repro.core.deadlock import certify_min_depths as ref_certify
from repro.core.simgraph import build_simgraph as ref_build_simgraph
from repro.core.simulate import BatchedEvaluator as RefEvaluator
from repro.designs import flowgnn_pna as ref_flowgnn_pna
from repro.designs import generate_design as ref_generate_design
from repro.designs import make_design as ref_make_design
from repro.designs import mult_by_2 as ref_mult_by_2

from repro_torch import obs
from repro_torch.core import EvalConfig
from repro_torch.core.backends import ConfigCache
from repro_torch.core.bounds import channel_bounds
from repro_torch.core.deadlock import certify as C
from repro_torch.core.simgraph import build_simgraph
from repro_torch.core.simulate import BatchedEvaluator
from repro_torch.designs import (flowgnn_pna, generate_design, make_design,
                                 mult_by_2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain kernels run many tiny torch ops; with several test
    workers on one host, torch's intra-op threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Ref:
    make_design = staticmethod(ref_make_design)
    mult_by_2 = staticmethod(ref_mult_by_2)
    flowgnn_pna = staticmethod(ref_flowgnn_pna)
    generate_design = staticmethod(ref_generate_design)
    build_simgraph = staticmethod(ref_build_simgraph)


class _Port:
    make_design = staticmethod(make_design)
    mult_by_2 = staticmethod(mult_by_2)
    flowgnn_pna = staticmethod(flowgnn_pna)
    generate_design = staticmethod(generate_design)
    build_simgraph = staticmethod(build_simgraph)


#: the designs of ``tests/test_torch_deadlock.py``'s ``CERT_DESIGNS``
CERT_DESIGNS = [
    ("mult_by_2_24", lambda m: m.mult_by_2(24)),
    ("flowgnn_pna_24", lambda m: m.flowgnn_pna(n_nodes=24, n_edges=64)),
    ("gemm", lambda m: m.make_design("gemm")),
    ("mvt", lambda m: m.make_design("mvt")),
    ("gen14q", lambda m: m.generate_design(14, quick=True).design),
    ("gen13", lambda m: m.generate_design(13).design),
]
_IDS = [s[0] for s in CERT_DESIGNS]
_RESULT = ("depths", "start", "latency", "bram", "n_probes",
           "n_cache_hits")


def _graphs(factory):
    return (_Ref.build_simgraph(factory(_Ref)),
            _Port.build_simgraph(factory(_Port)))


def _evaluator(g, backend, max_iters=256):
    return BatchedEvaluator(g, EvalConfig(backend=backend,
                                          max_iters=max_iters),
                            device="cpu")


def _certify(g, backend, levels, cache=None, upper=None, max_iters=256,
             seeded=True):
    """``_descend`` through a fresh evaluator and ``cache``, seeded by the
    channel bounds or not: ``(result, tally, evaluator, cache)``."""
    ev = _evaluator(g, backend, max_iters)
    cache = cache if cache is not None else ConfigCache(g.n_fifos)
    res, tally = C._descend(g, C._CachedProbe(ev, cache), upper, None,
                            bounds=channel_bounds(g) if seeded else None,
                            levels=levels)
    return res, tally, ev, cache


def _assert_same_result(got, want):
    for k in _RESULT:
        a, b = getattr(got, k), getattr(want, k)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, k
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            assert a == b, k


def _assert_same_cache(got, want):
    n = len(want)
    assert len(got) == n
    for name in ("_rows", "_lat", "_bram", "_dead"):
        np.testing.assert_array_equal(getattr(got, name)[:n],
                                      getattr(want, name)[:n],
                                      err_msg=name)
    assert (got.stats.hits, got.stats.misses) == \
        (want.stats.hits, want.stats.misses)


def _steps(lo: int, hi: int, depth: int) -> int:
    """Probes of the one-row bisection from ``(lo, hi)`` to ``depth``, the
    least feasible value of its coordinate."""
    n = 0
    while lo < hi:
        mid = (lo + hi) // 2
        lo, hi = (mid + 1, hi) if mid < depth else (lo, mid)
        n += 1
    return n


def _launch_bound(g, res, levels: int, seeded: bool) -> int:
    """At most ⌈steps / levels⌉ calls a FIFO, plus the start, shortcut
    and final probes."""
    floor = np.maximum(np.minimum(channel_bounds(g).lower, res.start), 1) \
        if seeded else np.ones_like(res.start)
    if seeded and np.array_equal(res.depths, floor):   # the shortcut held
        return 3
    return 3 + sum(-(-_steps(int(lo), int(hi), int(d)) // levels)
                   for lo, hi, d in zip(floor, res.start, res.depths))


@pytest.mark.parametrize("seeded", [True, False], ids=["seeded", "unseeded"])
@pytest.mark.parametrize("levels", [2, 3])
@pytest.mark.parametrize("backend", ["cuda", "fixpoint"])
@pytest.mark.parametrize("name,factory", CERT_DESIGNS, ids=_IDS)
def test_speculative_walk_equals_sequential_and_reference(name, factory,
                                                          backend, levels,
                                                          seeded):
    """Seeded by the channel bounds (most designs settle in the shortcut
    probe) and unseeded (every FIFO searched)."""
    ref_g, g = _graphs(factory)
    seq, seq_tally, seq_ev, seq_cache = _certify(g, backend, 1,
                                                 seeded=seeded)
    got, tally, ev, cache = _certify(g, backend, levels, seeded=seeded)
    ref_cache = RefConfigCache(ref_g.n_fifos)
    want = ref_certify(ref_g, RefEvaluator(ref_g, RefEvalConfig(
        backend="numpy")), cache=ref_cache,
        bounds=ref_channel_bounds(ref_g) if seeded else None)

    _assert_same_result(got, want)
    _assert_same_result(seq, want)
    _assert_same_cache(cache, seq_cache)
    np.testing.assert_array_equal(cache._rows[:len(cache)],
                                  ref_cache._rows[:len(ref_cache)])

    # the one-row search launches once a probe and speculates nothing
    assert seq_tally == {"launches": seq.n_probes, "spec_rows": 0}
    assert seq_ev.stats.n_calls == seq.n_probes
    # every call is counted, and every row launched is a probe or wasted
    assert ev.stats.n_calls == tally["launches"]
    assert ev.stats.n_configs == got.n_probes + tally["spec_rows"]
    assert ev.stats.n_fallbacks == seq_ev.stats.n_fallbacks
    assert tally["launches"] <= _launch_bound(g, got, levels, seeded)
    if got.n_probes > 8:
        assert tally["launches"] < seq_tally["launches"]


@pytest.mark.parametrize("levels", [2, 3])
@pytest.mark.parametrize("name", ["flowgnn_pna_24", "gemm", "gen13"])
def test_hits_mid_tree_count_as_the_sequential_search_counts(name, levels):
    """Unseeded, from a cache that already holds every third row the
    one-row search probes: hits fall inside the trees, and the walk
    counts them, launches around them and leaves the cache as the
    one-row search does."""
    factory = dict(CERT_DESIGNS)[name]
    g = _Port.build_simgraph(factory(_Port))
    first, _, _, full = _certify(g, "cuda", 1, seeded=False)
    assert first.n_probes > 6
    rows = full._rows[:len(full)]
    keep = np.arange(1, len(rows) - 1, 3)

    def prefilled():
        c = ConfigCache(g.n_fifos)
        c.insert(rows[keep], full._lat[keep], full._bram[keep],
                 full._dead[keep])
        return c

    seq, _, seq_ev, seq_cache = _certify(g, "cuda", 1, cache=prefilled(),
                                         seeded=False)
    got, tally, ev, cache = _certify(g, "cuda", levels, cache=prefilled(),
                                     seeded=False)
    _assert_same_result(got, seq)
    for k in ("depths", "latency", "bram"):   # the cache moves the counts
        np.testing.assert_array_equal(getattr(seq, k), getattr(first, k))
    assert seq.n_cache_hits > first.n_cache_hits
    _assert_same_cache(cache, seq_cache)
    assert ev.stats.n_configs == got.n_probes + tally["spec_rows"]
    assert tally["launches"] <= _launch_bound(g, got, levels, False)


@pytest.mark.parametrize("levels", [2, 3])
@pytest.mark.parametrize("backend", ["cuda", "fixpoint"])
def test_unvisited_rows_are_never_escalated(backend, levels):
    """gemm from its declared upper bounds, unseeded, at an iteration cap
    of 2: probes go UNRESOLVED.  Only the visited ones reach the
    ``escalation`` span, so its rows and the fallback count equal the
    one-row search's, and the result the reference's."""
    g = build_simgraph(make_design("gemm"))
    ref_g = ref_build_simgraph(ref_make_design("gemm"))
    u = np.asarray(g.upper_bounds, dtype=np.int64)
    runs = {}
    obs.clear()
    obs.enable()
    try:
        for k in (1, levels):
            out = _certify(g, backend, k, upper=u, max_iters=2,
                           seeded=False)
            runs[k] = (obs.summary().get("escalation", {}).get(
                "attrs", {}).get("rows", 0), out)
            obs.clear()
    finally:
        obs.disable()
        obs.clear()
    seq_rows, (seq, _, seq_ev, seq_cache) = runs[1]
    got_rows, (got, tally, ev, cache) = runs[levels]
    want = ref_certify(ref_g, RefEvaluator(ref_g, RefEvalConfig(
        backend="numpy", max_iters=2)), cache=RefConfigCache(ref_g.n_fifos),
        upper=u)
    _assert_same_result(got, want)
    _assert_same_result(seq, want)
    assert seq_rows > 0 and got_rows == seq_rows
    assert ev.stats.n_fallbacks == seq_ev.stats.n_fallbacks == seq_rows
    assert tally["spec_rows"] > 0
    _assert_same_cache(cache, seq_cache)


def test_the_tree_is_the_bisections_next_levels():
    assert C._tree_mids(3, 3, 3) == []
    assert C._tree_mids(1, 2, 3) == [1]
    assert C._tree_mids(1, 8, 1) == [4]
    # (1, 8): 4; then (1, 4) and (5, 8): 2, 6; then 1, 3, 5, 7
    assert C._tree_mids(1, 8, 3) == [4, 2, 6, 1, 3, 5, 7]
    # nodes exist only while lo < hi: (1, 3) -> 2; (1, 2) -> 1; (3, 3) none
    assert C._tree_mids(1, 3, 3) == [2, 1]
    for lo, hi in ((1, 100), (7, 9), (1, 1024)):
        for k in (1, 2, 3, 4):
            mids = C._tree_mids(lo, hi, k)
            assert len(mids) == len(set(mids)) <= 2 ** k - 1
            assert all(lo <= m < hi for m in mids)


def test_speculation_engages_only_where_a_call_pays_by_the_launch():
    """The depth follows what the evaluator reports: the deepest tree in
    the smallest bucket above one row where a call pays by the launch;
    one level elsewhere, so every CPU evaluator searches row by row."""
    def ev(per_launch, buckets):
        return types.SimpleNamespace(
            _pays_per_launch=per_launch,
            dispatch=types.SimpleNamespace(buckets=buckets))
    assert C._tree_levels(ev(True, (1, 8, 32, 128))) == 3
    assert C._tree_levels(ev(True, (1, 32))) == 5
    assert C._tree_levels(ev(True, (1, 2, 4))) == 1
    assert C._tree_levels(ev(False, (1, 8))) == 1
    assert C._tree_levels(object()) == 1
    g = build_simgraph(mult_by_2(8))
    for backend in ("cuda", "fixpoint", "numpy"):
        e = _evaluator(g, backend)
        assert not e._pays_per_launch
        assert C._CachedProbe(e, None).levels == 1


def test_certify_span_counts_launches_and_wasted_rows():
    """The ``certify`` span's ``launches`` and ``spec_rows``: one launch a
    probe and nothing wasted on a search that does not speculate."""
    g = build_simgraph(make_design("gemm"))
    obs.clear()
    obs.enable()
    try:
        res = C.certify_min_depths(g, _evaluator(g, "cuda"),
                                   cache=ConfigCache(g.n_fifos),
                                   bounds=channel_bounds(g))
        attrs = obs.summary()["certify"]["attrs"]
    finally:
        obs.disable()
        obs.clear()
    assert attrs["probes"] == res.n_probes > 0
    assert attrs["launches"] == res.n_probes
    assert attrs["spec_rows"] == 0
