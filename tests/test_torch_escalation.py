"""The device escalation tier: rows UNRESOLVED at the first cap go
through one K2 launch at a deep cap before the worklist arbiter.

On the CPU no backend engages the tier (K2 runs on CUDA only), so these
tests turn it on in subclasses of the kernel backend and of the
cross-design dispatcher, whose K2 then runs its plain version, with small
deep caps so that some rows stay UNRESOLVED and still reach the worklist.
Against the worklist-only path, row for row and exactly: latency, BRAM,
deadlock, frontiers, hypervolume and every counter; the ``escalation``
span keeps ``rows`` equal to the escalated rows and counts the rows K2
settled in ``device``."""

import glob
import os

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.core import EvalConfig, FifoAdvisor
from repro_torch.core.backends import (BACKENDS, DEADLOCK, HeteroDispatcher,
                                       WorklistBackend)
from repro_torch.core.backends import dispatch as dispatch_mod
from repro_torch.core.backends import mesh as mesh_mod
from repro_torch.core.backends.mesh import MeshBackend
from repro_torch.core.backends.pallas import CudaBackend
from repro_torch.core.campaign import Campaign, CampaignSpec
from repro_torch.core.simgraph import build_simgraph
from repro_torch.designs import flowgnn_pna, mult_by_2
from repro_torch.designs.generate import build_design, load_corpus_specs
from repro_torch.kernels.fifo_eval import ops

#: the first cap: low enough that every design below escalates rows
MAX_ITERS = 3
#: deep caps: 4 leaves most rows UNRESOLVED, 64 settles most of them
DEEP = (4, 64)
CORPUS = sorted(glob.glob(os.path.join(os.path.dirname(__file__),
                                       "fuzz_corpus", "*.json")))


def _designs():
    out = {os.path.basename(p)[:-5]: s.design for p, s in zip(
        CORPUS, map(build_design, load_corpus_specs(CORPUS)))}
    out["m2"] = mult_by_2(24)
    out["pna"] = flowgnn_pna(n_nodes=12, n_edges=30)
    return out


DESIGNS = _designs()


@pytest.fixture(autouse=True)
def _fresh():
    """One torch thread (the plain kernels run many tiny ops) and an
    empty recorder, off, before and after each test."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    obs.disable()
    obs.clear()
    yield
    obs.disable()
    obs.clear()
    torch.set_num_threads(n)


def _tier_backend(base, deep: int):
    class Tier(base):
        name = f"{base.name}_tier{deep}"
        aliases = ()                    # never shadow the base's names
        device_escalation = True
        escalation_iters = deep
    return Tier


def _tier_hetero(deep: int):
    class Tier(HeteroDispatcher):
        device_escalation = True
        escalation_iters = deep
    return Tier


def _recorded(job):
    """``job()`` with the recorder on: its result, the spans' summary and
    records, and the dispatches each closure kind made."""
    before = dict(ops.DISPATCH_COUNTS)
    obs.enable()
    try:
        out = job()
    finally:
        obs.disable()
    counts = {k: v - before.get(k, 0) for k, v in ops.DISPATCH_COUNTS.items()
              if v != before.get(k, 0)}
    return out, obs.summary(), obs.records(), counts


def _children(recs, parent_name, name):
    return [r for r in recs if r[0] == name and r[3] is not None
            and recs[r[3]][0] == parent_name]


def _assert_escalation_spans(summ, recs, n_fallbacks, launch):
    """``rows`` counts the escalated rows; ``device`` the rows the tier's
    launch settled, the worklist solving one row a ``worklist.solve``
    for the rest; one tier launch an ``escalation`` span."""
    esc = summ["escalation"]
    assert esc["attrs"]["rows"] == n_fallbacks > 0
    solved = len(_children(recs, "escalation", "worklist.solve"))
    assert esc["attrs"]["device"] + solved == n_fallbacks
    assert len(_children(recs, "escalation", launch)) == esc["count"]
    return esc["attrs"]["device"]


def _assert_same_dse(a, b):
    for f in ("configs", "latency", "bram", "deadlock"):
        x, y = getattr(a.result, f), getattr(b.result, f)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.frontier_points, b.frontier_points)
    np.testing.assert_array_equal(a.frontier_configs, b.frontier_configs)
    assert a.hypervolume() == b.hypervolume()
    assert a.result.n_evals == b.result.n_evals


def _dse(design, backend, condense="auto", **kw):
    adv = FifoAdvisor(design, EvalConfig(backend=backend,
                                         max_iters=MAX_ITERS,
                                         condense=condense, **kw),
                      device="cpu")
    return adv, adv.run("grouped_sa", budget=60, seed=3)


@pytest.mark.parametrize("deep", DEEP)
@pytest.mark.parametrize("key", sorted(DESIGNS))
def test_dispatch_tier_equals_worklist_only_path(monkeypatch, key, deep):
    tier = _tier_backend(CudaBackend, deep)
    monkeypatch.setitem(BACKENDS, tier.name, tier)
    adv0, want = _dse(DESIGNS[key], "cuda")
    (adv1, got), summ, recs, _ = _recorded(
        lambda: _dse(DESIGNS[key], tier.name))
    _assert_same_dse(want, got)
    assert adv0.evaluator.stats == adv1.evaluator.stats
    _assert_escalation_spans(summ, recs, adv1.evaluator.stats.n_fallbacks,
                             "launch.k2")


def test_rows_unresolved_at_the_deep_cap_still_reach_the_worklist(
        monkeypatch):
    """flowgnn_pna has rows that K2 settles within 64 iterations and rows
    it does not: both kinds come out as the worklist-only path's."""
    tier = _tier_backend(CudaBackend, 64)
    monkeypatch.setitem(BACKENDS, tier.name, tier)
    _, want = _dse(DESIGNS["pna"], "cuda", condense=None)
    (adv, got), summ, recs, _ = _recorded(
        lambda: _dse(DESIGNS["pna"], tier.name, condense=None))
    _assert_same_dse(want, got)
    n = adv.evaluator.stats.n_fallbacks
    device = _assert_escalation_spans(summ, recs, n, "launch.k2")
    assert 0 < device < n


def test_sharded_backend_escalates_on_its_first_device(monkeypatch):
    """A mesh pads its launches to a shard multiple; the tier's launch
    is one unpadded launch on the mesh's first device."""
    d = DESIGNS["pna"]
    adv0, want = _dse(d, "mesh", condense=None, shards=2)
    tier = _tier_backend(MeshBackend, 64)
    monkeypatch.setattr(mesh_mod, "MeshBackend", tier)
    (adv1, got), summ, recs, counts = _recorded(
        lambda: _dse(d, "mesh", condense=None, shards=2))
    assert type(adv1.evaluator._impl) is tier
    _assert_same_dse(want, got)
    n = adv1.evaluator.stats.n_fallbacks
    _assert_escalation_spans(summ, recs, n, "launch.k2")
    # every launch counts as "batched", a sharded one also per shard
    assert counts["batched@shard0"] == counts["batched@shard1"] > 0
    assert counts["batched"] - counts["batched@shard0"] == \
        summ["escalation"]["count"]
    tier_rows = sum(recs[i][4]["rows"] for i, r in enumerate(recs)
                    if r[0] == "launch.k2" and r[3] is not None
                    and recs[r[3]][0] == "escalation")
    assert tier_rows == n


def _items(keys, seed):
    rng = np.random.default_rng(seed)
    items = []
    for k in keys:
        u = build_simgraph(DESIGNS[k]).upper_bounds
        items.append((k, np.concatenate([
            np.maximum(u, 2)[None, :], np.full((1, len(u)), 2),
            np.maximum(2, (u * rng.uniform(0.1, 1.0, (6, len(u)))
                           ).astype(np.int64))])))
    return items


@pytest.mark.parametrize("deep", DEEP)
def test_hetero_tier_equals_worklist_only_path(deep):
    """Every design's UNRESOLVED rows of a dispatch in one launch; what
    is left on each design's own worklist, item by item."""
    keys = sorted(DESIGNS) + ["pna"]       # one design in two items
    graphs = {k: build_simgraph(DESIGNS[k]) for k in keys}
    plain = HeteroDispatcher(graphs, max_iters=MAX_ITERS, device="cpu")
    tier = _tier_hetero(deep)(graphs, max_iters=MAX_ITERS, device="cpu")
    assert not plain.device_escalation and plain._escalate is None
    settled = []
    for seed in (11, 12, 13):
        items = _items(keys, seed)
        before = plain.stats.n_fallbacks
        obs.clear()
        want, summ, recs, _ = _recorded(lambda: plain.dispatch(items))
        # the same layout without the tier: one span, no launch under it
        assert summ["escalation"]["count"] == 1
        assert summ["escalation"]["attrs"] == {
            "rows": plain.stats.n_fallbacks - before}
        assert not _children(recs, "escalation", "launch.k2_hetero")
        before = tier.stats.n_fallbacks
        obs.clear()
        got, summ, recs, counts = _recorded(lambda: tier.dispatch(items))
        for (k, m), g, w in zip(items, got, want):
            for a, b in zip(g, w):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            wlat, wbram, wstatus = tier.worklists[k].evaluate(m)
            np.testing.assert_array_equal(g[2], wstatus == DEADLOCK)
            np.testing.assert_array_equal(
                g[0], np.where(wstatus == DEADLOCK, -1, wlat))
            np.testing.assert_array_equal(g[1], wbram)
        n = tier.stats.n_fallbacks - before
        settled.append((_assert_escalation_spans(
            summ, recs, n, "launch.k2_hetero"), n))
        assert summ["escalation"]["count"] == 1
        assert counts["hetero"] == 2
    for f in ("n_dispatches", "n_rows", "n_pad_rows", "n_fallbacks"):
        assert getattr(tier.stats, f) == getattr(plain.stats, f), f
    if deep == DEEP[0]:
        assert any(d < n for d, n in settled)
    else:
        assert any(d for d, _ in settled)


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_hetero_cpu_escalation_is_one_span_a_dispatch(seed):
    """On the CPU (no tier) a dispatch escalates the UNRESOLVED rows of
    every design in one ``escalation`` span, as with the tier: its
    ``rows`` are the dispatch's ``n_fallbacks``, a ``worklist.solve`` a
    row under it, no launch and no ``device``."""
    keys = sorted(DESIGNS) + ["pna"]
    plain = HeteroDispatcher({k: build_simgraph(DESIGNS[k]) for k in keys},
                             max_iters=MAX_ITERS, device="cpu")
    _, summ, recs, counts = _recorded(
        lambda: plain.dispatch(_items(keys, seed)))
    n = plain.stats.n_fallbacks
    assert summ["escalation"]["count"] == 1
    assert summ["escalation"]["attrs"] == {"rows": n} and n > 0
    assert len(_children(recs, "escalation", "worklist.solve")) == n
    assert not [r for r in recs if r[3] is not None
                and recs[r[3]][0] == "escalation"
                and r[0].startswith("launch.")]
    assert counts == {"hetero": 1}


def test_hetero_campaign_with_the_tier_answers_as_without(monkeypatch):
    def campaign():
        camp = Campaign(CampaignSpec(
            designs=("gemm", "atax"), optimizers=("grouped_sa",),
            budget=40, seed=1, hetero=True,
            eval=EvalConfig(backend="cuda", max_iters=MAX_ITERS)),
            device="cpu")
        return camp, camp.run()
    c0, want = campaign()
    monkeypatch.setattr(dispatch_mod, "HeteroDispatcher", _tier_hetero(64))
    (c1, got), summ, recs, _ = _recorded(campaign)
    assert c1.hetero.device_escalation
    assert list(want.keys()) == list(got.keys())
    for k in want.keys():
        _assert_same_dse(want[k], got[k])
    for f in ("n_dispatches", "n_rows", "n_pad_rows", "n_fallbacks"):
        assert getattr(c1.hetero.stats, f) == getattr(c0.hetero.stats, f)
    fallbacks = c1.hetero.stats.n_fallbacks + sum(
        d.evaluator.stats.n_fallbacks for d in c1.designs.values())
    assert summ["escalation"]["attrs"]["rows"] == fallbacks > 0
    assert summ["escalation"]["attrs"]["device"] > 0


@pytest.mark.parametrize("backend", ["cuda", "fixpoint", "numpy", "mesh"])
def test_cpu_backends_never_engage_the_tier(backend):
    """On the CPU the escalated rows go to the worklist as before: no
    launch inside an ``escalation`` span and no ``device`` attribute."""
    (adv, _), summ, recs, _ = _recorded(lambda: _dse(
        DESIGNS["expand_expand"], backend,
        **({"shards": 2} if backend == "mesh" else {})))
    assert not adv.evaluator._impl.device_escalation
    assert isinstance(adv.evaluator.dispatch.worklist, WorklistBackend)
    n = adv.evaluator.stats.n_fallbacks
    esc = summ.get("escalation", {"attrs": {"rows": 0}})
    assert esc["attrs"] == {"rows": n}
    assert not [r for r in recs if r[3] is not None
                and recs[r[3]][0] == "escalation"
                and r[0].startswith("launch.")]
    if backend != "numpy":
        assert n > 0
        assert len(_children(recs, "escalation", "worklist.solve")) == n
