"""DeepSeek-V2-Lite's MoE layer as an expert-by-expert engine
(``designs/moe.py``): the routes against the benchmark's plain gate
(``portbench/reference/moe_gate.py``) at a small size and at the
published widths, the stream's shape, the port's rows and certificate
against its discrete-event oracle and the JAX package's, and the
deadlock an undersized expert queue causes."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from repro.core.deadlock import certify_min_depths_oracle as ref_certify_oracle
from repro.core.oracle import simulate as ref_simulate
from repro_torch.core import EvalConfig, FifoAdvisor
from repro_torch.core.backends import F32_EXACT_LIMIT
from repro_torch.core.bram import design_bram_np
from repro_torch.core.oracle import simulate
from repro_torch.core.pareto import pareto_front
from repro_torch.core.simgraph import build_simgraph
from repro_torch.core.tracer import collect_trace
from repro_torch.designs import dsv2_lite_moe_stream, routed_moe_stream
from repro_torch.designs.moe import (DSV2_LITE, TICK_CYCLES, WORD_BITS,
                                     stage_cycles, stage_ticks)

#: the small engine of the CPU tests: hidden 64, 8 experts, top-2, 2 PEs,
#: blocks of 16, 64 tokens
SMALL = dict(hidden=64, n_experts=8, top_k=2, inter=44, n_shared=2)
SMALL_RUN = dict(n_tokens=64, block=16, pes=2)
SEEDS = (0, 7, 2 ** 31 + 12345)
#: both sides are float64 and only their summation orders differ; a
#: float32 gate rounds at ~6e-8 relative, far above this
RTOL = 1e-12


def _moe_gate():
    path = os.path.join(os.path.dirname(__file__), "..", "portbench",
                        "reference", "moe_gate.py")
    spec = importlib.util.spec_from_file_location("portbench_ref_moe_gate",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.moe_gate


def _small(seed: int):
    return routed_moe_stream(seed=seed, **SMALL_RUN, **SMALL)


def _assert_routes_equal(routes, d, top_k: int, pes: int):
    """The design's routes (receipt order) against the reference gate:
    ids exactly, gates to :data:`RTOL` relative."""
    ids, gates = _moe_gate()(d.args["states"], d.args["gate"], top_k)
    assert len(routes) == ids.shape[0]
    for t, (got_ids, got_gates) in enumerate(routes):
        # combine drains the PEs in order, each PE its experts in order
        assert list(got_ids) == sorted(got_ids, key=lambda e: (e % pes, e))
        order = np.argsort(got_ids)
        np.testing.assert_array_equal(np.asarray(got_ids)[order],
                                      ids[t].numpy())
        np.testing.assert_allclose(np.asarray(got_gates)[order],
                                   gates[t].numpy(), rtol=RTOL, atol=0)


@pytest.mark.parametrize("seed", SEEDS)
def test_small_routes_equal_the_plain_gate(seed):
    d = _small(seed)
    traced = collect_trace(d).results["routes"]
    _assert_routes_equal(traced, d, SMALL["top_k"], SMALL_RUN["pes"])
    simulated = simulate(d, [f.depth for f in d.fifos]).results["routes"]
    assert simulated == traced


def test_a_float32_gate_misses_the_tolerance():
    d = _small(SEEDS[0])
    moe_gate = _moe_gate()
    a = d.args
    _, want = moe_gate(a["states"], a["gate"], SMALL["top_k"])
    _, f32 = moe_gate(a["states"], a["gate"], SMALL["top_k"],
                      dtype=torch.float32)
    rel = ((f32.double() - want).abs() / want.abs()).max()
    assert float(rel) > 1e3 * RTOL


def test_published_width_routes_equal_the_plain_gate():
    d = dsv2_lite_moe_stream(seed=SEEDS[2])
    assert d.args["states"].shape == (1024, DSV2_LITE["hidden"])
    assert d.args["gate"].shape == (DSV2_LITE["n_experts"],
                                    DSV2_LITE["hidden"])
    _assert_routes_equal(collect_trace(d).results["routes"], d,
                         DSV2_LITE["top_k"], 8)


def test_published_stage_costs_are_whole_schedule_cycles():
    widths = {k: v for k, v in DSV2_LITE.items() if k != "top_k"}
    cycles = stage_cycles(**widths)
    assert cycles == {"router": 32, "expert": 2112, "load": 90112,
                      "shared": 4224, "shared_load": 180224, "item": 64}
    ticks = stage_ticks(**widths)
    assert {k: ticks[k] * TICK_CYCLES for k in ticks} == cycles


def test_published_stream_shape():
    d = dsv2_lite_moe_stream(seed=SEEDS[1])
    trace = collect_trace(d)
    g = build_simgraph(d, trace)
    assert 25_000 <= g.n_events <= 65_536
    assert g.latency_upper_bound() < F32_EXACT_LIMIT
    assert d.n_fifos == 76 and d.n_tasks == 13
    groups = d.groups()
    assert len(groups["x"]) == 64 and len(groups["y"]) == 8
    state = DSV2_LITE["hidden"] * WORD_BITS
    want = {"tok_q": (state, 16), "shr_q": (state, 16),
            "s_q": (state + WORD_BITS, 256), "out_q": (state, 16),
            "x": (state + 2 * WORD_BITS, 257),
            "y": (state + 3 * WORD_BITS, 6 * 256 + 1)}
    for f in d.fifos:
        assert (f.width, f.depth) == want[f.group or f.name], f.name
    # every token reaches 6 experts; a block's busiest expert takes 2-4x
    # the block's mean of 24 tokens (the median block of this stream)
    counts = np.zeros((4, 64), dtype=np.int64)
    for t, (ids, _) in enumerate(trace.results["routes"]):
        assert len(set(ids)) == 6
        counts[t // 256, list(ids)] += 1
    assert (counts.sum(axis=1) == 6 * 256).all()
    assert 2 <= np.median(counts.max(axis=1)) / 24 <= 4


@pytest.mark.parametrize("seed", SEEDS)
def test_baseline_max_never_deadlocks(seed):
    for d in (_small(seed), dsv2_lite_moe_stream(seed=seed)):
        u = np.maximum([f.depth for f in d.fifos], 2)
        assert not simulate(d, u).deadlocked, (d.name, seed)


def test_rows_frontier_and_certificate_equal_the_oracle():
    """A search's rows, its frontier and baselines against the port's
    oracle and the JAX package's, the certificate against the JAX
    package's oracle-probed descent, and its minimality directly: the
    certified vector runs, and each FIFO certified above 1 deadlocks one
    lower."""
    d = _small(11)
    adv = FifoAdvisor(d, EvalConfig(backend="cuda", local_bounds=True,
                                    channel_bounds=True,
                                    certified_floor=True), device="cpu")
    res = adv.run("grouped_sa", budget=60, seed=11)
    widths = np.asarray(d.widths(), dtype=np.int64)
    rows = np.unique(res.result.configs, axis=0)
    lat, bram, dead = adv.evaluator.evaluate(rows)
    np.testing.assert_array_equal(bram, design_bram_np(rows, widths))
    for sim in (simulate, ref_simulate):
        for i, r in enumerate(rows):
            s = sim(d, r)
            assert bool(dead[i]) == s.deadlocked
            if not s.deadlocked:
                assert int(lat[i]) == s.latency
    ok = ~dead
    pts = np.stack([lat[ok], bram[ok]], axis=1)
    want = np.unique(pts[pareto_front(pts)], axis=0)
    np.testing.assert_array_equal(
        np.unique(np.asarray(res.frontier_points), axis=0), want)
    for base in (adv.baseline_max, adv.baseline_min):
        s = ref_simulate(d, base.depths)
        assert base.deadlocked == s.deadlocked
        if not s.deadlocked:
            assert base.latency == s.latency
    cert = adv.min_safe_depths()
    np.testing.assert_array_equal(cert, ref_certify_oracle(d).depths)
    assert not ref_simulate(d, cert).deadlocked
    pinned = np.flatnonzero(cert > 1)
    names = {d.fifos[f].group or d.fifos[f].name for f in pinned}
    assert "x" in names          # routed floors among them
    for f in pinned:
        lower = cert.copy()
        lower[f] -= 1
        assert ref_simulate(d, lower).deadlocked, d.fifos[f].name


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_an_undersized_expert_queue_deadlocks_when_its_block_overfills(
        seed):
    """With every other queue at its declared depth, ``x[e]`` of depth
    ``k`` deadlocks the engine exactly when some block routes more than
    ``k`` tokens to ``e`` while an earlier expert of its PE is pending:
    never for a PE's first expert, whose queue drains as it fills."""
    d = _small(seed)
    block, pes = SMALL_RUN["block"], SMALL_RUN["pes"]
    ids, _ = _moe_gate()(d.args["states"], d.args["gate"], SMALL["top_k"])
    counts = np.zeros((SMALL_RUN["n_tokens"] // block, SMALL["n_experts"]),
                      dtype=np.int64)
    for t, row in enumerate(ids.numpy()):
        counts[t // block, row] += 1
    declared = [f.depth for f in d.fifos]
    seen = set()
    for e in range(SMALL["n_experts"]):
        busiest = int(counts[:, e].max())
        for k in range(1, busiest + 2):
            depths = list(declared)
            depths[d.fifo_index(f"x[{e}]")] = k
            got = simulate(d, depths).deadlocked
            assert got == (e >= pes and busiest > k), (e, k, busiest)
            seen.add(got)
    assert seen == {True, False}
