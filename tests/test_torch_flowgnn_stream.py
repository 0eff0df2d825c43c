"""FlowGNN's PNA engine over a stream of MolHIV-shaped molecules
(``flowgnn_pna_stream``, ``molhiv_stream``): the stream's shape, the
layer's per-node outputs against the benchmark's plain reference
(``portbench/reference/pna.py``), and the port's rows and certificate
against its discrete-event oracle and the JAX package's."""

import importlib.util
import math
import os

import numpy as np
import pytest
import torch

from repro.core.bram import design_bram_np as ref_design_bram_np
from repro.core.deadlock import certify_min_depths_oracle as ref_certify_oracle
from repro.core.oracle import simulate as ref_simulate
from repro_torch.core import EvalConfig, FifoAdvisor
from repro_torch.core.bram import design_bram_np
from repro_torch.core.oracle import simulate
from repro_torch.core.simgraph import build_simgraph
from repro_torch.core.tracer import collect_trace
from repro_torch.designs import flowgnn_pna_stream, molhiv_stream
from repro_torch.designs.ddcf import PNA_DIM, WORD_BITS
from repro_torch.designs.molecules import MEAN_ATOMS, MEAN_BONDS, VALENCE

SEEDS = (0, 7, 2 ** 31 + 12345)
#: MolHIV's scaffold test split
TEST_SPLIT = 4113
#: both sides are float64 and only their summation orders differ
RTOL = 1e-12


def _pna_reference():
    path = os.path.join(os.path.dirname(__file__), "..", "portbench",
                        "reference", "pna.py")
    spec = importlib.util.spec_from_file_location("portbench_ref_pna", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stream_design(n_molecules: int, seed: int):
    return flowgnn_pna_stream(molhiv_stream(n_molecules, seed), seed=seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_stream_is_deterministic_capped_and_sorted(seed):
    stream = molhiv_stream(64, seed)
    assert stream == molhiv_stream(64, seed)
    assert stream != molhiv_stream(64, seed + 1)
    for n, edges in stream:
        assert n >= 2
        assert edges == sorted(edges, key=lambda e: (e[1], e[0]))
        assert set(edges) == {(v, u) for u, v in edges}   # two per bond
        assert all(0 <= u < n and 0 <= v < n and u != v for u, v in edges)
        valence = np.bincount([v for _, v in edges], minlength=n)
        assert valence.max() <= VALENCE and valence.min() >= 1


def test_stream_means_match_molhiv():
    stream = molhiv_stream(TEST_SPLIT, 2026)
    atoms = sum(n for n, _ in stream) / TEST_SPLIT
    bonds = sum(len(e) // 2 for _, e in stream) / TEST_SPLIT
    assert abs(atoms / MEAN_ATOMS - 1) < 0.02, atoms
    assert abs(bonds / MEAN_BONDS - 1) < 0.02, bonds


def test_design_streams_the_molecules_through_one_engine():
    stream = molhiv_stream(5, 3)
    d = flowgnn_pna_stream(stream, seed=3)
    n = sum(m for m, _ in stream)
    edges = d.args["edges"]
    assert d.args["x"].shape == (n, PNA_DIM) == (len(d.args["deg"]), PNA_DIM)
    assert edges == sorted(edges, key=lambda e: (e[1], e[0]))
    assert len(edges) == sum(len(e) for _, e in stream)
    base = 0
    for m, es in stream:                      # ids offset molecule by molecule
        assert {(u + base, v + base) for u, v in es} <= set(edges)
        base += m
    node_qs = ["feat_q", "skip_q"] + [f"deg_{a}" for a in
                                      ("mean", "max", "min", "std")]
    largest = max(m for m, _ in stream)
    assert [d.fifos[d.fifo_index(q)].depth for q in node_qs] == \
        [largest] * len(node_qs)
    assert d.n_fifos == 28
    # an item is as wide as what it carries, in 32-bit words
    emb = PNA_DIM * WORD_BITS
    want = {"edges_q": 2 * WORD_BITS, "feat_q": emb, "skip_q": emb + WORD_BITS,
            "out_q": emb}
    for f in d.fifos:
        kind = f.name.split("_")[0]
        width = want.get(f.name, {"deg": WORD_BITS, "msg": emb,
                                  "agg": emb}.get(kind))
        assert f.width == width, f.name
    assert math.isclose(d.args["delta"], sum(
        math.log(k + 1) for k in d.args["deg"]) / n, rel_tol=1e-15)


@pytest.mark.parametrize("seed", SEEDS)
def test_outputs_equal_the_plain_reference(seed):
    pna = _pna_reference()
    d = _stream_design(3, seed)
    a = d.args
    want = pna.pna_layer(len(a["x"]), a["edges"], a["x"], a["weights"])
    scale = float(want.abs().max())
    assert want.shape == (len(a["x"]), PNA_DIM)
    traced = torch.from_numpy(np.stack(collect_trace(d).results["out"]))
    simulated = torch.from_numpy(np.stack(
        simulate(d, [f.depth for f in d.fifos]).results["out"]))
    for got in (traced, simulated):
        assert float((got - want).abs().max()) <= RTOL * scale
    # the reference one precision lower misses by far more than RTOL
    f32 = pna.pna_layer(len(a["x"]), a["edges"], a["x"], a["weights"],
                        dtype=torch.float32).double()
    assert float((traced - f32).abs().max()) > 1e3 * RTOL * scale


def test_rows_and_certificate_equal_the_oracle():
    """The 16 rows against the port's oracle and the JAX package's, the
    certificate against the JAX package's oracle-probed descent, and its
    minimality directly: the certified vector runs, and each FIFO
    certified above 1 deadlocks one lower."""
    d = _stream_design(4, 11)
    adv = FifoAdvisor(d, EvalConfig(backend="cuda", local_bounds=True,
                                    channel_bounds=True,
                                    certified_floor=True), device="cpu")
    cert = adv.min_safe_depths()
    rng = np.random.default_rng(11)
    declared = np.array([f.depth for f in d.fifos], dtype=np.int64)
    rows = np.stack([rng.integers(1, declared + 1) for _ in range(16)])
    rows[:4] = np.maximum(rows[:4], cert)  # some feasible
    lat, bram, dead = adv.evaluator.evaluate(rows)
    widths = np.asarray(d.widths(), dtype=np.int64)
    for sim in (simulate, ref_simulate):
        sims = [sim(d, r) for r in rows]
        assert [bool(x) for x in dead] == [s.deadlocked for s in sims]
        for i, s in enumerate(sims):
            if not s.deadlocked:
                assert int(lat[i]) == s.latency
    assert not dead[:4].any() and dead.any()
    np.testing.assert_array_equal(bram, design_bram_np(rows, widths))
    np.testing.assert_array_equal(bram, ref_design_bram_np(rows, widths))
    np.testing.assert_array_equal(cert, ref_certify_oracle(d).depths)
    assert not ref_simulate(d, cert).deadlocked
    pinned = np.flatnonzero(cert > 1)
    assert len(pinned)
    for f in pinned:
        lower = cert.copy()
        lower[f] -= 1
        assert ref_simulate(d, lower).deadlocked, d.fifos[f].name


def test_baseline_max_never_deadlocks():
    """Baseline-Max is the declared depths: every FIFO declares one."""
    for seed in range(50):
        d = _stream_design(32, 1000 + seed)
        u = np.maximum([f.depth for f in d.fifos], 2)
        if seed == 0:
            np.testing.assert_array_equal(
                u, build_simgraph(d, collect_trace(d)).upper_bounds)
        assert not simulate(d, u).deadlocked, seed
