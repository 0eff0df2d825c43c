"""Parity of the port's seeded design generator: the same seed gives the
reference package's spec, design, trace and every SimGraph array
(exact equality — these are integers and JSON), and shrinking walks the
same reductions."""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest

from repro.core.simgraph import build_simgraph as ref_build_simgraph
from repro.designs import generate as ref_gen

from repro_torch.core.simgraph import SimGraph, build_simgraph
from repro_torch.designs import generate as gen

CORPUS = sorted(glob.glob(os.path.join(os.path.dirname(__file__),
                                       "fuzz_corpus", "*.json")))
SEEDS = [0, 1, 2, 5, 8, 13, 29, 57]


def _assert_graphs_equal(port_g, ref_g):
    for f in dataclasses.fields(SimGraph):
        if f.name == "design":
            continue
        x, y = getattr(port_g, f.name), getattr(ref_g, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == np.asarray(y).dtype, f.name
            np.testing.assert_array_equal(x, y, err_msg=f.name)
        else:
            assert x == y, f.name


def _assert_built_equal(port_gd, ref_gd):
    assert port_gd.spec.to_json() == ref_gd.spec.to_json()
    assert port_gd.expected == ref_gd.expected
    pd, rd = port_gd.design, ref_gd.design
    assert pd.name == rd.name
    assert [(f.name, f.index, f.width, f.group, f.depth)
            for f in pd.fifos] == \
        [(f.name, f.index, f.width, f.group, f.depth) for f in rd.fifos]
    assert [(t.name, t.data_dependent) for t in pd.tasks] == \
        [(t.name, t.data_dependent) for t in rd.tasks]
    _assert_graphs_equal(build_simgraph(pd), ref_build_simgraph(rd))


@pytest.mark.parametrize("quick", [True, False])
@pytest.mark.parametrize("seed", SEEDS)
def test_seeded_designs_equal_reference(seed, quick):
    spec = gen.spec_from_seed(seed, quick=quick)
    ref_spec = ref_gen.spec_from_seed(seed, quick=quick)
    assert json.dumps(spec.to_json(), sort_keys=True) == \
        json.dumps(ref_spec.to_json(), sort_keys=True)
    _assert_built_equal(gen.generate_design(seed, quick=quick),
                        ref_gen.generate_design(seed, quick=quick))


@pytest.mark.parametrize("path", CORPUS, ids=os.path.basename)
def test_corpus_specs_equal_reference(path):
    (spec,) = gen.load_corpus_specs([path])
    (ref_spec,) = ref_gen.load_corpus_specs([path])
    assert spec.to_json() == ref_spec.to_json()
    _assert_built_equal(gen.build_design(spec),
                        ref_gen.build_design(ref_spec))
    assert gen.corpus_entry(spec, "note", {"k": 1}) == \
        ref_gen.corpus_entry(ref_spec, "note", {"k": 1})


def test_corpus_covers_three_specs():
    assert len(CORPUS) == 3


def test_load_corpus_rejects_what_the_reference_rejects(tmp_path):
    bad = tmp_path / "report.json"
    bad.write_text(json.dumps([1, 2]))
    with pytest.raises(ValueError) as port_err:
        gen.load_corpus_specs([str(bad)])
    with pytest.raises(ValueError) as ref_err:
        ref_gen.load_corpus_specs([str(bad)])
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("seed", [3, 11, 40])
def test_shrink_walks_the_reference_reductions(seed):
    """A predicate that holds while the spec keeps a stage and some
    tokens: both packages try the same candidates in the same order and
    stop at the same minimal spec."""
    def predicate(seen):
        def still_fails(spec):
            seen.append(json.dumps(spec.to_json(), sort_keys=True))
            return len(spec.stages) >= 1 and spec.n >= 4
        return still_fails

    port_seen, ref_seen = [], []
    got = gen.shrink_spec(gen.spec_from_seed(seed), predicate(port_seen))
    want = ref_gen.shrink_spec(ref_gen.spec_from_seed(seed),
                               predicate(ref_seen))
    assert got.to_json() == want.to_json()
    assert port_seen == ref_seen
    assert len(port_seen) > 1
