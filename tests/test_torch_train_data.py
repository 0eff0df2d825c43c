"""The port's synthetic data pipeline against the reference, on the CPU.

* ``SyntheticLM`` batches are bit-identical to the reference's for the
  same ``(seed, step, host_slice)``, frontend ``embeds`` included, and
  ``specs_for_shape`` gives the same shapes for every arch and shape;
* the reference's own data tests, run on the port."""

import dataclasses

import numpy as np
import pytest

from repro.configs import ARCHS as REF_ARCHS
from repro.configs.base import SHAPES as REF_SHAPES
from repro.train.data import DataConfig as RefDataConfig
from repro.train.data import SyntheticLM as RefSyntheticLM
from repro.train.data import specs_for_shape as ref_specs_for_shape

from repro_torch.configs import ARCHS, SHAPES, get_arch
from repro_torch.train.data import DataConfig, SyntheticLM, specs_for_shape

ALL_ARCHS = sorted(ARCHS)


def _pair(arch=None, **kw):
    """The port's and the reference's pipeline on the same config."""
    port = DataConfig(**kw)
    ref = RefDataConfig(**dataclasses.asdict(port))
    return (SyntheticLM(port, get_arch(arch).reduced() if arch else None),
            RefSyntheticLM(ref, REF_ARCHS[arch].reduced() if arch else None))


def _same_batch(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_batches_equal_the_reference(arch):
    cfg = get_arch(arch).reduced()
    port, ref = _pair(arch, vocab=cfg.vocab, seq_len=24, global_batch=4,
                      seed=11)
    np.testing.assert_array_equal(port.succ, ref.succ)
    for step in (0, 1, 7, 1000):
        for sl in (slice(None), slice(1, 3), slice(3, 4)):
            _same_batch(port.batch(step, sl), ref.batch(step, sl))
    if cfg.frontend_tokens:
        assert "embeds" in port.batch(0)


@pytest.mark.parametrize("kw", [
    {"vocab": 100, "seq_len": 16, "global_batch": 4},
    {"vocab": 151936, "seq_len": 64, "global_batch": 2, "seed": 0},
    {"vocab": 64, "seq_len": 8, "global_batch": 3, "markov_degree": 2,
     "seed": 5}])
def test_batches_equal_the_reference_without_an_arch(kw):
    port, ref = _pair(**kw)
    for step in (0, 2, 3):
        _same_batch(port.batch(step), ref.batch(step))


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_specs_for_shape_equal_the_reference(arch):
    for full in (True, False):
        port = get_arch(arch) if full else get_arch(arch).reduced()
        ref = REF_ARCHS[arch] if full else REF_ARCHS[arch].reduced()
        for name in SHAPES:
            assert specs_for_shape(port, SHAPES[name]) == \
                ref_specs_for_shape(ref, REF_SHAPES[name]), (arch, name)


# ------------------------------------ the reference's data tests, on the port
def test_deterministic_and_stateless():
    c = DataConfig(vocab=100, seq_len=16, global_batch=4)
    d1 = SyntheticLM(c)
    d2 = SyntheticLM(c)
    b_a = d1.batch(5)
    # skip-ahead: a fresh pipeline jumping straight to step 5 matches
    for s in [0, 3]:
        d2.batch(s)
    b_b = d2.batch(5)
    np.testing.assert_array_equal(b_a["tokens"], b_b["tokens"])
    np.testing.assert_array_equal(b_a["labels"], b_b["labels"])
    # different steps differ
    assert not np.array_equal(d1.batch(6)["tokens"], b_a["tokens"])


def test_labels_are_next_tokens():
    c = DataConfig(vocab=50, seq_len=8, global_batch=2)
    b = SyntheticLM(c).batch(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_markov_structure_learnable():
    """Each token's successor comes from a fixed small set (the train CLI's
    loss falls because of it)."""
    c = DataConfig(vocab=64, seq_len=64, global_batch=8, markov_degree=2)
    d = SyntheticLM(c)
    succ = {t: set(d.succ[t]) for t in range(64)}
    b = d.batch(1)
    toks = np.concatenate([b["tokens"], b["labels"][:, -1:]], axis=1)
    for row in toks:
        for t, nxt in zip(row[:-1], row[1:]):
            assert nxt in succ[int(t)]


def test_frontend_embeds_present():
    arch = get_arch("internvl2-2b").reduced()
    c = DataConfig(vocab=arch.vocab, seq_len=16, global_batch=2)
    b = SyntheticLM(c, arch=arch).batch(0)
    assert b["embeds"].shape == (2, arch.frontend_tokens, arch.d_model)


def test_specs_for_shape_contract():
    arch = get_arch("internvl2-2b")
    s = specs_for_shape(arch, SHAPES["train_4k"])
    B, S, F = 256, 4096, arch.frontend_tokens
    assert s["tokens"] == (B, S - F)
    assert s["embeds"] == (B, F, arch.d_model)
    sd = specs_for_shape(arch, SHAPES["decode_32k"])
    assert sd["tokens"] == (128, 1)
