"""The port's checkpoints: the reference's own checkpoint tests, run on the
port, and the on-disk format against the reference's, on the CPU.

* round trip, pruning, a half-written checkpoint staying invisible, a
  missing leaf raising ``KeyError``, the async saver;
* the same tree saved by both packages gives the same manifest (keys as
  ``jax.tree_util.keystr`` spells them, files, shapes, dtypes) and the
  same ``.npy`` bytes;
* a training state saved by either package restores in the other, leaf
  for leaf equal;
* ``AsyncCheckpointer.save`` copies every leaf before it returns, so an
  in-place update right after it does not reach the checkpoint.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ARCHS as REF_ARCHS
from repro.train import checkpoint as ref_ck
from repro.train.steps import init_train_state as ref_init_train_state

from repro_torch.configs import get_arch
from repro_torch.core.carry import train_state_from_arrays
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import params as pm
from repro_torch.models.sharding import use_ctx
from repro_torch.models.transformer import model_specs
from repro_torch.train import checkpoint as ck
from repro_torch.train.steps import init_train_state


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((4, 8), generator=g),
                       "b": torch.zeros((8,))},
            "opt": {"m": {"w": torch.ones((4, 8)) * 2, "b": torch.ones((8,))},
                    "step": torch.tensor(7, dtype=torch.int32)}}


def _zeros_like(tree):
    return pm.tree_map(torch.zeros_like, tree)


def _same_leaves(a, b):
    la, lb = pm.tree_leaves(a), pm.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


# --------------------------------- the reference's own tests, on the port
def test_round_trip(tmp_path):
    t = _tree()
    ck.save(str(tmp_path), 3, t)
    assert ck.latest_step(str(tmp_path)) == 3
    r = ck.restore(str(tmp_path), 3, _zeros_like(t))
    _same_leaves(t, r)
    assert all(x.device.type == "cpu" for x in pm.tree_leaves(r))


def test_prune_keeps_latest(tmp_path):
    t = _tree()
    for s in [1, 2, 3, 4, 5]:
        ck.save(str(tmp_path), s, t, keep=2)
    assert ck.all_steps(str(tmp_path)) == [4, 5]


def test_half_written_checkpoint_is_invisible(tmp_path):
    t = _tree()
    ck.save(str(tmp_path), 1, t)
    # simulate a preempted save: tmp dir exists, no manifest committed
    crash = tmp_path / "step_00000002.tmp"
    crash.mkdir()
    (crash / "leaf_00000.npy").write_bytes(b"garbage")
    assert ck.latest_step(str(tmp_path)) == 1
    # and a directory without manifest is ignored too
    bad = tmp_path / "step_00000003"
    bad.mkdir()
    assert ck.latest_step(str(tmp_path)) == 1
    assert ck.all_steps(str(tmp_path / "nowhere")) == []
    assert ck.latest_step(str(tmp_path / "nowhere")) is None


def test_restore_missing_leaf_raises(tmp_path):
    t = _tree()
    ck.save(str(tmp_path), 1, t)
    target = dict(t)
    target["extra"] = torch.zeros((2,))
    with pytest.raises(KeyError, match=r"\['extra'\]"):
        ck.restore(str(tmp_path), 1, target)


def test_async_checkpointer(tmp_path):
    t = _tree()
    saver = ck.AsyncCheckpointer(str(tmp_path), keep=2)
    for s in [10, 20]:
        saver.save(s, t)
    saver.wait()
    assert ck.all_steps(str(tmp_path)) == [10, 20]


# -------------------------------------------------- the port's own rules
def test_async_save_copies_before_it_returns(tmp_path):
    t = _tree()
    want = pm.tree_map(lambda x: x.clone(), t)
    saver = ck.AsyncCheckpointer(str(tmp_path))
    saver.save(1, t)
    for x in pm.tree_leaves(t):      # an in-place optimizer step
        x.add_(1)
    saver.wait()
    _same_leaves(ck.restore(str(tmp_path), 1, _zeros_like(t)), want)


def test_async_errors_surface_on_wait(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    saver = ck.AsyncCheckpointer(str(blocker))
    saver.save(1, _tree())
    with pytest.raises(OSError):
        saver.wait()
    saver.wait()                     # the error is raised once


def test_save_is_idempotent_and_restore_places_leaves(tmp_path):
    t = _tree()
    first = ck.save(str(tmp_path), 2, t)
    assert ck.save(str(tmp_path), 2, _zeros_like(t)) == first
    r = ck.restore(str(tmp_path), 2, _zeros_like(t), device="cpu")
    _same_leaves(r, t)
    # onto a sharded layout: rank 1 of 2 keeps the second half of the
    # rows (a fake group's ranks run one at a time in this process)
    mesh = Mesh(("data", "model"), (2, 1), (torch.device("cpu"),) * 2)
    with fake_world(2, rank=1), use_ctx(mesh) as ctx:
        shs = {"params": {"w": ctx.sharding(("embed", None)),
                          "b": ctx.sharding((None,))},
               "opt": {"m": {"w": ctx.sharding((None, "embed")),
                             "b": ctx.sharding(("embed",))},
                       "step": ctx.sharding(())}}
        r = ck.restore(str(tmp_path), 2, t, shardings=shs)
        assert torch.equal(r["params"]["w"].to_local(), t["params"]["w"][2:])
        assert torch.equal(r["opt"]["m"]["w"].to_local(),
                           t["opt"]["m"]["w"][:, 4:])
        assert torch.equal(r["opt"]["m"]["b"].to_local(),
                           t["opt"]["m"]["b"][4:])
        assert torch.equal(r["params"]["b"].to_local(), t["params"]["b"])
        assert r["opt"]["step"].to_local().item() == 7
        assert r["params"]["w"].shape == t["params"]["w"].shape


def test_bfloat16_leaves_round_trip(tmp_path):
    t = {"w": torch.randn((3, 5)).to(torch.bfloat16),
         "s": torch.tensor(1.5)}
    ck.save(str(tmp_path), 1, t)
    with open(tmp_path / "step_00000001" / "manifest.json") as f:
        dtypes = [leaf["dtype"] for leaf in json.load(f)["leaves"]]
    assert dtypes == ["float32", "bfloat16"]
    r = ck.restore(str(tmp_path), 1, _zeros_like(t))
    assert r["w"].dtype == torch.bfloat16
    assert torch.equal(r["w"], t["w"]) and torch.equal(r["s"], t["s"])


# --------------------------------------------------- against the reference
def test_same_format_as_the_reference(tmp_path):
    t = _tree()
    ck.save(str(tmp_path / "port"), 4, t)
    ref_t = jax.tree.map(lambda x: jnp.asarray(x.numpy()), t)
    ref_ck.save(str(tmp_path / "ref"), 4, ref_t)
    d_port = tmp_path / "port" / "step_00000004"
    d_ref = tmp_path / "ref" / "step_00000004"
    with open(d_port / "manifest.json") as f:
        port = json.load(f)
    with open(d_ref / "manifest.json") as f:
        ref = json.load(f)
    assert port == ref
    keys = [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(ref_t)[0]]
    assert [leaf["key"] for leaf in port["leaves"]] == keys
    assert keys[0] == "['opt']['m']['b']"
    assert sorted(os.listdir(d_port)) == sorted(os.listdir(d_ref))
    for name in os.listdir(d_ref):
        assert (d_port / name).read_bytes() == (d_ref / name).read_bytes()


@pytest.fixture(scope="module")
def states():
    """A reduced qwen2-1.5b training state in both packages, from the
    reference's weights (step 5, nonzero moments)."""
    arch = "qwen2-1.5b"
    rcfg = REF_ARCHS[arch].reduced()
    params, opt = ref_init_train_state(rcfg, jax.random.PRNGKey(1))
    opt = {"m": jax.tree.map(lambda p: p * 0.5, params),
           "v": jax.tree.map(lambda p: p * p, params),
           "step": jnp.int32(5)}
    ref_state = {"params": params, "opt": opt}
    np_state = jax.tree.map(np.asarray, ref_state)
    port_params, port_opt = train_state_from_arrays(
        get_arch(arch).reduced(), np_state["params"], np_state["opt"], "cpu")
    return ref_state, {"params": port_params, "opt": port_opt}


def test_port_checkpoint_restores_in_the_reference(tmp_path, states):
    ref_state, port_state = states
    ck.save(str(tmp_path), 5, port_state)
    assert ref_ck.latest_step(str(tmp_path)) == 5
    target = jax.tree.map(jnp.zeros_like, ref_state)
    got = ref_ck.restore(str(tmp_path), 5, target)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref_state)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_reference_checkpoint_restores_in_the_port(tmp_path, states):
    ref_state, port_state = states
    ref_ck.save(str(tmp_path), 5, ref_state)
    assert ck.latest_step(str(tmp_path)) == 5
    got = ck.restore(str(tmp_path), 5, _zeros_like(port_state))
    _same_leaves(got, port_state)
    assert got["opt"]["step"].dtype == torch.int32
    assert int(got["opt"]["step"]) == 5


def test_fresh_port_state_round_trips(tmp_path):
    cfg = get_arch("mamba2-1.3b").reduced()
    params, opt = init_train_state(cfg, torch.Generator().manual_seed(0))
    state = {"params": params, "opt": opt}
    saver = ck.AsyncCheckpointer(str(tmp_path))
    saver.save(3, state)
    saver.wait()
    _same_leaves(ck.restore(str(tmp_path), 3, _zeros_like(state)), state)


def test_reference_checkpoint_restores_onto_every_rank_s_shard(tmp_path,
                                                               states):
    """The reference's training state, saved by the reference and
    restored onto a 2 x 2 mesh rank by rank (fake groups, nothing
    sent): each rank's shards tile every leaf bit for bit."""
    ref_state, port_state = states
    ref_ck.save(str(tmp_path), 5, ref_state)
    specs = model_specs(get_arch("qwen2-1.5b").reduced())
    mesh = make_production_mesh(shape=(2, 2), device="cpu")
    pieces = {}
    for rank in range(4):
        with fake_world(4, rank=rank), use_ctx(mesh) as ctx:
            p_sh = pm.shardings(specs, ctx)
            shs = {"params": p_sh, "opt": {"m": p_sh, "v": p_sh,
                                           "step": ctx.sharding(())}}
            got = ck.restore(str(tmp_path), 5, port_state, shardings=shs)
            for (path, leaf), sh in zip(_paths(got), pm.tree_leaves(shs)):
                assert leaf.placements == sh.placements
                pieces.setdefault(path, []).append(
                    (pm.shard_bounds(leaf.shape, sh), leaf.to_local()))
    n_sharded = 0
    for path, want in _paths(port_state):
        out = torch.zeros_like(want)
        for bounds, local in pieces[path]:
            out[tuple(slice(a, b) for a, b in bounds)] = local
        n_sharded += pieces[path][0][1].numel() < want.numel()
        assert out.dtype == want.dtype and torch.equal(out, want), path
    assert n_sharded > 10


def _paths(tree, path=()):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k], path + (k,))]
    return [(path, tree)]
