"""Placing a model over several devices: the port's sharding against the
reference's, and sharded runs against one-device runs, on the CPU.

* ``params.specs`` of every arch at full width equals the reference's
  ``PartitionSpec`` tree on ("data", "model") and ("pod", "data",
  "model") meshes (``spec`` reads only the axis names, so one-device
  meshes serve both packages);
* ``ShardingCtx.placements``: ``Shard(d)`` where dim ``d`` names a mesh
  axis, the runs of axes the rules name together merged into one
  ``DeviceMesh`` dim;
* meta DTensors (``shape_structs``) and ``place`` cut rank ``r``'s shard
  as DTensor does, the first ranks taking the ceiling of an uneven
  split, with no communication (checked rank by rank on fake groups);
* on a 2 x 2 CPU mesh with real collectives (4 gloo processes running
  ``tests/_torch_sharded_worker.py``), one arch of each family (dense
  GQA qwen2-1.5b, MoE qwen3-moe-30b-a3b, MLA + MoE deepseek-v2-236b, SSM
  mamba2-1.3b, hybrid hymba-1.5b, frontend internvl2-2b), reduced, at
  float32: the prefill's last logits within 1e-5 of their max, the
  decode step's tokens equal and its cache within 1e-5 of max, and one
  ``make_train_step`` step's loss and ``grad_norm`` within rtol 1e-5,
  both AdamW moments within 1e-4 of each leaf's max, and the updated
  parameters within 1e-4 of max where the first moment is above 1e-3 of
  its max or zero (Adam's first step is close to ``sign(g)``, so an
  element whose gradient is float32 noise may move by up to ``2 lr``
  differently), all against the same run on one device (the MoE arch
  also on a 2 x 1 x 2 ("pod", "data", "model") mesh); and a
  checkpoint written by the reference restores onto those shards
  (``restore(shardings=)``) whose ``full_tensor()`` equals every leaf
  bit for bit.

No test leaves a process group up: the fake groups are taken down by
``fake_world``, and the gloo ranks are processes of their own.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from repro.configs import ARCHS as REF_ARCHS
from repro.models import params as ref_pm
from repro.models.sharding import DEFAULT_RULES as REF_RULES
from repro.models.sharding import ShardingCtx as RefShardingCtx
from repro.models.transformer import model_specs as ref_model_specs
from repro.train import checkpoint as ref_ck

from repro_torch.configs import ARCHS, get_arch
from repro_torch.launch.dryrun import fake_world
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models import params as pm
from repro_torch.models.sharding import DEFAULT_RULES, ShardingCtx, use_ctx
from repro_torch.models.transformer import model_specs

CPU = torch.device("cpu")
AXES = (("data", "model"), ("pod", "data", "model"))
FAMILIES = ("qwen2-1.5b", "qwen3-moe-30b-a3b", "deepseek-v2-236b",
            "mamba2-1.3b", "hymba-1.5b", "internvl2-2b",
            # a ("pod", "data", "model") mesh, whose pod and data axes
            # form one DeviceMesh dim
            "qwen3-moe-30b-a3b@2x1x2")
WORKER = os.path.join(os.path.dirname(__file__), "_torch_sharded_worker.py")


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    else:
        yield path, tree


def _ctxs(axes):
    jmesh = jax.make_mesh((1,) * len(axes), axes, devices=jax.devices()[:1])
    tmesh = Mesh(axes, (1,) * len(axes), (CPU,))
    return (ShardingCtx(tmesh, dict(DEFAULT_RULES)),
            RefShardingCtx(jmesh, dict(REF_RULES)))


# ---------------------------------------------------------------- specs
@pytest.mark.parametrize("axes", AXES, ids=lambda a: "x".join(a))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_equal_the_reference_at_full_width(arch, axes):
    port, ref = _ctxs(axes)
    got = dict(_walk(pm.specs(model_specs(get_arch(arch)), port)))
    want = {p: tuple(s) for p, s in _walk(
        ref_pm.specs(ref_model_specs(REF_ARCHS[arch]), ref))}
    assert got == want
    assert DEFAULT_RULES == REF_RULES


def test_placements_follow_the_spec_and_merge_co_named_axes():
    from torch.distributed.tensor import Replicate, Shard
    ctx = ShardingCtx(Mesh(("data", "model"), (2, 2), (CPU,) * 4),
                      dict(DEFAULT_RULES))
    assert ctx.groups() == (("data",), ("model",))
    assert ctx.placements(("batch", "seq", "embed")) == (Shard(0),
                                                         Replicate())
    assert ctx.placements(("embed", "mlp")) == (Shard(0), Shard(1))
    assert ctx.placements(("layers", None)) == (Replicate(), Replicate())
    ctx3 = ShardingCtx(Mesh(("pod", "data", "model"), (2, 2, 2), (CPU,) * 8),
                       dict(DEFAULT_RULES))
    assert ctx3.groups() == (("pod", "data"), ("model",))
    assert ctx3.placements(("vocab", "embed")) == (Shard(1), Shard(0))
    # long_500k's rules spread the context over every axis: the runs stay
    long = dict(DEFAULT_RULES, batch=None, kv_seq=("pod", "data", "model"))
    ctx_l = ShardingCtx(ctx3.mesh, long)
    assert ctx_l.groups() == (("pod", "data"), ("model",))
    assert ctx_l.placements(("batch", "kv_seq", "kv_heads", None)) == (
        Shard(1), Shard(1))
    # a rule naming one axis of a run splits the run
    ctx_d = ShardingCtx(ctx3.mesh, dict(DEFAULT_RULES, batch="data"))
    assert ctx_d.groups() == (("pod",), ("data",), ("model",))
    with pytest.raises(ValueError, match="order"):
        ShardingCtx(ctx3.mesh, dict(DEFAULT_RULES, batch=("data", "pod"))
                    ).placements(("batch",))


def test_shards_cut_as_dtensor_does_without_communication():
    """Rank by rank on fake groups (whose collectives move nothing), the
    meta shard shapes and ``place`` d pieces tile each tensor, the first
    ranks taking the ceiling of an uneven split."""
    rng = np.random.default_rng(0)
    full = torch.from_numpy(rng.standard_normal((10, 6)).astype(np.float32))
    mesh = Mesh(("data", "model"), (2, 2), (CPU,) * 4)
    rows, cols = [0, 5, 10], [0, 3, 6]
    for rank in range(4):
        with fake_world(4, rank=rank), use_ctx(mesh) as ctx:
            sh = ctx.sharding(("embed", "mlp"))
            meta = pm.meta((10, 6), torch.float32, ("embed", "mlp"), ctx)
            placed = pm.place({"w": full}, {"w": sh})["w"]
            i, j = divmod(rank, 2)
            want = full[rows[i]:rows[i + 1], cols[j]:cols[j + 1]]
            assert meta.shape == full.shape and meta.is_meta
            assert meta.to_local().shape == want.shape
            assert torch.equal(placed.to_local(), want)
            odd = pm.meta((5, 3), torch.float32, ("embed", "mlp"), ctx)
            assert odd.to_local().shape == ((3, 2), (3, 1),
                                            (2, 2), (2, 1))[rank]
    assert not torch.distributed.is_initialized()


def test_model_trees_place_on_a_fake_mesh_rank_by_rank():
    cfg = get_arch("deepseek-v2-236b").reduced()
    specs = model_specs(cfg)
    params = pm.materialize(specs, torch.Generator().manual_seed(0))
    mesh = Mesh(("data", "model"), (2, 2), (CPU,) * 4)
    for rank in range(4):
        with fake_world(4, rank=rank), use_ctx(mesh) as ctx:
            shs = pm.shardings(specs, ctx)
            placed = pm.place(params, shs)
            structs = pm.shape_structs(specs, ctx)
            for p, s, t, sh in zip(*map(pm.tree_leaves,
                                        (placed, structs, params, shs))):
                assert p.shape == s.shape == t.shape
                assert p.placements == s.placements == sh.placements
                assert torch.equal(p.to_local(), pm.local_shard(t, sh))
                assert s.to_local().shape == p.to_local().shape


# ------------------------------------------------- sharded = one device
@pytest.fixture(scope="module")
def gloo_results(tmp_path_factory):
    """The 4 gloo ranks' comparisons (and a reference checkpoint's
    sharded restore), run once for the module."""
    tmp = tmp_path_factory.mktemp("gloo")
    cfg = REF_ARCHS["qwen2-1.5b"].reduced()
    ref_params = ref_pm.materialize(ref_model_specs(cfg),
                                    jax.random.PRNGKey(3))
    ref_ck.save(str(tmp / "ckpt"), 5, {"params": ref_params})
    out = tmp / "out.json"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.join(os.path.dirname(WORKER), "..", "src"),
         os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), "4", str(tmp / "store"), str(out),
         str(tmp / "ckpt"), *FAMILIES],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(4)]
    logs = []
    for p in procs:
        try:
            logs.append(p.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    assert all(p.returncode == 0 for p in procs), logs[0][-4000:]
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_prefill_and_decode_equal_one_device(gloo_results, arch):
    r = gloo_results[arch]
    assert r["prefill_last"] <= 1e-5, r
    assert r["decode_tok_equal"], r
    assert r["cache"] <= 1e-5, r


@pytest.mark.parametrize("arch", FAMILIES)
def test_sharded_train_step_equals_one_device(gloo_results, arch):
    r = gloo_results[arch]
    assert r["loss_rel"] <= 1e-5 and r["grad_norm_rel"] <= 1e-5, r
    assert r["m"] <= 1e-4 and r["v"] <= 1e-4, r
    assert r["params"] <= 1e-4, r


def test_reference_checkpoint_restores_onto_shards_bit_for_bit(
        gloo_results):
    r = gloo_results["restore"]
    n = len(pm.tree_leaves(model_specs(get_arch("qwen2-1.5b").reduced())))
    assert r["leaves"] == n and r["sharded"] > 0, r
    assert r["equal"], r


def test_one_device_context_places_nothing():
    """Under a one-device mesh every tree stays plain tensors."""
    specs = model_specs(get_arch("qwen2-1.5b").reduced())
    with use_ctx(make_production_mesh(shape=(1, 1), device="cpu")) as ctx:
        for t in pm.tree_leaves(pm.shape_structs(specs, ctx)):
            assert type(t) is torch.Tensor and t.is_meta
