"""The port's AdamW and learning-rate schedules against the reference, on
the CPU.

* ``schedule_lr`` for every schedule at steps 0, 1, the end of warmup,
  mid-run, the start and middle of WSD's decay, the end and beyond;
* ``init_opt_state``, ``_global_norm`` and ``adamw_update`` on the same
  trees and gradients (seeded numpy), over 1 and 3 steps, with the clip
  active and not: parameters, both moments, the step, ``grad_norm`` and
  ``lr`` within ``rtol=1e-6`` (``atol=1e-6*max|ref|``);
* ``adamw_update`` updates in place and returns the trees it was given.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.train.optimizer import OptConfig as RefOptConfig
from repro.train.optimizer import _global_norm as ref_global_norm
from repro.train.optimizer import adamw_update as ref_adamw_update
from repro.train.optimizer import init_opt_state as ref_init_opt_state
from repro.train.optimizer import schedule_lr as ref_schedule_lr

from repro_torch.models import params as pm
from repro_torch.train.optimizer import (OptConfig, _global_norm,
                                         adamw_update, init_opt_state,
                                         schedule_lr)

RTOL = 1e-6
SCHEDULE_CFGS = [
    OptConfig(schedule="cosine"),
    OptConfig(schedule="wsd", lr=1e-3, warmup_steps=10, total_steps=100),
    OptConfig(schedule="const", warmup_steps=5),
    OptConfig(schedule="cosine", warmup_steps=0, total_steps=1,
              min_lr_frac=0.0),
    OptConfig(schedule="wsd", warmup_steps=100, total_steps=10_000,
              wsd_decay_frac=0.25, min_lr_frac=0.05),
]


def _ref_cfg(cfg: OptConfig) -> RefOptConfig:
    return RefOptConfig(**dataclasses.asdict(cfg))


def _close(got, want, tol=RTOL, what=""):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


def _steps(cfg: OptConfig):
    """0, 1, the end of warmup, mid-run, the start and middle of WSD's
    decay window, the last step and beyond it."""
    total, warm = cfg.total_steps, cfg.warmup_steps
    decay = total - int(total * cfg.wsd_decay_frac)
    return sorted({0, 1, max(warm - 1, 0), warm, warm + 1, total // 2,
                   decay, decay + 1, (decay + total) // 2, total - 1,
                   total, total + 7})


@pytest.mark.parametrize("cfg", SCHEDULE_CFGS,
                         ids=lambda c: f"{c.schedule}-{c.total_steps}")
def test_schedules_equal_the_reference(cfg):
    steps = _steps(cfg)
    got = [schedule_lr(cfg, torch.tensor(s, dtype=torch.int32))
           for s in steps]
    want = [ref_schedule_lr(_ref_cfg(cfg), jnp.int32(s)) for s in steps]
    for s, g, w in zip(steps, got, want):
        assert g.dtype == torch.float32 and g.shape == ()
        _close(g.numpy(), np.asarray(w), what=f"step {s}")


def _trees(seed, grad_scale):
    """(params, [grads of 3 steps]) as numpy: matrices, a stacked 3-D
    leaf and vectors (which get no weight decay)."""
    rng = np.random.default_rng(seed)
    shapes = {"embed": {"tok": (32, 8)}, "final_norm": {"w": (8,)},
              "layers": {"wq": (2, 8, 12), "b": (2, 12),
                         "ln": {"w": (2, 8)}}}

    def draw(s):
        return rng.standard_normal(s).astype(np.float32)
    params = pm.tree_map(draw, shapes)
    grads = [pm.tree_map(lambda s: draw(s) * grad_scale, shapes)
             for _ in range(3)]
    return params, grads


def _torch(tree):
    return pm.tree_map(lambda a: torch.tensor(a), tree)


def _jax(tree):
    return pm.tree_map(jnp.asarray, tree)


def _close_trees(got, want, what):
    g, w = pm.tree_leaves(got), jax.tree.leaves(want)
    assert len(g) == len(w)
    for i, (a, b) in enumerate(zip(g, w)):
        _close(a.numpy(), np.asarray(b), what=f"{what} leaf {i}")


@pytest.mark.parametrize("grad_scale", [0.01, 10.0], ids=["no_clip", "clip"])
@pytest.mark.parametrize("cfg", [
    OptConfig(warmup_steps=2, total_steps=5),
    OptConfig(schedule="wsd", lr=1e-2, warmup_steps=1, total_steps=3,
              wsd_decay_frac=0.5, weight_decay=0.5),
    OptConfig(schedule="const", clip_norm=0.3, eps=1e-6)],
    ids=["cosine", "wsd", "const"])
def test_adamw_equals_the_reference_over_three_steps(cfg, grad_scale):
    params_np, grads_np = _trees(3, grad_scale)
    params = _torch(params_np)
    state = init_opt_state(params)
    ref_params = _jax(params_np)
    ref_state = ref_init_opt_state(ref_params)
    _close_trees(state["m"], ref_state["m"], "m0")
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 0
    for k, g_np in enumerate(grads_np):
        grads = _torch(g_np)
        _close(_global_norm(grads).numpy(),
               np.asarray(ref_global_norm(_jax(g_np))), what="norm")
        params, state, met = adamw_update(cfg, grads, state, params)
        ref_params, ref_state, ref_met = ref_adamw_update(
            _ref_cfg(cfg), _jax(g_np), ref_state, ref_params)
        what = f"step {k + 1}"
        assert int(state["step"]) == int(ref_state["step"]) == k + 1
        for key in ("grad_norm", "lr"):
            _close(met[key].numpy(), np.asarray(ref_met[key]),
                   what=f"{what} {key}")
        _close_trees(state["m"], ref_state["m"], f"{what} m")
        _close_trees(state["v"], ref_state["v"], f"{what} v")
        _close_trees(params, ref_params, f"{what} params")
    if grad_scale > 1:
        assert float(met["grad_norm"]) > cfg.clip_norm


def test_adamw_updates_in_place_and_returns_the_same_trees():
    params_np, grads_np = _trees(4, 0.1)
    params = _torch(params_np)
    state = init_opt_state(params)
    leaves = pm.tree_leaves(params) + pm.tree_leaves(state["m"]) + \
        pm.tree_leaves(state["v"])
    ptrs = [t.data_ptr() for t in leaves]
    new_params, new_state, _ = adamw_update(OptConfig(), _torch(grads_np[0]),
                                            state, params)
    assert new_params is params
    assert new_state["m"] is state["m"] and new_state["v"] is state["v"]
    after = pm.tree_leaves(new_params) + pm.tree_leaves(new_state["m"]) + \
        pm.tree_leaves(new_state["v"])
    assert [t.data_ptr() for t in after] == ptrs
    assert not np.array_equal(new_params["embed"]["tok"].numpy(),
                              params_np["embed"]["tok"])
    # a 1-D leaf is not decayed: from zero moments and a zero gradient it
    # stays as it is, while a matrix shrinks (a stacked (L, d) norm has
    # two dimensions and is decayed, as in the reference)
    zero = pm.tree_map(torch.zeros_like, new_params)
    before = pm.tree_map(lambda t: t.clone(), new_params)
    adamw_update(OptConfig(weight_decay=0.5), zero,
                 init_opt_state(new_params), new_params)
    assert torch.equal(new_params["final_norm"]["w"],
                       before["final_norm"]["w"])
    mat = new_params["embed"]["tok"]
    assert float(mat.abs().sum()) < float(before["embed"]["tok"].abs().sum())


def test_adamw_rejects_trees_that_do_not_match():
    params = _torch(_trees(5, 1.0)[0])
    state = init_opt_state(params)
    grads = pm.tree_map(torch.zeros_like, params)
    del grads["layers"]["b"]
    with pytest.raises(ValueError, match="gradients"):
        adamw_update(OptConfig(), grads, state, params)


def test_bfloat16_parameters_keep_their_dtype():
    """bf16 parameters, float32 moments: the update rounds to bf16 as the
    reference's ``astype(p.dtype)`` does (compared to one bf16 ulp)."""
    params_np, grads_np = _trees(6, 0.1)
    params = pm.tree_map(lambda a: torch.tensor(a).to(torch.bfloat16),
                         params_np)
    state = init_opt_state(params)
    assert all(t.dtype == torch.float32 for t in pm.tree_leaves(state["m"]))
    ref_params = pm.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                             params_np)
    ref_state = ref_init_opt_state(ref_params)
    for g in grads_np:
        params, state, _ = adamw_update(OptConfig(), _torch(g), state,
                                        params)
        ref_params, ref_state, _ = ref_adamw_update(
            RefOptConfig(), _jax(g), ref_state, ref_params)
    for a, b in zip(pm.tree_leaves(params), jax.tree.leaves(ref_params)):
        assert a.dtype == torch.bfloat16
        _close(a.float().numpy(), np.asarray(b, np.float32), tol=2 ** -8)
    _close_trees(state["v"], ref_state["v"], "v")
