"""The port's training steps against the reference, on the CPU.

For every reduced arch, with the reference's weights carried across
(``lm_params_from_arrays``) and the same ``SyntheticLM`` batch:

* ``loss_fn`` at float32: the loss within ``rtol=1e-5``, ``aux`` (loss,
  tokens), and every gradient leaf against ``jax.value_and_grad`` within
  ``rtol=1e-4, atol=1e-4*max|g_ref|`` on that leaf (the largest gap seen
  on this CPU was 1.7e-6 of max|g_ref|);
* ``forward(remat=True)`` gives the same gradients as ``remat=False``,
  and really rematerializes: every layer runs again in the backward
  pass, fewer activation bytes are saved, and inference runs each layer
  once;
* ``make_eval_step`` equals the reference's ``aux``.

On a few archs that cover every block type (dense with QKV bias, MoE
with MLA and a leading dense layer, SSM, hybrid, frontend), one
``make_train_step`` step from the same carried state
(``train_state_from_arrays``), with ``accum=1`` and ``accum=2``: loss,
``aux``, ``grad_norm``, ``lr`` and both moments within the gradient
tolerance, and the updated parameters within it where the update is
well conditioned.  Adam's first step is close to ``sign(g)``: an element
whose gradient is at float32 noise level may move by up to ``2*lr``
differently in the two packages.  So parameters are compared where the
reference's first moment is above ``1e-3 * max|m_ref|`` on the leaf, or
exactly zero (embedding rows of tokens not in the batch, which only
decay).  That leaves out 0.4-50 % of a leaf (half of the K bias, whose
true gradient is zero) and under 10 % of all elements; on the compared
elements the largest gap seen was 4.7e-7 of max|p_ref|, against up to
1.4e-3 on the left-out ones.  Without an MoE (whose expert capacity
follows the microbatch's tokens), ``accum=2`` also gives the loss and
``grad_norm`` of ``accum=1`` (equal token counts per microbatch).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ARCHS as REF_ARCHS
from repro.models import params as ref_pm
from repro.models.transformer import model_specs as ref_model_specs
from repro.train.data import DataConfig as RefDataConfig
from repro.train.data import SyntheticLM as RefSyntheticLM
from repro.train.optimizer import OptConfig as RefOptConfig
from repro.train.optimizer import init_opt_state as ref_init_opt_state
from repro.train.steps import loss_fn as ref_loss_fn
from repro.train.steps import make_eval_step as ref_make_eval_step
from repro.train.steps import make_train_step as ref_make_train_step

from repro_torch.configs import ARCHS, get_arch
from repro_torch.core.carry import (lm_params_from_arrays,
                                    train_state_from_arrays)
from repro_torch.models import params as pm
from repro_torch.models import transformer
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.steps import (init_train_state, loss_fn,
                                     make_eval_step, make_train_step)

ALL_ARCHS = sorted(ARCHS)
#: one arch per block type: dense + QKV bias, MoE + MLA + a dense first
#: layer, SSM, hybrid (sliding window), frontend prefix
STEP_ARCHS = ("qwen2-1.5b", "deepseek-v2-236b", "mamba2-1.3b",
              "hymba-1.5b", "internvl2-2b")
CPU = torch.device("cpu")
B, S = 4, 16
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
#: the share of max|m_ref| above which an updated parameter is compared
WELL_CONDITIONED = 1e-3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol, what=""):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, b=B, s=S, seed=3):
    """A reference ``SyntheticLM`` batch (numpy) of ``s`` positions."""
    F = cfg.frontend_tokens
    return RefSyntheticLM(RefDataConfig(vocab=cfg.vocab, seq_len=s - F,
                                        global_batch=b, seed=seed),
                          arch=cfg).batch(0)


def _torch_batch(raw):
    return {k: torch.as_tensor(v) for k, v in raw.items()}


@pytest.fixture(scope="module", params=ALL_ARCHS)
def pair(request):
    """(port cfg, reference weights as numpy, batch, the reference's
    float32 loss, aux and gradients) for one reduced arch."""
    arch = request.param
    rcfg = REF_ARCHS[arch].reduced()
    params = ref_pm.materialize(ref_model_specs(rcfg), jax.random.PRNGKey(0))
    raw = _batch(rcfg)
    f = jax.jit(jax.value_and_grad(
        lambda p, b: ref_loss_fn(rcfg, p, b, jnp.float32), has_aux=True))
    (loss, aux), grads = f(params, {k: jnp.asarray(v)
                                    for k, v in raw.items()})
    return (get_arch(arch).reduced(), _np(params), raw,
            {"loss": float(loss), "aux": _np(aux), "grads": _np(grads)})


def _port_grads(cfg, ref_params, raw, remat=True):
    params = lm_params_from_arrays(cfg, ref_params, CPU)
    live = pm.tree_map(lambda t: t.requires_grad_(), params)
    loss, aux = loss_fn(cfg, live, _torch_batch(raw), torch.float32,
                        remat=remat)
    grads = torch.autograd.grad(loss, pm.tree_leaves(live))
    return float(loss.detach()), aux, grads


def test_loss_and_gradients_match_the_reference(pair):
    cfg, ref_params, raw, ref = pair
    loss, aux, grads = _port_grads(cfg, ref_params, raw)
    _close(loss, ref["loss"], LOSS_RTOL, "loss")
    _close(aux["loss"].detach().numpy(), ref["aux"]["loss"], LOSS_RTOL,
           "aux loss")
    assert aux["tokens"].dtype == torch.float32
    assert float(aux["tokens"]) == float(ref["aux"]["tokens"]) == B * (
        S - cfg.frontend_tokens)
    ref_leaves = jax.tree.leaves(ref["grads"])
    assert len(grads) == len(ref_leaves)
    for i, (g, r) in enumerate(zip(grads, ref_leaves)):
        assert np.abs(r).max() > 0, i
        _close(g.numpy(), r, GRAD_TOL, f"{cfg.name} gradient leaf {i}")


def test_remat_gives_the_same_gradients(pair):
    cfg, ref_params, raw, _ = pair
    loss_on, _, on = _port_grads(cfg, ref_params, raw, remat=True)
    loss_off, _, off = _port_grads(cfg, ref_params, raw, remat=False)
    assert loss_on == loss_off
    for a, b in zip(on, off):
        assert torch.equal(a, b)


def test_eval_step_matches_the_reference(pair):
    cfg, ref_params, raw, ref = pair
    params = lm_params_from_arrays(cfg, ref_params, CPU)
    aux = make_eval_step(cfg, cdt=torch.float32)(params, _torch_batch(raw))
    assert not aux["loss"].requires_grad
    _close(aux["loss"].numpy(), ref["aux"]["loss"], LOSS_RTOL, "loss")
    assert float(aux["tokens"]) == float(ref["aux"]["tokens"])


def test_reference_eval_step_is_its_loss_aux():
    """The reference's own eval step on one arch, so the fixture's aux
    stands for it."""
    rcfg = REF_ARCHS["qwen2-1.5b"].reduced()
    params = ref_pm.materialize(ref_model_specs(rcfg), jax.random.PRNGKey(0))
    raw = _batch(rcfg)
    jb = {k: jnp.asarray(v) for k, v in raw.items()}
    aux = jax.jit(ref_make_eval_step(rcfg, jnp.float32))(params, jb)
    cfg = get_arch("qwen2-1.5b").reduced()
    got = make_eval_step(cfg, cdt=torch.float32)(
        lm_params_from_arrays(cfg, _np(params), CPU), _torch_batch(raw))
    _close(got["loss"].numpy(), np.asarray(aux["loss"]), LOSS_RTOL, "loss")
    assert float(got["tokens"]) == float(aux["tokens"])


# ------------------------------------------------------------------ remat
def _count_layer_calls(monkeypatch):
    calls = []
    inner = transformer.block_apply

    def counted(*args, **kw):
        calls.append(torch.is_grad_enabled())
        return inner(*args, **kw)
    monkeypatch.setattr(transformer, "block_apply", counted)
    return calls


def _saved_bytes(fn):
    """Bytes of the tensors autograd saves for the backward pass while
    ``fn`` runs."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, total[0]


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-v2-236b",
                                  "mamba2-1.3b"])
def test_remat_recomputes_each_layer(arch, monkeypatch):
    cfg = get_arch(arch).reduced()
    params, _ = init_train_state(cfg, torch.Generator().manual_seed(0),
                                 device=CPU)
    batch = _torch_batch(_batch(cfg, b=2, s=32))
    calls = _count_layer_calls(monkeypatch)
    n = cfg.n_layers
    saved = {}
    for remat in (True, False):
        calls.clear()
        live = pm.tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, saved[remat] = _saved_bytes(lambda: loss_fn(
            cfg, live, batch, torch.float32, remat=remat)[0])
        assert len(calls) == n
        torch.autograd.grad(loss, pm.tree_leaves(live))
        # with remat every layer runs again during the backward pass
        assert len(calls) == (2 * n if remat else n), (remat, calls)
    assert saved[True] < saved[False] / 2, saved
    # inference (no grad) never rematerializes
    calls.clear()
    make_eval_step(cfg, cdt=torch.float32)(params, batch)
    assert calls == [False] * n


# ------------------------------------------------------------- train step
def _ref_state(rcfg):
    params = ref_pm.materialize(ref_model_specs(rcfg), jax.random.PRNGKey(0))
    return params, ref_init_opt_state(params)


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_train_step_matches_the_reference(arch):
    rcfg = REF_ARCHS[arch].reduced()
    cfg = get_arch(arch).reduced()
    raw = _batch(rcfg)
    ref_params, ref_opt = _ref_state(rcfg)
    np_params, np_opt = _np(ref_params), _np(ref_opt)
    jb = {k: jnp.asarray(v) for k, v in raw.items()}
    metrics = {}
    for accum in (1, 2):
        rp, ro, rm = jax.jit(ref_make_train_step(
            rcfg, RefOptConfig(**OPT), cdt=jnp.float32, accum=accum))(
            ref_params, ref_opt, jb)
        params, opt = train_state_from_arrays(cfg, np_params, np_opt, CPU)
        p, o, m = make_train_step(cfg, OptConfig(**OPT), cdt=torch.float32,
                                  accum=accum)(params, opt,
                                               _torch_batch(raw))
        assert p is params and o["m"] is opt["m"]
        what = f"{arch} accum={accum}"
        assert sorted(m) == sorted(rm) == ["grad_norm", "loss", "lr",
                                           "tokens"]
        _close(m["loss"].numpy(), np.asarray(rm["loss"]), LOSS_RTOL, what)
        for k in ("grad_norm", "lr", "tokens"):
            _close(m[k].numpy(), np.asarray(rm[k]), GRAD_TOL, f"{what} {k}")
        assert int(o["step"]) == int(ro["step"]) == 1
        for name, got, want in (("m", o["m"], ro["m"]),
                                ("v", o["v"], ro["v"])):
            for i, (a, b) in enumerate(zip(pm.tree_leaves(got),
                                           jax.tree.leaves(want))):
                _close(a.numpy(), np.asarray(b), GRAD_TOL,
                       f"{what} {name} leaf {i}")
        kept = total = 0
        for i, (a, b, mr) in enumerate(zip(pm.tree_leaves(p),
                                           jax.tree.leaves(rp),
                                           jax.tree.leaves(ro["m"]))):
            mr = np.abs(np.asarray(mr))
            keep = (mr == 0) | (mr > WELL_CONDITIONED * mr.max())
            kept, total = kept + keep.sum(), total + keep.size
            _close(a.numpy()[keep], np.asarray(b)[keep], GRAD_TOL,
                   f"{what} parameter leaf {i}")
        assert kept / total > 0.9, (what, kept / total)
        metrics[accum] = m
    if cfg.moe is None:
        # an MoE's expert capacity follows the tokens of a microbatch, so
        # there the two differ (in the reference too)
        for k in ("loss", "grad_norm"):
            _close(metrics[2][k].numpy(), metrics[1][k].numpy(), LOSS_RTOL,
                   f"{arch} accum 2 against 1: {k}")
    # aux is the microbatches' mean: each holds half the tokens
    assert float(metrics[2]["tokens"]) * 2 == float(metrics[1]["tokens"])
