"""The LLM serving path of the port against the reference, on the CPU.

* every config, full and reduced, has the reference's fields, parameter
  counts and shape-support matrix;
* ``lm_params_from_arrays`` carries the reference's materialized weights
  across and rejects a tree that does not fit;
* with those weights and the same inputs (numpy, seeded), the port's
  ``forward`` logits, the prefill step's last logits and cache, and
  teacher-forced decode logits equal the reference's at float32 within
  ``rtol=1e-5, atol=1e-5 * max|ref|`` for every reduced arch (the largest
  difference seen on this CPU was 6.7e-7 of max|ref|); prompts of two
  ``Q_CHUNK`` chunks too, and one bfloat16 case (qwen2-1.5b reduced)
  within ``rtol=atol/max|ref|=1e-2`` (2.4e-3 seen);
* the port's own greedy decode equals a full forward over the same
  prefix (the reference's ``test_decode_matches_full_forward``).

The reference runs once per arch (a module fixture)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import ARCHS as REF_ARCHS
from repro.models import params as ref_pm
from repro.models.sharding import ShardingCtx as RefShardingCtx
from repro.models.transformer import forward as ref_forward
from repro.models.transformer import model_specs as ref_model_specs
from repro.train.steps import make_prefill_step as ref_make_prefill

from repro_torch.configs import ARCHS, SHAPES, get_arch
from repro_torch.core.carry import lm_params_from_arrays
from repro_torch.launch.mesh import Mesh
from repro_torch.models import params as pm
from repro_torch.models.attention import Q_CHUNK
from repro_torch.models.sharding import (DEFAULT_RULES, ShardingCtx,
                                         constrain, use_ctx)
from repro_torch.models.transformer import forward, model_specs
from repro_torch.train.steps import make_decode_step, make_prefill_step

ALL_ARCHS = sorted(ARCHS)
CPU = torch.device("cpu")
B, S_PROMPT, N_DECODE = 2, 16, 3
S_MAX = S_PROMPT + N_DECODE
#: float32: relative, and absolute as a share of the reference's largest
#: value (chip_smoke.py holds the card against the CPU to the same)
RTOL = 1e-5
#: bfloat16 (8 bits of mantissa): the same share, a looser one
BF16_TOL = 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=RTOL, what=""):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


def _inputs(cfg, seed=7, b=B, s=S_PROMPT):
    """(tokens (b, s - F), embeds (b, F, d) or None, decode tokens
    (b, N_DECODE)) from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    F = cfg.frontend_tokens
    toks = rng.integers(0, cfg.vocab, (b, s - F)).astype(np.int32)
    embeds = (rng.standard_normal((b, F, cfg.d_model)).astype(np.float32)
              if F else None)
    dec = rng.integers(0, cfg.vocab, (b, N_DECODE)).astype(np.int32)
    return toks, embeds, dec


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _ref_run(cfg, params, toks, embeds, dec, cdt):
    """The reference at ``cdt``: full forward logits over prompt + decode
    tokens, the prefill step's last logits and cache, and the logits of
    each teacher-forced decode step."""
    e = None if embeds is None else jnp.asarray(embeds)
    full_toks = np.concatenate([toks, dec], axis=1)
    fwd = jax.jit(lambda p, t, e: ref_forward(
        cfg, p, t, embeds=e, remat=False, return_cache=False, cdt=cdt)[0])
    full = fwd(params, jnp.asarray(full_toks), e)
    last, cache = jax.jit(ref_make_prefill(cfg, S_MAX, cdt=cdt))(
        params, jnp.asarray(toks), e)
    out = {"full": np.asarray(full, np.float32),
           "last": np.asarray(last, np.float32),
           "cache": _np_tree(cache), "decode": []}
    step = jax.jit(lambda p, c, t, i: ref_forward(
        cfg, p, t, cache=c, cache_index=i, remat=False, return_cache=True,
        cdt=cdt))
    s0 = S_PROMPT
    for j in range(N_DECODE):
        logits, cache = step(params, cache, jnp.asarray(dec[:, j:j + 1]),
                             jnp.int32(s0 + j))
        out["decode"].append(np.asarray(logits[:, -1], np.float32))
    return out


def _port_run(cfg, params, toks, embeds, dec, cdt):
    e = None if embeds is None else torch.as_tensor(embeds)
    full_toks = torch.as_tensor(np.concatenate([toks, dec], axis=1))
    with torch.no_grad():
        full, _ = forward(cfg, params, full_toks, embeds=e,
                          return_cache=False, cdt=cdt)
    last, cache = make_prefill_step(cfg, S_MAX, cdt=cdt)(
        params, torch.as_tensor(toks), e)
    out = {"full": full.float().numpy(), "last": last.float().numpy(),
           "cache": pm.tree_map(lambda t: t.float().numpy().copy(), cache),
           "decode": []}
    for j in range(N_DECODE):
        with torch.no_grad():
            logits, cache = forward(cfg, params,
                                    torch.as_tensor(dec[:, j:j + 1]),
                                    cache=cache, cache_index=S_PROMPT + j,
                                    cdt=cdt)
        out["decode"].append(logits[:, -1].float().numpy())
    return out


@pytest.fixture(scope="module", params=ALL_ARCHS)
def pair(request):
    """(cfg, reference weights as numpy, reference run at float32, the
    inputs) for one reduced arch."""
    arch = request.param
    rcfg = REF_ARCHS[arch].reduced()
    ref_params = ref_pm.materialize(ref_model_specs(rcfg),
                                    jax.random.PRNGKey(0))
    inputs = _inputs(rcfg)
    ref = _ref_run(rcfg, ref_params, *inputs, cdt=jnp.float32)
    return get_arch(arch).reduced(), _np_tree(ref_params), ref, inputs


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_configs_equal_the_reference(arch):
    port, ref = get_arch(arch), REF_ARCHS[arch]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == \
        dataclasses.asdict(ref.reduced())
    for c, r in ((port, ref), (port.reduced(), ref.reduced())):
        assert (c.n_params(), c.n_active_params(), c.head_dim_,
                c.subquadratic) == (r.n_params(), r.n_active_params(),
                                    r.head_dim_, r.subquadratic)
        assert pm.n_params(model_specs(c)) == \
            ref_pm.n_params(ref_model_specs(r))
        for shape in list(SHAPES) + ["nope"]:
            assert c.supports_shape(shape) == r.supports_shape(shape)
    assert sorted(ARCHS) == sorted(REF_ARCHS)
    with pytest.raises(KeyError):
        get_arch("no-such-arch")


def test_sharding_specs_equal_the_reference():
    """Logical names resolve to mesh axes as in the reference (each axis
    once per spec), and ``constrain`` is the identity on one device and
    redistributes on several (a plain tensor counts as replicated: rank
    0 of a fake group keeps its rows)."""
    jmesh = jax.make_mesh((1, 1), ("data", "model"),
                          devices=jax.devices()[:1])
    tmesh = Mesh(("data", "model"), (1, 1), (CPU,))
    ref = RefShardingCtx(jmesh, dict(DEFAULT_RULES))
    port = ShardingCtx(tmesh, dict(DEFAULT_RULES))
    for logical in [("batch", "seq", "embed"), ("embed", "mlp"),
                    ("vocab", "embed"), ("layers", "embed", "heads"),
                    ("batch", "kv_seq", "kv_heads", None),
                    ("experts", "fsdp", None), (None, "heads", None)]:
        assert port.spec(logical) == tuple(ref.spec(logical)), logical
    x = torch.ones(2, 3)
    assert constrain(x, "batch", "embed") is x
    with use_ctx(tmesh):
        assert constrain(x, "batch", "embed") is x
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch.dryrun import fake_world
    with fake_world(2), use_ctx(Mesh(("data", "model"), (2, 1),
                                     (CPU, CPU))):
        y = constrain(x, "batch", "embed")
        assert isinstance(y, DTensor)
        assert y.placements == (Shard(0), Replicate())
        assert torch.equal(y.to_local(), x[:1])
    assert constrain(x, "batch", "embed") is x


# ----------------------------------------------------------- carrying
def test_carried_weights_equal_and_mismatches_raise(pair):
    cfg, ref_params, _, _ = pair
    params = lm_params_from_arrays(cfg, ref_params, CPU)
    ref_leaves = jax.tree.leaves(ref_params)
    leaves = pm.tree_leaves(params)
    assert len(leaves) == len(ref_leaves)
    for a, b in zip(leaves, ref_leaves):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), b)
    bad = dict(ref_params, embed=dict(ref_params["embed"]))
    bad["embed"]["tok"] = bad["embed"]["tok"][:-1]
    with pytest.raises(ValueError, match="shape"):
        lm_params_from_arrays(cfg, bad, CPU)
    with pytest.raises(ValueError, match="keys"):
        lm_params_from_arrays(cfg, dict(ref_params, extra={}), CPU)


# ------------------------------------------------ numerics at float32
def test_forward_prefill_and_decode_match_the_reference(pair):
    cfg, ref_params, ref, inputs = pair
    params = lm_params_from_arrays(cfg, ref_params, CPU)
    got = _port_run(cfg, params, *inputs, cdt=torch.float32)
    vpad = -(-cfg.vocab // 16) * 16
    S = S_PROMPT + N_DECODE
    assert got["full"].shape == (B, S, vpad)
    assert np.isfinite(got["full"]).all()
    _close(got["full"], ref["full"], what="forward")
    _close(got["last"], ref["last"], what="prefill last logits")
    ref_cache = ref["cache"]
    assert set(got["cache"]) == set(ref_cache)
    for grp in ref_cache:
        assert set(got["cache"][grp]) == set(ref_cache[grp])
    # the cache after the decode steps: the prefill's, updated in place
    for j, (g, w) in enumerate(zip(got["decode"], ref["decode"])):
        _close(g, w, what=f"decode step {j}")


def test_prefill_cache_matches_the_reference(pair):
    cfg, ref_params, ref, inputs = pair
    params = lm_params_from_arrays(cfg, ref_params, CPU)
    toks, embeds, _ = inputs
    _, cache = make_prefill_step(cfg, S_MAX, cdt=torch.float32)(
        params, torch.as_tensor(toks),
        None if embeds is None else torch.as_tensor(embeds))
    for grp, sub in ref["cache"].items():
        for k, want in sub.items():
            g = cache[grp][k]
            assert tuple(g.shape) == want.shape, (grp, k)
            _close(g.numpy(), want, what=f"cache {grp}/{k}")


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-v2-236b"])
def test_prompt_of_two_query_chunks_matches_the_reference(arch):
    """2 * Q_CHUNK prompt tokens: the chunked query loop (GQA and MLA)
    against the reference's ``lax.scan`` over chunks."""
    rcfg = REF_ARCHS[arch].reduced()
    cfg = get_arch(arch).reduced()
    ref_params = ref_pm.materialize(ref_model_specs(rcfg),
                                    jax.random.PRNGKey(3))
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab, (1, 2 * Q_CHUNK)).astype(np.int32)
    want = jax.jit(lambda p, t: ref_forward(
        rcfg, p, t, remat=False, return_cache=False,
        cdt=jnp.float32)[0])(ref_params, jnp.asarray(toks))
    params = lm_params_from_arrays(cfg, _np_tree(ref_params), CPU)
    with torch.no_grad():
        got, _ = forward(cfg, params, torch.as_tensor(toks),
                         return_cache=False, cdt=torch.float32)
    _close(got.numpy(), np.asarray(want), what=arch)
    with pytest.raises(ValueError, match="multiple"):
        forward(cfg, params, torch.as_tensor(toks[:, :Q_CHUNK + 8]),
                return_cache=False, cdt=torch.float32)


def test_bfloat16_matches_the_reference_loosely():
    """qwen2-1.5b reduced at bfloat16 compute (the reference's default
    ``cdt``): forward, prefill and decode within ``BF16_TOL``."""
    arch = "qwen2-1.5b"
    rcfg = REF_ARCHS[arch].reduced()
    cfg = get_arch(arch).reduced()
    ref_params = ref_pm.materialize(ref_model_specs(rcfg),
                                    jax.random.PRNGKey(0))
    inputs = _inputs(cfg)
    ref = _ref_run(rcfg, ref_params, *inputs, cdt=jnp.bfloat16)
    params = lm_params_from_arrays(cfg, _np_tree(ref_params), CPU)
    got = _port_run(cfg, params, *inputs, cdt=torch.bfloat16)
    _close(got["full"], ref["full"], BF16_TOL, "forward")
    _close(got["last"], ref["last"], BF16_TOL, "prefill")
    for j, (g, w) in enumerate(zip(got["decode"], ref["decode"])):
        _close(g, w, BF16_TOL, f"decode step {j}")


# ------------------------------------------------ the port on its own
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "deepseek-v2-236b",
                                  "mamba2-1.3b", "hymba-1.5b",
                                  "musicgen-medium"])
def test_decode_matches_full_forward(arch):
    """Greedy decode against the cache equals a fresh full forward over
    the same prefix (argmax), with the port's own initialisation."""
    cfg = get_arch(arch).reduced()
    gen = torch.Generator().manual_seed(2)
    params = pm.materialize(model_specs(cfg), gen)
    toks, embeds, _ = _inputs(cfg, seed=2)
    toks = torch.as_tensor(toks)
    embeds = None if embeds is None else torch.as_tensor(embeds)
    last, cache = make_prefill_step(cfg, S_MAX, cdt=torch.float32)(
        params, toks, embeds)
    decode = make_decode_step(cfg, cdt=torch.float32)
    tok = torch.argmax(last, -1).to(torch.int32)[:, None]
    seq = toks
    for i in range(3):
        ext = torch.cat([seq, tok], dim=1)
        with torch.no_grad():
            full, _ = forward(cfg, params, ext, embeds=embeds,
                              return_cache=False, cdt=torch.float32)
        want = torch.argmax(full[:, -1], -1)
        got, cache = decode(params, cache, tok, S_PROMPT + i)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        seq = ext
        tok = got[:, None]


def test_materialize_is_seeded_and_typed():
    cfg = get_arch("qwen2-1.5b").reduced()
    a = pm.materialize(model_specs(cfg), torch.Generator().manual_seed(5))
    b = pm.materialize(model_specs(cfg), torch.Generator().manual_seed(5),
                       dtype=torch.bfloat16)
    for x, y in zip(pm.tree_leaves(a), pm.tree_leaves(b)):
        assert x.dtype == torch.float32 and y.dtype == torch.bfloat16
        np.testing.assert_array_equal(x.to(torch.bfloat16).float().numpy(),
                                      y.float().numpy())
    assert torch.all(a["final_norm"]["w"] == 1)
    assert torch.all(a["layers"]["attn"]["bq"] == 0)
    assert pm.n_params(model_specs(cfg)) == sum(
        x.numel() for x in pm.tree_leaves(a))
