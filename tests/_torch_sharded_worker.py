"""One rank of a 4-rank gloo group: reduced archs sharded over a 2 x 2
("data", "model") CPU mesh, against the same archs on one device.

    python tests/_torch_sharded_worker.py RANK WORLD STORE OUT CKPT ARCH...

An ARCH spelled ``name@2x1x2`` runs on that ("pod", "data", "model")
mesh instead of the 2 x 2 one.

Every rank draws the same weights and inputs from seeds, computes the
one-device results, then the sharded ones over real collectives, and
gathers them whole (``full_tensor``).  Rank 0 writes, per arch, the
largest gaps (each over the one-device maximum of what it compares) to
the JSON file OUT, and under ``"restore"`` whether the parameters of
reduced qwen2-1.5b saved at step 5 in the checkpoint directory CKPT,
restored onto the mesh (``restore(shardings=)``), equal the saved
leaves whole, bit for bit.  Run by ``tests/test_torch_sharding.py``.
"""

import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import params as pm  # noqa: E402
from repro_torch.models.sharding import use_ctx  # noqa: E402
from repro_torch.models.transformer import model_specs  # noqa: E402
from repro_torch.train import checkpoint as ck  # noqa: E402
from repro_torch.train.optimizer import OptConfig, init_opt_state  # noqa
from repro_torch.train.steps import (make_decode_step,  # noqa: E402
                                     make_prefill_step, make_train_step)

B, S, MAX = 4, 32, 40
F32 = torch.float32


def full(x):
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def inputs(cfg, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    F = cfg.frontend_tokens
    toks = rng.integers(0, cfg.vocab, size=(B, S - F + 1)).astype(np.int64)
    out = {"tokens": torch.from_numpy(toks[:, :-1]).to(torch.int32),
           "labels": torch.from_numpy(toks[:, 1:]).to(torch.int32),
           "next": torch.from_numpy(
               rng.integers(0, cfg.vocab, size=(B, 1))).to(torch.int32)}
    if F:
        out["embeds"] = torch.from_numpy(
            rng.standard_normal((B, F, cfg.d_model)).astype(np.float32))
    return out


def run(cfg, params, opt, data, ctx=None) -> dict:
    """Prefill, one decode step and one train step; every result whole."""
    def place(t, logical):
        if ctx is None:
            return t
        return pm.place({"t": t}, {"t": ctx.sharding(logical)})["t"]
    toks = place(data["tokens"], ("batch", "seq"))
    emb = (place(data["embeds"], ("batch", "seq", "embed"))
           if "embeds" in data else None)
    last, cache = make_prefill_step(cfg, MAX, cdt=F32)(params, toks, emb)
    nxt = place(data["next"], ("batch", "seq"))
    tok, cache = make_decode_step(cfg, cdt=F32)(params, cache, nxt, S)
    batch = {"tokens": toks, "labels": place(data["labels"],
                                             ("batch", "seq"))}
    if emb is not None:
        batch["embeds"] = emb
    params, opt, metrics = make_train_step(cfg, OptConfig(), cdt=F32)(
        params, opt, batch)
    return {"prefill_last": full(last), "decode_tok": full(tok),
            "cache": pm.tree_map(full, cache),
            "metrics": {k: full(v) for k, v in metrics.items()},
            "params": pm.tree_map(full, params),
            "m": pm.tree_map(full, opt["m"]),
            "v": pm.tree_map(full, opt["v"])}


def gap(got, want) -> float:
    """max |got - want| over max |want| (0 when both are zero)."""
    scale = float(want.abs().max())
    d = float((got.double() - want.double()).abs().max())
    return d / scale if scale else d


def leaf_gaps(got, want, keep=None) -> float:
    """The largest :func:`gap` over the leaves (where ``keep`` is True)."""
    out = 0.0
    got, want = pm.tree_leaves(got), pm.tree_leaves(want)
    keep = pm.tree_leaves(keep) if keep is not None else [None] * len(got)
    for g, w, k in zip(got, want, keep):
        if k is not None:
            g, w = g[k], w[k]
        if w.numel():
            out = max(out, gap(g, w))
    return out


def restored(mesh, ckpt: str) -> dict:
    from torch.distributed.tensor import DTensor
    specs = {"params": model_specs(get_arch("qwen2-1.5b").reduced())}
    plain = ck.restore(ckpt, 5, specs, device="cpu")
    with use_ctx(mesh) as ctx:
        got = ck.restore(ckpt, 5, specs, shardings=pm.shardings(specs, ctx))
    leaves = pm.tree_leaves(got)
    return {"leaves": len(leaves),
            "sharded": sum(any(p.is_shard() for p in t.placements)
                           for t in leaves if isinstance(t, DTensor)),
            "equal": all(torch.equal(t.full_tensor(), w) for t, w in
                         zip(leaves, pm.tree_leaves(plain)))}


def main() -> None:
    rank, world, store, out, ckpt = (int(sys.argv[1]), int(sys.argv[2]),
                                     sys.argv[3], sys.argv[4], sys.argv[5])
    archs = sys.argv[6:]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    results = {}
    try:
        mesh = make_production_mesh(shape=(2, 2), device="cpu")
        results["restore"] = restored(mesh, ckpt)
        for i, spelled in enumerate(archs):
            name, _, shape = spelled.partition("@")
            cfg = get_arch(name).reduced()
            specs = model_specs(cfg)
            data = inputs(cfg, seed=i)

            def fresh():
                p = pm.materialize(specs, torch.Generator().manual_seed(i),
                                   dtype=F32)
                return p, init_opt_state(p)
            want = run(cfg, *fresh(), data)
            placed_on = (make_production_mesh(
                shape=tuple(int(n) for n in shape.split("x")), device="cpu")
                if shape else mesh)
            with use_ctx(placed_on) as ctx:
                p, o = fresh()
                shard = pm.shardings(specs, ctx)
                p = pm.place(p, shard)
                o = {"m": pm.place(o["m"], shard),
                     "v": pm.place(o["v"], shard), "step": o["step"]}
                got = run(cfg, p, o, data, ctx)
            # Adam's first step is close to sign(g): compare updated
            # parameters where the first moment is well above float32
            # noise, or exactly zero (rows that only decay)
            keep = pm.tree_map(
                lambda m: (m.abs() > 1e-3 * m.abs().max()) | (m == 0),
                want["m"])
            results[spelled] = {
                "prefill_last": gap(got["prefill_last"],
                                    want["prefill_last"]),
                "decode_tok_equal": bool(torch.equal(got["decode_tok"],
                                                     want["decode_tok"])),
                "cache": leaf_gaps(got["cache"], want["cache"]),
                "loss_rel": gap(got["metrics"]["loss"],
                                want["metrics"]["loss"]),
                "grad_norm_rel": gap(got["metrics"]["grad_norm"],
                                     want["metrics"]["grad_norm"]),
                "m": leaf_gaps(got["m"], want["m"]),
                "v": leaf_gaps(got["v"], want["v"]),
                "params": leaf_gaps(got["params"], want["params"], keep),
            }
    finally:
        dist.destroy_process_group()
    if rank == 0:
        with open(out, "w") as f:
            json.dump(results, f)


if __name__ == "__main__":
    main()
