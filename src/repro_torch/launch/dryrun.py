"""Multi-pod dry-run: run every (arch x shape x mesh) cell on meta tensors.

For each cell this runs the REAL step (``make_train_step`` for train
shapes, ``make_prefill_step`` / ``make_decode_step`` over ``init_cache``
for the others) as rank 0 of a fake process group of 256 ranks (16x16)
or 512 (2x16x16), on meta DTensors laid out by the production mesh and
the logical rules, at full depth.  No memory is allocated and nothing
is sent; each tensor op runs once, on rank 0's shard, and is counted
there.  The global numbers come from the same step run unsharded
(:func:`estimate_global_cost`).  Each cell records:

  * memory (bytes on rank 0): ``argument`` is the sum of rank 0's local
    shards of every input; ``temp`` the peak of live bytes above that,
    less what the step returns; ``output`` what the step returns that is
    not an input (the train and decode steps update their state in
    place, as the reference's donated steps do).  Live bytes are tracked
    per storage, from each op's outputs (and inputs) until the program
    drops them; tensors that only the autograd engine holds between a
    backward op and their next use are not seen, so ``temp`` is low by
    at most those;
  * operations: matrix products, counted with ``torch.utils
    .flop_counter``'s formulas (as ``FlopCounterMode`` counts them);
    elementwise work is not counted.  ``hlo_flops`` is the unsharded
    step's, ``compiled_flops_per_device`` rank 0's share, which counts
    the work each rank repeats (the attention and the SSD scan run on
    a rank's own batch rows with every head, ``batch_local``);
  * bytes: the inputs plus outputs of every aten op that is not a view,
    unfused: an upper bound on what a fused step moves (``hlo_bytes``
    unsharded, ``compiled_bytes_per_device`` rank 0's);
  * collectives: the output bytes of every collective rank 0 issues,
    under the reference's five ``COLLECTIVES`` names (a fake group on
    the CPU has no all-to-all: DTensor sends it as an all-gather there);
  * the three roofline terms against NVIDIA H100 constants, the model
    flops and the useful-compute ratio.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]

It runs on the card's device type (``--device cuda``, the default) or on
the CPU's (``--device cpu``); the tensors are meta tensors either way.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import math
import os
import time
import traceback
import weakref
from typing import Dict, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCHS, SHAPES, get_arch
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import params as pm
from repro_torch.models.sharding import DEFAULT_RULES, use_ctx
from repro_torch.models.transformer import init_cache, model_specs
from repro_torch.train.data import specs_for_shape
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.steps import (make_decode_step, make_prefill_step,
                                     make_train_step)

# NVIDIA H100 SXM, per GPU (NVIDIA's H100 data sheet, dense rates):
PEAK_FLOPS = 989e12          # bf16 tensor-core operations/s
HBM_BW = 3.35e12             # bytes/s
HBM_BYTES = 80e9
# One figure per GPU for the collectives, as the reference has: the
# 400 Gb/s ConnectX-7 InfiniBand port each GPU of a DGX H100 has
# (NVIDIA's DGX H100 data sheet), since a 16-wide mesh axis spans more
# than one 8-GPU host.  Inside a host NVLink gives 450 GB/s each way.
COLL_BW = 50e9               # bytes/s

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

#: functional collectives (``_c10d_functional`` ops) -> the reference's
#: names; ``wait_tensor`` and the autograd wrappers move nothing
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_FUNCOL = ("_c10d_functional", "c10d_functional", "_c10d_functional_autograd")


def _tensors(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class Tally(TorchDispatchMode):
    """Counts what rank 0 does: every op reaches it on local tensors (it
    hands DTensor ops back to DTensor, which runs them on local shards),
    including the collectives DTensor issues.

    ``flops`` and ``bytes`` as the module docstring says; ``collectives``
    count and output bytes per kind; ``args``, ``peak`` and ``live``
    bytes of storages.  While it is entered, tensors that autograd saves
    for the backward pass are held as detached aliases, so their storages
    stay visible until autograd lets them go."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.collectives = {k: {"count": 0, "bytes": 0} for k in COLLECTIVES}
        self.args = 0
        self.live = 0
        self.peak = 0
        self._held: Dict[int, int] = {}
        self._arg_ids: set = set()
        self._saved = torch.autograd.graph.saved_tensors_hooks(
            lambda t: t.detach(), lambda t: t)

    def hold(self, tree) -> None:
        """Count ``tree``'s storages (rank 0's shards) as arguments."""
        for t in _tensors(tree):
            st = _local(t).untyped_storage()
            if id(st) not in self._arg_ids:
                self._arg_ids.add(id(st))
                self.args += st.nbytes()
                weakref.finalize(st, self._arg_ids.discard, id(st))

    def new_bytes(self, tree) -> int:
        """Bytes of ``tree``'s storages that are not arguments."""
        sts = {id(s): s.nbytes() for s in
               (_local(t).untyped_storage() for t in _tensors(tree))
               if id(s) not in self._arg_ids}
        return sum(sts.values())

    def _see(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._arg_ids or key in self._held:
            return
        n = st.nbytes()
        self._held[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._drop, key)

    def _drop(self, key: int) -> None:
        self.live -= self._held.pop(key, 0)

    def __enter__(self):
        self._saved.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        return self._saved.__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not isinstance(func, torch._ops.OpOverload):
            return out
        from torch._subclasses.fake_tensor import FakeTensor
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out          # DTensor's own sharding propagation
        ns, name = func._schema.name.split("::")
        if ns in _FUNCOL:
            kind = _COLLECTIVE_OPS.get(name)
            if kind is not None:
                cnt = self.collectives.setdefault(kind,
                                                  {"count": 0, "bytes": 0})
                cnt["count"] += 1
                cnt["bytes"] += _nbytes(outs)
        else:
            f = self._flop_registry.get(func._overloadpacket)
            if f is not None:
                self.flops += int(f(*args, **kwargs, out_val=out))
            if not func.is_view:
                self.bytes += _nbytes(ins) + _nbytes(outs)
        for t in ins + outs:
            self._see(t)
        return out


@contextlib.contextmanager
def fake_world(world_size: int, rank: int = 0):
    """A fake process group of ``world_size`` ranks in this process, as
    ``rank`` (nothing for one rank); taken down on exit.  Its collectives
    send nothing and leave their outputs' values undefined."""
    import torch.distributed as dist
    if world_size == 1:
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already up")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def input_specs(arch: ArchConfig, shape: ShapeConfig, ctx=None) -> Dict:
    """Meta tensors (meta DTensors under a multi-device ``ctx``) for every
    model input of this cell."""
    out = {}
    for name, shp in specs_for_shape(arch, shape).items():
        if name == "embeds":
            out[name] = pm.meta(shp, torch.float32, ("batch", "seq", "embed"),
                                ctx)
        else:
            out[name] = pm.meta(shp, torch.int32,
                                ("batch", "seq")[:len(shp)], ctx)
    return out


def _cell_abstract(arch: ArchConfig, shape: ShapeConfig, ctx=None,
                   serve_dtype=None, accum: int = 1, cdt=torch.bfloat16
                   ) -> Tuple:
    """(step fn, its arguments as meta tensors laid out by ``ctx``)."""
    params = pm.shape_structs(model_specs(arch), ctx)
    if serve_dtype is not None and shape.kind != "train":
        # inference-weight quantization (perf variant): params streamed in
        # bf16 — halves the parameter-read term of serving cells
        params = pm.tree_map(lambda t: t.to(serve_dtype), params)
    ins = input_specs(arch, shape, ctx)
    if shape.kind == "train":
        opt = init_opt_state(params)       # moments laid out as params
        fn = make_train_step(arch, OptConfig(), cdt=cdt, accum=accum)
        return fn, (params, opt, dict(ins))
    if shape.kind == "prefill":
        fn = make_prefill_step(arch, shape.seq_len, cdt=cdt)
        return fn, (params, ins["tokens"], ins.get("embeds"))
    # decode: one token at the last position of a full-length cache
    cache = pm.shape_structs(
        init_cache(arch, shape.global_batch, shape.seq_len), ctx)
    fn = make_decode_step(arch, cdt=cdt)
    return fn, (params, cache, ins["tokens"], shape.seq_len - 1)


def _count(arch, shape, ctx=None, **kw) -> Tuple[Tally, int, float]:
    """``(tally, output bytes, seconds)`` of one run of the cell's step."""
    fn, args = _cell_abstract(arch, shape, ctx, **kw)
    tally = Tally()
    tally.hold(args)
    t0 = time.perf_counter()
    with tally:
        out = fn(*args)
    seconds = time.perf_counter() - t0
    return tally, tally.new_bytes(out), seconds


_EST_CACHE: Dict[Tuple, Dict[str, float]] = {}


def estimate_global_cost(arch: ArchConfig, shape: ShapeConfig,
                         donate: bool = False, serve_dtype=None,
                         cdt=torch.bfloat16) -> Dict[str, float]:
    """Whole-step global flops and bytes: the step run unsharded on meta
    tensors at full depth.  The reference extrapolates from two shallow
    unrolled lowerings because XLA's cost model counts a ``lax.scan``
    body once; eager torch runs every layer, so this count needs no
    extrapolation.  ``per_layer_flops`` is the
    difference of two shallow counts.  Mesh-independent, so cached per
    (arch, shape, variant); ``donate`` changes nothing here (the steps
    update their state in place either way)."""
    key = (arch.name, shape, str(serve_dtype), str(cdt),
           arch.moe.capacity_factor if arch.moe else None)
    if key in _EST_CACHE:
        return _EST_CACHE[key]
    kw = dict(serve_dtype=serve_dtype, cdt=cdt)
    full = _count(arch, shape, **kw)[0]
    k = arch.moe.first_k_dense if arch.moe else 0
    f1, f2 = (_count(dataclasses.replace(arch, n_layers=k + j), shape,
                     **kw)[0] for j in (1, 2))
    out = {"flops": float(full.flops), "bytes": float(full.bytes),
           "per_layer_flops": float(f2.flops - f1.flops)}
    _EST_CACHE[key] = out
    return out


def mesh_label(multi_pod: bool, mesh_shape=None) -> str:
    if mesh_shape is not None:
        return "x".join(str(a) for a in mesh_shape)
    return "2x16x16" if multi_pod else "16x16"


def run_cell(arch_name, shape_name, multi_pod: bool = False,
             donate: bool = False, serve_bf16: bool = False,
             capacity_factor: Optional[float] = None, accum: int = 1, *,
             device="cuda", mesh_shape=None, cdt=torch.bfloat16) -> Dict:
    """One cell's record.  ``arch_name`` names an arch or is an
    :class:`ArchConfig`; ``shape_name`` names a :data:`SHAPES` entry or
    is a :class:`ShapeConfig`; ``mesh_shape`` pins the mesh (default: the
    production mesh, 16x16 over 256 ranks or 2x16x16 over 512).  Rank 0
    of a fake group of that many ranks runs the step on meta tensors;
    the group is taken down before this returns."""
    arch = get_arch(arch_name) if isinstance(arch_name, str) else arch_name
    if capacity_factor is not None and arch.moe is not None:
        arch = dataclasses.replace(arch, moe=dataclasses.replace(
            arch.moe, capacity_factor=capacity_factor))
    shape = SHAPES[shape_name] if isinstance(shape_name, str) else shape_name
    label = mesh_label(multi_pod, mesh_shape)
    rec: Dict = {"arch": arch.name, "shape": shape.name, "mesh": label,
                 "kind": shape.kind,
                 "variant": dict(donate=donate, serve_bf16=serve_bf16,
                                 capacity_factor=capacity_factor,
                                 accum=accum)}
    if shape.name in SHAPES and not arch.supports_shape(shape.name):
        rec["status"] = "skipped"
        rec["reason"] = ("full-attention arch: 512K dense decode is "
                         "O(L^2) with no architectural mitigation "
                         "(DESIGN.md §3)")
        return rec

    _quiet()
    chips = (math.prod(mesh_shape) if mesh_shape is not None
             else 512 if multi_pod else 256)
    serve_dtype = torch.bfloat16 if serve_bf16 else None
    with fake_world(chips):
        mesh = make_production_mesh(multi_pod=multi_pod, shape=mesh_shape,
                                    device=device)
        rules = dict(DEFAULT_RULES)
        dp = mesh.size // dict(zip(mesh.axis_names, mesh.shape))["model"]
        if shape.global_batch % dp != 0:
            # long_500k (batch=1): batch cannot split the data axis —
            # replicate it and spread the context over every mesh axis
            rules["batch"] = None
            rules["kv_seq"] = tuple(mesh.axis_names)
        with use_ctx(mesh, rules) as ctx:
            tally, output, t_run = _count(arch, shape, ctx,
                                          serve_dtype=serve_dtype,
                                          accum=accum, cdt=cdt)

    t0 = time.perf_counter()
    est = estimate_global_cost(arch, shape, donate=donate,
                               serve_dtype=serve_dtype, cdt=cdt)
    t_est = time.perf_counter() - t0

    coll = {k: tally.collectives.get(k, {"count": 0, "bytes": 0})
            for k in (*COLLECTIVES, *tally.collectives)}
    coll_bytes_dev = float(sum(v["bytes"] for v in coll.values()))
    t_comp = est["flops"] / (chips * PEAK_FLOPS)
    t_mem = est["bytes"] / (chips * HBM_BW)
    t_coll = coll_bytes_dev / COLL_BW
    dominant = max(("compute", t_comp), ("memory", t_mem),
                   ("collective", t_coll), key=lambda kv: kv[1])[0]

    n_act = arch.n_active_params()
    if shape.kind == "train":
        model_flops = 6 * n_act * shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        model_flops = 2 * n_act * shape.global_batch * shape.seq_len
    else:
        model_flops = 2 * n_act * shape.global_batch

    temp = tally.peak - output
    total = tally.args + temp + output
    rec.update(
        status="ok",
        lower_s=t_run, compile_s=0.0, estimate_s=t_est,
        chips=chips,
        memory=dict(argument=tally.args, temp=temp, output=output,
                    total=total, fits_hbm=bool(total <= HBM_BYTES)),
        compiled_flops_per_device=tally.flops,
        compiled_bytes_per_device=tally.bytes,
        hlo_flops=est["flops"],
        hlo_bytes=est["bytes"],
        collectives=coll,
        collective_bytes_per_device=coll_bytes_dev,
        roofline=dict(compute_s=t_comp, memory_s=t_mem,
                      collective_s=t_coll, dominant=dominant),
        model_flops=model_flops,
        useful_compute_ratio=(model_flops / est["flops"]
                              if est["flops"] else None),
    )
    return rec


def _run_one(kw: dict) -> Dict:
    try:
        return run_cell(**kw)
    except Exception as e:   # a failure here is a bug in our sharding
        return {"arch": getattr(kw["arch_name"], "name", kw["arch_name"]),
                "shape": getattr(kw["shape_name"], "name", kw["shape_name"]),
                "mesh": mesh_label(kw.get("multi_pod", False),
                                   kw.get("mesh_shape")),
                "status": "error", "error": repr(e),
                "traceback": traceback.format_exc()[-2000:]}


def run_cells(cells, jobs: int = 1):
    """:func:`run_cell` over ``cells`` (its keyword arguments, one dict a
    cell), yielding each record in order; a cell that raises gives a
    record with ``status`` ``"error"``.  ``jobs`` > 1 runs the cells in
    that many spawned processes (each cell's fake group lives in its
    own process)."""
    if jobs <= 1:
        yield from map(_run_one, cells)
        return
    import multiprocessing
    with multiprocessing.get_context("spawn").Pool(jobs) as pool:
        yield from pool.imap(_run_one, cells)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--donate", action="store_true",
                    help="donate params/opt (train) or cache (decode)")
    ap.add_argument("--serve-bf16", action="store_true",
                    help="stream params in bf16 for serve cells")
    ap.add_argument("--capacity-factor", type=float, default=None,
                    help="override MoE capacity factor")
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient-accumulation microbatches (train cells)")
    ap.add_argument("--out", default="build/repro_torch/dryrun")
    ap.add_argument("--device", default="cuda",
                    help="device type of the mesh (cuda, or cpu)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells run at once, each in its own process")
    args = ap.parse_args(argv)
    _quiet()

    archs = sorted(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = sorted(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if (args.both_meshes or args.all) else \
        [args.multi_pod]
    cells = [dict(arch_name=a, shape_name=s, multi_pod=mp,
                  donate=args.donate, serve_bf16=args.serve_bf16,
                  capacity_factor=args.capacity_factor, accum=args.accum,
                  device=args.device)
             for a in archs for s in shapes for mp in meshes]

    os.makedirs(args.out, exist_ok=True)
    n_ok = n_skip = n_fail = 0
    t_all = time.perf_counter()
    for rec in run_cells(cells, args.jobs):
        tag = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}"
        print(f"=== {tag}", flush=True)
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
        st = rec["status"]
        n_ok += st == "ok"
        n_skip += st == "skipped"
        n_fail += st == "error"
        if st == "ok":
            r, m = rec["roofline"], rec["memory"]
            print(f"    ok: run={rec['lower_s']:.2f}s "
                  f"mem/dev={m['total'] / 1e9:.2f}GB "
                  f"(arg {m['argument'] / 1e9:.2f}, temp "
                  f"{m['temp'] / 1e9:.2f}) "
                  f"terms(c/m/x)=({r['compute_s']:.2e},{r['memory_s']:.2e},"
                  f"{r['collective_s']:.2e}) dom={r['dominant']}",
                  flush=True)
        else:
            print(f"    {st}: {rec.get('reason', rec.get('error'))}",
                  flush=True)
    print(f"SUMMARY ok={n_ok} skipped={n_skip} failed={n_fail} "
          f"wall={time.perf_counter() - t_all:.1f}s")
    return 1 if n_fail else 0


def _quiet() -> None:
    """DTensor warns on every two-step all-reduce of a 2-D mesh and, on
    the CPU, on every all-to-all it sends as an all-gather."""
    for name in ("torch.distributed.tensor._redistribute",
                 "torch.distributed.tensor._collective_utils",
                 "torch.distributed.distributed_c10d",
                 "torch.distributed._functional_collectives"):
        logging.getLogger(name).setLevel(logging.ERROR)


if __name__ == "__main__":
    raise SystemExit(main())
