"""The reference's dry-run on its own terms, for ``tests/test_torch_dryrun.py``.

    python tests/_ref_dryrun_cells.py OUT

Importing ``repro.launch.dryrun`` asks jax for 512 host devices, so this
runs in a process of its own.  It writes to the JSON file OUT:

* ``cells``: the reference's cell code (``_cell_abstract``, lowered and
  compiled under ``jax.jit``) for reduced qwen2-1.5b and reduced
  qwen3-moe-30b-a3b at ``ShapeConfig("t", 64, 8, "train")`` on a (2, 4)
  ("data", "model") mesh whose axes are Auto-typed (the installed jax
  makes Explicit axes by default, under which the reference's embedding
  gather fails): the compiled memory, the collectives, the global flops
  from ``estimate_global_cost`` and the model flops;
* ``input_specs``: every arch at full width, every shape, on a
  ("data", "model") and a ("pod", "data", "model") mesh: the shape,
  dtype and ``PartitionSpec`` of each input;
* ``production_mesh``: the shape ``make_production_mesh()`` gives with
  the 512 devices the module asks for.
"""

import json
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro.launch import dryrun  # noqa: E402  (sets XLA_FLAGS first)

import jax  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.configs import ARCHS, SHAPES, get_arch  # noqa: E402
from repro.configs.base import ShapeConfig  # noqa: E402
from repro.launch.mesh import make_production_mesh  # noqa: E402
from repro.models.sharding import (DEFAULT_RULES, ShardingCtx,  # noqa: E402
                                   use_ctx)

CELL_ARCHS = ("qwen2-1.5b", "qwen3-moe-30b-a3b")
CELL_SHAPE = ShapeConfig("t", 64, 8, "train")


def auto_mesh(shape, names):
    return jax.make_mesh(shape, names,
                         axis_types=(AxisType.Auto,) * len(shape),
                         devices=jax.devices()[:math.prod(shape)])


def cell(name: str) -> dict:
    arch = get_arch(name).reduced()
    mesh = auto_mesh((2, 4), ("data", "model"))
    rules = dict(DEFAULT_RULES)
    with use_ctx(mesh, rules) as ctx:
        fn, args = dryrun._cell_abstract(arch, CELL_SHAPE, ctx)
        with mesh:
            compiled = jax.jit(fn).lower(*args).compile()
    mem = compiled.memory_analysis()
    est = dryrun.estimate_global_cost(arch, CELL_SHAPE)
    tokens = CELL_SHAPE.global_batch * CELL_SHAPE.seq_len
    return {"argument": int(mem.argument_size_in_bytes),
            "temp": int(mem.temp_size_in_bytes),
            "output": int(mem.output_size_in_bytes),
            "collectives": dryrun.parse_collectives(compiled.as_text()),
            "flops": est["flops"],
            "model_flops": 6 * arch.n_active_params() * tokens}


def specs() -> dict:
    out = {}
    for axes in (("data", "model"), ("pod", "data", "model")):
        mesh = auto_mesh((1,) * len(axes), axes)
        ctx = ShardingCtx(mesh, dict(DEFAULT_RULES))
        for a in sorted(ARCHS):
            for s in sorted(SHAPES):
                ins = dryrun.input_specs(get_arch(a), SHAPES[s], ctx)
                out["|".join((",".join(axes), a, s))] = {
                    k: [list(v.shape), str(v.dtype),
                        [list(e) if isinstance(e, tuple) else e
                         for e in v.sharding.spec]]
                    for k, v in ins.items()}
    return out


def main() -> None:
    out = {"cells": {name: cell(name) for name in CELL_ARCHS},
           "input_specs": specs(),
           "production_mesh": {
               "devices": jax.device_count(),
               "shape": list(make_production_mesh().devices.shape),
               "axis_names": list(make_production_mesh().axis_names)}}
    with open(sys.argv[1], "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    main()
