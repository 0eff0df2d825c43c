"""The port's dry-run against the reference's, on the CPU.

The reference's cell code runs in a process of its own
(``tests/_ref_dryrun_cells.py``: importing the reference's dry-run asks
jax for 512 host devices) on an Auto-typed (2, 4) mesh, for reduced
qwen2-1.5b and reduced qwen3-moe-30b-a3b at ``ShapeConfig("t", 64, 8,
"train")``.  Against it, the port's ``run_cell`` as rank 0 of 8 fake
ranks gives:

* the same argument bytes a device (every dim of these cells divides
  its mesh axes, so both packages cut the same shards; where a dim does
  not divide, DTensor gives the first ranks the ceiling and XLA pads);
* the same model flops;
* global flops between 0.75 and 1.0 of ``estimate_global_cost``'s: the
  port counts matrix products only, XLA elementwise work too (0.87 and
  0.83 here);
* collectives printed beside the reference's: the partitioners differ,
  so they are not compared.

Also: the inputs' shapes, dtypes and specs equal the reference's
``input_specs`` for every arch at full width, every shape and both mesh
layouts; the reference's single-pod mesh under its 512 forced devices
is 16 x 32 while the port's is the 16 x 16 its records name; the
collective counter on a known case; the global flops equal
``FlopCounterMode``'s and ``estimate_global_cost``'s; the CLI writes
records with the reference's keys; no process group is left up.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, make_production_mesh
from repro_torch.models.sharding import DEFAULT_RULES, ShardingCtx

CELL = ShapeConfig("t", 64, 8, "train")
REF = os.path.join(os.path.dirname(__file__), "_ref_dryrun_cells.py")
#: the reference's record keys (``repro.launch.dryrun.run_cell``)
REF_KEYS = {"arch", "shape", "mesh", "kind", "variant", "status", "lower_s",
            "compile_s", "estimate_s", "chips", "memory",
            "compiled_flops_per_device", "compiled_bytes_per_device",
            "hlo_flops", "hlo_bytes", "collectives",
            "collective_bytes_per_device", "roofline", "model_flops",
            "useful_compute_ratio"}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "ref.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, REF, str(out)], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-4000:]
    with open(out) as f:
        return json.load(f)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-moe-30b-a3b"])
def test_cell_matches_the_reference_compiled_cell(ref, arch):
    want = ref["cells"][arch]
    rec = dryrun.run_cell(get_arch(arch).reduced(), CELL, device="cpu",
                          mesh_shape=(2, 4))
    print(f"\n{arch}: port collectives {rec['collectives']}\n"
          f"{arch}: reference collectives {want['collectives']}")
    assert rec["status"] == "ok" and rec["chips"] == 8
    assert rec["memory"]["argument"] == want["argument"]
    assert rec["model_flops"] == want["model_flops"]
    assert 0.75 * want["flops"] <= rec["hlo_flops"] <= want["flops"]
    assert set(rec) == REF_KEYS
    assert set(rec["collectives"]) == set(dryrun.COLLECTIVES)
    assert not torch.distributed.is_initialized()


def test_input_specs_equal_the_reference_for_every_cell(ref):
    from repro_torch.configs import ARCHS, SHAPES
    seen = 0
    for axes in (("data", "model"), ("pod", "data", "model")):
        ctx = ShardingCtx(Mesh(axes, (1,) * len(axes), (torch.device("cpu"),)),
                          dict(DEFAULT_RULES))
        for a in sorted(ARCHS):
            for s in sorted(SHAPES):
                got = dryrun.input_specs(get_arch(a), SHAPES[s])
                want = ref["input_specs"]["|".join((",".join(axes), a, s))]
                assert sorted(got) == sorted(want)
                for name, t in got.items():
                    logical = (("batch", "seq", "embed") if name == "embeds"
                               else ("batch", "seq")[:t.ndim])
                    spec = [list(e) if isinstance(e, tuple) else e
                            for e in ctx.spec(logical)]
                    assert [list(t.shape), str(t.dtype).replace("torch.", ""),
                            spec] == want[name], (a, s, name)
                    assert t.is_meta
                    seen += 1
    assert seen == len([n for v in ref["input_specs"].values() for n in v])


def test_single_pod_mesh_is_16x16_where_the_reference_makes_16x32(ref):
    """The reference's dry-run forces 512 devices, so its single-pod
    ``make_production_mesh()`` is 16 x 32 while its records say 16x16
    and price 256 chips; the port's cell runs on 256 ranks."""
    assert ref["production_mesh"] == {"devices": 512, "shape": [16, 32],
                                      "axis_names": ["data", "model"]}
    for world, multi_pod, shape in ((256, False, (16, 16)),
                                    (512, True, (2, 16, 16))):
        with dryrun.fake_world(world):
            m = make_production_mesh(multi_pod=multi_pod, device="cpu")
            assert m.shape == shape and m.size == world
            assert ShardingCtx(m, dict(DEFAULT_RULES)).device_mesh(
            ).mesh.shape == (world // 16, 16)
    assert not torch.distributed.is_initialized()


def test_collective_counter_counts_output_bytes():
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    n, d = 12, 5
    with dryrun.fake_world(4):
        mesh = DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("x",))
        x = DTensor.from_local(torch.empty(n // 4, d, device="meta"), mesh,
                               [Shard(0)], run_check=False)
        tally = dryrun.Tally()
        with tally:
            y = x.redistribute(mesh, [Replicate()])
        assert y.to_local().shape == (n, d)
    assert tally.collectives["all-gather"] == {"count": 1,
                                               "bytes": n * d * 4}
    assert sum(v["count"] for v in tally.collectives.values()) == 1


def test_flops_equal_flop_counter_mode_and_the_full_depth_estimate():
    from torch.utils.flop_counter import FlopCounterMode
    arch = get_arch("deepseek-v2-236b").reduced()
    fn, args = dryrun._cell_abstract(arch, CELL)
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    est = dryrun.estimate_global_cost(arch, CELL)
    assert est["flops"] == fc.get_total_flops() > 0
    assert est["per_layer_flops"] > 0
    rec = dryrun.run_cell(arch, CELL, device="cpu", mesh_shape=(2, 4))
    assert rec["hlo_flops"] == est["flops"]
    assert 0 < rec["compiled_flops_per_device"] < rec["hlo_flops"]


def test_memory_tally_sees_arguments_temporaries_and_outputs():
    x = torch.empty(256, 64, device="meta")
    w = torch.empty(64, 32, device="meta")
    tally = dryrun.Tally()
    tally.hold((x, w))

    def step(x, w):
        h = x @ w                     # 256*32*4 bytes
        g = torch.relu(h) * 2.0       # two more while h lives
        return g.sum(0)               # 32*4 bytes out
    with tally:
        out = step(x, w)
    assert tally.args == (256 * 64 + 64 * 32) * 4
    assert tally.peak == 3 * 256 * 32 * 4
    assert tally.new_bytes(out) == 32 * 4
    assert tally.flops == 2 * 256 * 64 * 32


def test_cli_writes_records_with_the_reference_keys(tmp_path, capsys):
    out = tmp_path / "dry"
    assert dryrun.main(["--arch", "qwen2-1.5b", "--shape", "long_500k",
                        "--both-meshes", "--device", "cpu",
                        "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "SUMMARY ok=0 skipped=2 failed=0" in text
    rec = json.loads((out / "qwen2-1.5b__long_500k__16x16.json").read_text())
    assert rec["status"] == "skipped" and rec["mesh"] == "16x16"


def test_decode_cell_at_full_width_runs_on_256_ranks():
    rec = dryrun.run_cell("mamba2-1.3b", "long_500k", device="cpu")
    assert rec["status"] == "ok" and rec["chips"] == 256
    assert set(rec) == REF_KEYS
    m = rec["memory"]
    assert m["total"] == m["argument"] + m["temp"] + m["output"]
    assert 0 < m["argument"] < 1e9 and m["fits_hbm"]
    assert rec["hlo_flops"] >= rec["compiled_flops_per_device"] > 0
    assert not torch.distributed.is_initialized()
