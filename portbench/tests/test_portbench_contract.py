"""BENCHMARK.json against the benchmark's contract, and every file the
harness finds by name."""

import json
import os
import re
import subprocess
import sys

import pytest

from portbench import harness

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]]
                         + [w["name"] for w in BENCH["workloads"]]
                         + [m["name"] for m in METRICS]
                         + [w["config"] for w in BENCH["workloads"]]
                         + [w["traffic"] for w in BENCH["workloads"]]
                         + [k for c in BENCH["configs"]
                            for k in c["reduced"]])
def test_names_use_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("m", METRICS, ids=lambda m: m["name"])
def test_metric_entries(m):
    assert UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    assert m["source"] in SOURCES
    if m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    if m["name"].endswith("_roofline"):
        assert m["unit"] == "%"


def test_names_are_unique():
    for group in (METRICS, BENCH["configs"], BENCH["workloads"]):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_are_found_by_name(w):
    cell = harness.find_cell(w["name"], BENCH)
    assert w["chips"] in (1, 4)
    assert len(w["why"]) <= 200 and "\n" not in w["why"]
    for fn in ("setup", "window", "close", "judge"):
        assert callable(getattr(cell.kind, fn))
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in names
        assert callable(harness.metric_reader(m["name"]).read)
    assert set(cell.traffic["limits"]) == {"lat_gap", "wrong"}


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    assert c["file"].startswith("portbench/")
    cfg = json.loads((ROOT / c["file"]).read_text())
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"]
    assert len(c["source"]) <= 200
    from portbench import closedloop
    for name in cfg["designs"]:
        d = closedloop.build_design(cfg, name)
        assert d.n_fifos > 0


def test_command_names_no_file_outside_paths():
    for word in BENCH["command"][1:]:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])
            assert (ROOT / word).exists()


def test_without_cuda_the_run_prints_no_result(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cell = BENCH["workloads"][0]["name"]
    p = subprocess.run([sys.executable, str(ROOT / "portbench/run.py"),
                        "--workload", cell, "--seed", str(2 ** 31 + 7),
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "TMPDIR": str(tmp_path)})
    assert p.returncode == 2
    assert p.stdout.strip() == ""


def test_without_the_program_the_run_fails(tmp_path):
    """A directory with only BENCHMARK.json and portbench/ runs nothing."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        BENCH["workloads"][0]["name"], "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env={**env, "TMPDIR": str(tmp_path)})
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_every_layer_is_one_of_perf_mds_layers():
    text = (ROOT / "PERF.md").read_text()
    section = text.split("## 3.")[1].split("## 4.")[0]
    rows = {line.split("|")[1].strip() for line in section.splitlines()
            if line.startswith("| ")}
    for layer in {m["layer"] for m in BENCH["per_layer"]}:
        assert layer in rows, layer


def test_a_pair_not_yet_listed_is_found_from_its_files():
    """A <config>.<traffic> pair whose files exist is measurable (by
    readings.py) before an entry lists it."""
    bench = {**BENCH, "workloads": []}
    cell = harness.find_cell("streamhls.k15mmtree_sa", bench)
    assert cell.traffic["kind"] == "dse" and cell.chips == 1
    with pytest.raises(FileNotFoundError):
        harness.find_cell("streamhls.no_such_traffic", bench)


def test_every_run_gets_one_host_thread_a_math_library():
    env = harness.environment()
    for name in harness.HOST_THREADS:
        assert env[name] == "1"
    assert env["REPRO_TORCH_BUILD_DIR"].startswith(str(ROOT))
