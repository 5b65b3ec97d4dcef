"""The command refuses to run, and prints no result, where it cannot
measure: without the cell's CUDA devices, and in a directory that holds
only ``BENCHMARK.json`` and the benchmark's own files. And every name in
``BENCHMARK.json`` finds its file."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from aggbench.cell import HERE, ROOT, load_cell, metric_reader, tiles

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def _run(cwd, workload="cohort16k-chacha"):
    return subprocess.run(
        [sys.executable, "aggbench/run.py", "--workload", workload,
         "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300)


def _no_result(proc):
    assert proc.returncode != 0
    assert "correct" not in proc.stdout


def test_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for path in BENCH["paths"]:
        shutil.copytree(ROOT / path, tmp_path / path,
                        ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    _no_result(proc)
    assert "sda_tpu_torch" in proc.stderr


def test_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run(ROOT)
    _no_result(proc)
    assert "CUDA" in proc.stderr


@pytest.mark.parametrize("name", CELLS)
def test_every_name_finds_its_file(name):
    cell = load_cell(name)
    for metric in cell["per_layer"]:
        assert callable(metric_reader(metric["name"]))
    e2e = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell["per_layer"]
    for metric in cell["per_layer"]:
        assert metric["moves"] in e2e
    assert tiles(cell["config"], cell["traffic"])


def test_configuration_files_are_the_benchmarks():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        config = json.loads((ROOT / c["file"]).read_text())
        assert config["name"] == c["name"]
        assert Path(c["file"]).parts[0] == "aggbench"
    for w in BENCH["workloads"]:
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()


def test_tiles_of_the_cells():
    # 66 chunks (the last of 134 rows) by 6 dim tiles (the last 1,048,576
    # wide, padded to ChaCha's grain of 24 or the packing's of 3)
    for name, last in (("cohort16k-chacha", 1_048_584),
                       ("cohort16k-full", 1_048_578)):
        cell = load_cell(name)
        t = tiles(cell["config"], cell["traffic"])
        assert len(t) == 396
        assert t.count((250, 3_145_728)) == 325
        assert t.count((134, 3_145_728)) == 5
        assert t.count((250, last)) == 65 and t[-1] == (134, last)
    # through the pod, which pads the chunk of 134 participants to 250 rows
    pod = load_cell("cohort16k-full")
    pod["config"].update(entry="pod", mesh=[1, 1])
    t = tiles(pod["config"], pod["traffic"])
    assert t == [(250, 3_145_728)] * 330 + [(250, 1_048_578)] * 66
