"""BENCHMARK.json against the benchmark's contract, every file a cell
names found by name, the result line's keys, and what the harness may
import and read."""
import ast
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness
from portbench.tests import tiny

ROOT = harness.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    # a full check of 24 cells fits its time
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_configs_files_and_reduced():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"])
        assert c["file"].startswith("portbench/configs/")
        held = json.loads((ROOT / c["file"]).read_text())
        assert held["source"] == c["source"]
        assert sorted(held["reduced"]) == sorted(c["reduced"])
        for key in c["reduced"]:
            assert NAME.match(key)
            assert not re.search(r"(_dim|_rank|hidden|intermediate|size$|"
                                 r"state|expand|per_tok|head)", key), key


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(metric):
    keys = {"name", "unit", "better", "source"}
    if metric in BENCH["end_to_end"]:
        keys |= {"bound"}
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        keys |= {"layer", "moves"}
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        for w in metric["workloads"]:
            reporting = [m for m in BENCH["end_to_end"]
                         if m["name"] == metric["moves"]][0]
            assert w in reporting.get("workloads", WORKLOADS)
    assert set(metric) - {"workloads"} == keys
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if "roofline" in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"
    for w in metric.get("workloads", []):
        assert w in WORKLOADS


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_files_found_by_name(workload):
    cell = harness.load_cell(workload)
    fam = cell.config["family"]
    for kind in ("weights", "adapters", "reference", "work"):
        assert harness.load_module(kind, fam)
    assert harness.load_module("runners", cell.traffic["kind"])
    for m in cell.end_to_end:
        assert hasattr(harness.load_module("e2e", m["name"]), "read")
    for m in cell.per_layer:
        assert hasattr(harness.load_module("layers", m["name"]), "read")
    assert "setup_s" in {m["name"] for m in cell.end_to_end}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    assert cell.limits and cell.chips == 1


@pytest.mark.parametrize("workload", WORKLOADS)
def test_result_line_keys(workload):
    cell = tiny.cell(workload)
    for traced in (False, True):
        t0 = __import__("time").perf_counter()
        rec = harness.run_cell(cell, seed=2 ** 31 + 11, seconds=0.3,
                               trace=traced, device="cpu", t_start=t0)
        out = harness.result(cell, rec, traced, {"platform": "gpu",
                                                 "kind": "x", "count": 1})
        keys = ["correct", "attempted", "failed", "metrics", "device"]
        keys += ["breakdown"] if traced else []
        assert list(out) == keys + ["checks"]
        assert out["correct"] is True and out["failed"] == 0
        assert out["attempted"] >= 1
        want = cell.per_layer if traced else cell.end_to_end
        for name, m in out["metrics"].items():
            assert name in {w["name"] for w in want}
            assert m["unit"] and m["value"] == m["value"]
        if not traced:
            assert set(out["metrics"]) == {m["name"] for m in want}
        assert set(out["checks"]) == set(cell.limits)
        json.dumps(out)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def test_no_jax_nor_reference_package_and_reference_isolated():
    for path in (ROOT / "portbench").rglob("*.py"):
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "repro"), (path, mod)
            if "reference" in path.parts:
                assert top != "repro_torch", (path, mod)


def test_nothing_reads_the_old_benchmark_folder():
    old = "bench" + "marks"
    pat = re.compile(r"""["'/]""" + old + r"""[/"']""")
    for path in (ROOT / "portbench").rglob("*"):
        if path.is_file() and path.suffix in (".py", ".json", ".md"):
            assert not pat.search(path.read_text()), path


def test_exits_without_a_result_where_there_is_no_card(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    argv = [sys.executable, "portbench/run.py", "--workload", WORKLOADS[0],
            "--seed", str(2 ** 31 + 3), "--seconds", "1", "--trace", "0"]
    p = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and "correct" not in p.stdout
    # a directory holding only BENCHMARK.json and the benchmark's files
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    p = subprocess.run(argv, cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and "correct" not in p.stdout
