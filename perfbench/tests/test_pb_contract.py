"""Each driver's result line has the contract's form, and the command
refuses to measure without a card."""

import json
import os
import shutil
import subprocess
import sys

import pytest

import pb_tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return pb_tiny.tiny_root(tmp_path_factory.mktemp("tiny"))


def _benchmark():
    with open(pb_tiny.ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _declared(section, cell):
    return {m["name"] for m in _benchmark()[section]
            if cell in m.get("workloads", [cell])}


def _form(line):
    assert list(line)[:3] == ["correct", "attempted", "failed"]
    assert list(line)[-1] == "checks"
    assert isinstance(line["correct"], bool)
    assert line["attempted"] > 0 and line["failed"] == 0
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
        assert isinstance(m["value"], float) and m["value"] > 0
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


@pytest.mark.parametrize("cell", pb_tiny.cells())
def test_untraced_line_reports_the_cells_end_to_end_metrics(root, cell):
    line = pb_tiny.run(root, cell)
    _form(line)
    assert line["correct"] is True
    assert set(line["metrics"]) == _declared("end_to_end", cell)
    assert "breakdown" not in line


@pytest.mark.parametrize("cell", pb_tiny.cells())
def test_traced_line_reports_the_cells_per_layer_metrics(root, cell):
    line = pb_tiny.run(root, cell, trace=True)
    _form(line)
    assert line["correct"] is True
    declared = {m["name"]: m for m in _benchmark()["per_layer"]
                if cell in m.get("workloads", [cell])}
    # The CPU has no device trace: what comes from it is left out.
    host = {n for n, m in declared.items() if m["source"] != "device_trace"}
    assert host <= set(line["metrics"]) <= set(declared)


def test_every_cell_has_its_files_and_a_limit_for_each_check():
    bench = _benchmark()
    for w in bench["workloads"]:
        wl = json.loads((pb_tiny.PB / "workloads" / f"{w['name']}.json").read_text())
        assert (wl["config"], wl["traffic"], wl["chips"]) == (w["config"], w["traffic"], w["chips"])
        assert wl["why"] == w["why"]
        assert (pb_tiny.PB / "drivers" / f"{wl['driver']}.py").is_file()
        assert wl["limits"]
    for m in bench["per_layer"]:
        assert (pb_tiny.PB / "metrics" / f"{m['name']}.py").is_file()


def _command(cwd, env=None):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         pb_tiny.cells()[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_command_without_a_card_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = _command(pb_tiny.ROOT, env)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_command_without_the_program_exits_nonzero(tmp_path):
    shutil.copytree(pb_tiny.PB, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(pb_tiny.ROOT / "BENCHMARK.json", tmp_path)
    res = _command(tmp_path)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
