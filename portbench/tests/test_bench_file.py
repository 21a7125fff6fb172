"""BENCHMARK.json keeps to the contract's shape, and every file a cell names
is found by its name; a cell and a metric added as new files are picked up
without an edit to any file that is there."""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil

import pytest

from portbench import cell as cells

ROOT = cells.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return cells.load_benchmark()


def _one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_shape(bench):
    assert set(bench) == TOP_KEYS
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert all(_one_line(w) for w in bench["command"]) and len(bench["command"]) <= 32
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_keys(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _one_line(c["source"]) and _one_line(c["why"])
        assert c["file"].startswith("portbench/") and all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _one_line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        names.append(w["name"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        names.append(m["name"])
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _one_line(m["layer"]) and m["moves"] in {e["name"] for e in bench["end_to_end"]}
        names.append(m["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert all(NAME.match(n) for n in names)
    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer(bench):
    for w in bench["workloads"]:
        c = cells.find_cell(bench, w["name"])
        e2e = {m["name"] for m in c.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
        # each per-layer metric moves an end-to-end metric the cell reports
        assert all(m["moves"] in e2e for m in c.per_layer), w["name"]


@pytest.mark.parametrize("workload", ["robot450-render4k", "refined1800-fit1024",
                                      "robot450-fit512"])
def test_every_file_a_cell_names_is_found(bench, workload):
    c = cells.find_cell(bench, workload)
    assert hasattr(c.driver, "setup")
    assert c.limits, "the cell has its limits file"
    assert cells.mesh_path(c).endswith("robot.stl")
    for m in c.per_layer:
        assert callable(cells.metric_reader(c, m["name"]))
        base = m["name"].split(".")[0]
        assert os.path.exists(os.path.join(cells.PACKAGE_DIR, "metrics", f"{base}.py"))


def _digests(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            if "__pycache__" in dirpath:
                continue
            path = os.path.join(dirpath, f)
            with open(path, "rb") as fh:
                out[os.path.relpath(path, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_a_cell_and_a_metric_added_as_files(bench, tmp_path):
    """A new mix, cell, metric and limits file in a copy of the package are
    found by name; every file that was there is left as it was."""
    pkg = tmp_path / "portbench"
    shutil.copytree(cells.PACKAGE_DIR, pkg, ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = _digests(pkg)
    mix = json.load(open(pkg / "traffic" / "fit512.json"))
    mix["res"] = 256
    (pkg / "traffic" / "fit256.json").write_text(json.dumps(mix))
    (pkg / "metrics" / "steps_seen.py").write_text(
        "def read(traced):\n    return float(traced.units)\n")
    (pkg / "limits" / "robot450-fit256.json").write_text(json.dumps({"numbers": {}}))
    extended = dict(bench)
    extended["workloads"] = bench["workloads"] + [
        {"name": "robot450-fit256", "config": "robot450", "traffic": "fit256", "chips": 1,
         "why": "a smaller fit step"}]
    extended["per_layer"] = bench["per_layer"] + [
        {"name": "steps_seen.fit", "unit": "steps", "better": "higher",
         "source": "program_counter", "layer": "train step", "moves": "fit_rays_per_s",
         "workloads": ["robot450-fit256"]}]
    c = cells.find_cell(extended, "robot450-fit256", package_dir=str(pkg))
    assert c.traffic["res"] == 256 and c.driver.__name__ == "portbench.drivers.fit"
    assert [m["name"] for m in c.per_layer][-1] == "steps_seen.fit"

    class Seen:
        units = 3

    assert cells.metric_reader(c, "steps_seen.fit")(Seen()) == 3.0
    assert cells.metric_reader(c, "steps_seen.render")(Seen()) == 3.0
    after = _digests(pkg)
    assert {k: after[k] for k in before} == before
