"""Find a cell's files by the names `BENCHMARK.json` gives.

A workload names a configuration (its `file` in `configs`) and a traffic
mix (`traffic/<mix>.json`); the mix names its driver kind
(`drivers/<kind>.py`); each per-layer metric has its reader
(`metrics/<name before its first dot>.py`); each cell its limits (`limits/<workload>.json`).
Adding a configuration, a mix, a driver kind, a metric or a cell adds files
and entries and edits none.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import os
from typing import NamedTuple, Optional

PACKAGE_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PACKAGE_DIR)


class Cell(NamedTuple):
    name: str
    workload: dict
    config: dict
    traffic: dict
    driver: object          # the driver module
    end_to_end: list        # BENCHMARK.json's entries that this cell reports
    per_layer: list
    limits: dict            # number -> {"limit": ..., ...}
    root: str
    package_dir: str


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def _load(path: str, name: str):
    """The module of a file, loaded by its path under `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def find_cell(bench: dict, workload: str, root: str = ROOT, package_dir: str = PACKAGE_DIR,
              traffic_override: Optional[dict] = None) -> Cell:
    """The cell `workload` with every file it names loaded from package_dir.
    traffic_override: keys laid over the mix's (the tests' small sizes)."""
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(by_name)}")
    w = by_name[workload]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _json(os.path.join(root, entry["file"]))
    traffic = _json(os.path.join(package_dir, "traffic", f"{w['traffic']}.json"))
    traffic.update(traffic_override or {})
    kind = traffic["driver"]
    driver = _load(os.path.join(package_dir, "drivers", f"{kind}.py"), f"portbench.drivers.{kind}")
    limits_path = os.path.join(package_dir, "limits", f"{workload}.json")
    limits = _json(limits_path)["numbers"] if os.path.exists(limits_path) else {}
    return Cell(
        name=workload, workload=w, config=config, traffic=traffic, driver=driver,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)],
        limits=limits, root=root, package_dir=package_dir,
    )


def metric_reader(cell: Cell, name: str):
    """The `read` function of `metrics/<base>.py`, where base is the
    metric's name before its first dot: the names of one quantity that moves
    different end-to-end metrics (`device_idle_share.fit`, `.render`) share
    one reader, as an end-to-end name's base names the driver's value."""
    base = name.split(".")[0]
    path = os.path.join(cell.package_dir, "metrics", f"{base}.py")
    return _load(path, "portbench.metrics." + base.replace("-", "_")).read


def mesh_path(cell: Cell) -> str:
    """The configuration's mesh file, checked against its recorded SHA-256."""
    path = os.path.join(cell.root, cell.config["mesh"])
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest != cell.config["mesh_sha256"]:
        raise ValueError(f"{path}: SHA-256 {digest}, the configuration records "
                         f"{cell.config['mesh_sha256']}")
    return path
