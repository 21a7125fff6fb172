"""No run loads jax, jaxlib, flax or the JAX package, and the reference and
the work counter import nothing of either package or of the port.  Module
names are compared whole at the top level: the port's name begins with the
JAX package's."""
from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import pytest

from portbench import cell as cells

_DRY_RUN = r"""
import json, sys, time
from portbench import cell as cells, run
cell = cells.find_cell(cells.load_benchmark(), sys.argv[1],
                       traffic_override=json.loads(sys.argv[2]))
result = run.run_cell(cell, 4000000001, 0.0, False, device="cpu", t0=time.perf_counter())
print(json.dumps({"loaded": run.forbidden_modules(), "checks": sorted(result["checks"]),
                  "port": "cbtr_tpu_torch" in sys.modules}))
"""

TINY = {"robot450-render4k": {"res": 32, "chunk": 512, "image_res": 16,
                              "reference_chunk": 512},
        "refined1800-fit1024": {"res": 16},
        "robot450-fit512": {"res": 16}}


@pytest.mark.parametrize("workload", sorted(TINY))
def test_a_dry_run_loads_no_jax(workload):
    env = dict(os.environ, PYTHONPATH=cells.ROOT)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", _DRY_RUN, workload, json.dumps(TINY[workload])],
                         cwd=cells.ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["loaded"] == [] and got["port"] and "image" in got["checks"]


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("folder", ["reference", "work"])
def test_reference_and_work_import_no_package_of_the_repo(folder):
    root = os.path.join(cells.PACKAGE_DIR, folder)
    files = [os.path.join(root, f) for f in os.listdir(root) if f.endswith(".py")]
    assert files
    for path in files:
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "cbtr_tpu", "cbtr_tpu_torch"}, path


def test_the_forbidden_check_compares_whole_names(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "cbtr_tpu_torchish", sys)
    assert "cbtr_tpu" not in run.forbidden_modules() or "cbtr_tpu" in {
        m.split(".")[0] for m in sys.modules}
    monkeypatch.setitem(sys.modules, "cbtr_tpu.fake", sys)
    assert "cbtr_tpu" in run.forbidden_modules()
