"""The 4K training step's cell `robot450-train4k`: its configuration, mix,
driver, limits and readers are found by name, the configuration carries
`robot450`'s lens unchanged, a dry run at a tiny size loads no JAX, and at
32^2 rays on the CPU the driver's set-up, unit and check run end to end
(and keep within the cell's limits), while the `altered` fault (every 11th
ray's winner moved) reads above a limit."""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from portbench import cell as cells
from portbench import counted, faults, run, sgd_faults
from portbench.drivers import sgd_step

WORKLOAD = "robot450-train4k"
SMALL = {"res": 32, "chunk": 256, "reference_chunk": 256, "image_res": 16}
METRICS = ("host_issue_ms_per_step.train4k", "recompute_ms_per_step.train4k",
           "k1_roofline.train4k", "device_idle_share.train4k")
NUMBERS = {"patch_build", "pass1", "pass2", "image", "loss", "grad", "update"}


@pytest.fixture(scope="module")
def cell():
    return cells.find_cell(cells.load_benchmark(), WORKLOAD)


def test_every_file_the_cell_names_is_found(cell):
    assert cell.driver.__name__ == "portbench.drivers.sgd_step"
    assert cell.workload["chips"] == 1 and cell.workload["traffic"] == "train4k"
    t = cell.traffic
    assert t["res"] == 4096 and t["chunk"] == t["reference_chunk"] == 1 << 20
    assert t["image_res"] == 128 and t["first_steps"] == 3 and t["trace_units"] == 4
    assert cell.config["name"] == cell.workload["config"] == "pod450"
    entry = {c["name"]: c for c in cells.load_benchmark()["configs"]}["pod450"]
    assert entry["reduced"] == cell.config["reduced"] == ["ranks"] and cell.config["ranks"] == 1
    assert len(entry["source"]) <= 200 and entry["source"] == cell.config["source"]
    assert cells.mesh_path(cell).endswith("robot.stl")
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "fit_rays_per_s"}
    assert [m["name"] for m in cell.per_layer] == list(METRICS)
    for m in cell.per_layer:
        assert callable(cells.metric_reader(cell, m["name"]))
        assert m["moves"] == "fit_rays_per_s" and m["workloads"] == [WORKLOAD]
    assert set(cell.limits) == NUMBERS
    assert all(v["limit"] is not None for v in cell.limits.values())
    assert cell.limits["update"]["limit"] == 0.0


def test_the_configuration_carries_the_robot_lens_unchanged(cell):
    robot = json.load(open(os.path.join(cells.PACKAGE_DIR, "configs", "robot450.json")))
    lens = set(robot) - {"name", "source", "reduced", "assumed"}
    assert lens == {"mesh", "mesh_sha256", "mesh_bytes", "refine", "split", "refractive_index",
                    "lens_center", "patches", "patches_padded", "sweep_kernel", "precision"}
    assert {k: cell.config[k] for k in lens} == {k: robot[k] for k in lens}
    assert set(robot["assumed"]) <= set(cell.config["assumed"])
    assert {"learning_rate", "target", "ranks"} <= set(cell.config["assumed"])


class _Traced:
    units = 4
    untraced_s = 1.0

    def __init__(self, spans):
        self.state = type("State", (), {})()
        self.state._counted_batch = counted.Counted(4, 1.0, spans, {})


def test_the_host_issue_reader_reads_the_steps_span_and_nothing_without_it(cell):
    read = cells.metric_reader(cell, METRICS[0])
    assert read(_Traced({"cbtr.render": [8_000_000, 4]})) is None
    assert read(_Traced({"cbtr.step": [20_000_000, 4]})) == pytest.approx(5.0)


_DRY_RUN = r"""
import json, sys, time
from portbench import cell as cells, run
cell = cells.find_cell(cells.load_benchmark(), sys.argv[1],
                       traffic_override=json.loads(sys.argv[2]))
result = run.run_cell(cell, 4000000001, 0.0, False, device="cpu", t0=time.perf_counter())
print(json.dumps({"loaded": run.forbidden_modules(), "checks": sorted(result["checks"]),
                  "port": "cbtr_tpu_torch" in sys.modules}))
"""


def test_a_dry_run_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=cells.ROOT)
    env.pop("JAX_PLATFORMS", None)
    tiny = {"res": 16, "chunk": 128, "reference_chunk": 128, "image_res": 16}
    out = subprocess.run([sys.executable, "-c", _DRY_RUN, WORKLOAD, json.dumps(tiny)],
                         cwd=cells.ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["loaded"] == [] and got["port"]
    assert set(got["checks"]) == NUMBERS


def _run(**traffic):
    torch.set_num_threads(2)
    c = cells.find_cell(cells.load_benchmark(), WORKLOAD, traffic_override={**SMALL, **traffic})
    return run.run_cell(c, 3700000001, 0.0, False, device="cpu", t0=time.perf_counter())


@functools.lru_cache(maxsize=None)
def _sound():
    return _run()


def test_set_up_unit_and_check_run_end_to_end():
    result = _sound()
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["checks"]) == NUMBERS
    assert all(c["value"] is not None for c in result["checks"].values())
    assert result["checks"]["update"]["value"] == 0.0
    assert result["correct"], result["checks"]
    assert result["metrics"]["fit_rays_per_s"]["value"] > 0
    assert {"grad.q25", "grad.median", "change.q75", "grad_cp_max", "look.build.median",
            "look.trace.median"} <= set(result["readings"])


def test_the_altered_fault_reads_above_a_limit():
    with faults.FAULTS["altered"]():
        result = _run()
    over = {k for k, c in result["checks"].items() if c["value"] > c["limit"]}
    assert not result["correct"] and over, result["checks"]
    assert {"pass1", "pass2"} & over


@pytest.mark.parametrize("fault, number, traffic", [
    # at 32^2 rays the mix's rate moves no leaf, so the update is read at a larger one
    ("sgd_unchanged", "update", {"learning_rate": 1e-6}),
    ("sgd_half_grad", "grad", {}),
])
def test_the_sgd_path_faults_read_above_their_limit(fault, number, traffic):
    with sgd_faults.FAULTS[fault]():
        result = _run(**traffic)
    check = result["checks"][number]
    assert not result["correct"] and check["value"] > check["limit"], result["checks"]


def test_the_stable_gap_reads_the_leaves_the_reference_holds_still():
    # eight reached leaves and one that no ray reaches (left out); the median
    # leaf's norm, torch's lower median, is 4
    ref = torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, 8.0, 0.0], dtype=torch.float64)
    own = ref.clone()
    own[4:8] *= 2.0
    wrong_where_unstable = ref.clone()
    wrong_where_unstable[4:8] = 0.0
    assert sgd_step.stable_gap(wrong_where_unstable, ref, own) == 0.0
    wrong_where_stable = ref.clone()
    wrong_where_stable[:4] *= 1.5
    # the stillest half's gaps 1/8, 2/8, 3/8, 4/8: their third quartile
    third_quartile = 0.375 + 0.25 * (0.5 - 0.375)
    assert sgd_step.stable_gap(wrong_where_stable, ref, own) == pytest.approx(third_quartile)
