"""The point-source cell `robot450-emitter4k`: its files are found by name,
its spans and readers work on a program with and without the ray synthesis
layer, a dry run at a tiny size loads no JAX, and at a small size on the CPU
a sound run is correct while the control (the port's bfloat16 winner
search) turns `correct` false."""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

import pytest

from portbench import cell as cells
from portbench import counted, faults, run
from portbench.work import emitter as work

WORKLOAD = "robot450-emitter4k"
SMALL = {"belts": 8, "n_rays": 16384, "chunk": 4096, "image_res": 32, "reference_chunk": 4096}
TINY = {"belts": 4, "n_rays": 1024, "chunk": 512, "image_res": 16, "reference_chunk": 512}
METRICS = ("emitter_ms_per_render.emitter", "emitter_roofline.emitter")


@pytest.fixture(scope="module")
def cell():
    return cells.find_cell(cells.load_benchmark(), WORKLOAD)


def test_every_file_the_cell_names_is_found(cell):
    assert cell.driver.__name__ == "portbench.drivers.render_emitter"
    assert cell.traffic["n_rays"] == 4096 * 4096 and cell.traffic["belts"] == 64
    # the configuration states the deployment's source as the mix runs it
    assert cell.config["name"] == cell.workload["config"] == "carlamp450"
    assert cell.config["source_from_lens"] == cell.traffic["source_from_lens"]
    assert cell.config["belts"] == cell.traffic["belts"]
    assert cells.mesh_path(cell).endswith("robot.stl")
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "render_rays_per_s"}
    assert [m["name"] for m in cell.per_layer] == list(METRICS)
    for m in cell.per_layer:
        assert callable(cells.metric_reader(cell, m["name"]))
    assert set(cell.limits) == {"rerun", "patch_build", "pass1", "pass2", "image"}
    assert all(v["limit"] is not None for v in cell.limits.values())


def test_the_synthesis_span_is_there_only_where_the_port_has_it(cell, monkeypatch):
    from cbtr_tpu_torch.render import emitters

    from portbench import program

    assert cell.driver.spans() == program.SPANS + (cell.driver.SYNTHESIS,)
    monkeypatch.delattr(emitters, "synthesize")
    assert cell.driver.spans() == program.SPANS


class _State:
    n_rays = 4096 * 4096


class _Traced:
    units = 8
    untraced_s = 1.0

    def __init__(self, spans):
        self.state = _State()
        self.state._counted_batch = counted.Counted(8, 1.0, spans, {})


def test_the_readers_read_the_device_span_and_nothing_without_it(cell):
    ms = cells.metric_reader(cell, METRICS[0])
    roof = cells.metric_reader(cell, METRICS[1])
    bare = _Traced({"cbtr.render": [8_000_000, 8]})
    assert ms(bare) is None and roof(bare) is None
    timed = _Traced({"cbtr.emitter": [4_000_000, 8], "cbtr.emitter.device": [80_000_000, 8]})
    assert ms(timed) == pytest.approx(10.0)
    # 16,777,216 rays x 28 B at 3.35 TB/s: 0.1402 ms of 10 ms
    assert roof(timed) == pytest.approx(100.0 * work.bound_s(_State.n_rays) * 1e3 / 10.0)
    assert roof(timed) == pytest.approx(1.4022, rel=1e-4)


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
    out = subprocess.run([sys.executable, "-c", _DRY_RUN, WORKLOAD, json.dumps(TINY)],
                         cwd=cells.ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["loaded"] == [] and got["port"]
    assert got["checks"] == ["image", "pass1", "pass2", "patch_build", "rerun"]


def _run():
    c = cells.find_cell(cells.load_benchmark(), WORKLOAD, traffic_override=SMALL)
    return run.run_cell(c, 3700000001, 0.0, False, device="cpu", t0=time.perf_counter())


@functools.lru_cache(maxsize=None)
def _sound():
    return _run()


def _over(result):
    return {k for k, c in result["checks"].items() if c["value"] > c["limit"]}


def test_a_sound_run_is_correct():
    result = _sound()
    assert result["correct"], result["checks"]
    assert result["readings"]["rays_gap"] == 0.0


def test_the_control_turns_correct_false():
    with faults.FAULTS["control"]():
        result = _run()
    assert not result["correct"]
    assert _over(result) - _over(_sound()), (result["checks"], _sound()["checks"])
