"""The port's artifact scripts (cbtr_tpu_torch/benchmarks/) against the JAX
package's benchmarks/ on the CPU, at small sizes.

* design_lens: the cone lattice and the structured targets bit-equal to the
  JAX script's; the --smoke configuration's first 3 steps against the same
  steps of the JAX script's functions; the whole 200-step --smoke run is
  `slow`, as the JAX one is (tests/test_design.py).
* render4k, train4k and emitter4k: their --gpu bodies at a 32^2 grid (2,048
  emitter rays) with device "cpu", on the JAX package's patch tables
  (`patches_from_numpy`), against `render_multihost_ortho`,
  `make_multihost_train_step_ortho` and `render_multihost_emitter` at the
  same size and seed, at the bars of tests/test_torch_multihost.py; each
  record holds every key of the JAX record (RENDER4K_r05.json,
  TRAIN4K_r05.json, EMITTER4K_r05.json).
"""
import json
import os
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbtr_tpu.harness import preprocess as jax_preprocess
from cbtr_tpu.mesh.core import make_unit_sphere as jax_sphere
from cbtr_tpu.models import design as jax_design
from cbtr_tpu.models import robot_lens_scene as jax_robot_scene
from cbtr_tpu.models import scenes as jax_scenes
from cbtr_tpu.models.lens_model import params_from_scene as jax_params_from_scene
from cbtr_tpu.parallel import multihost as jax_mh
from cbtr_tpu.render.emitters import DeviceEmitter as JaxEmitter

from cbtr_tpu_torch.benchmarks import design_lens, emitter4k, records, render4k, train4k
from cbtr_tpu_torch.convert import patches_from_numpy
from cbtr_tpu_torch.models import scene_ortho_grid
from cbtr_tpu_torch.parallel.multihost import render_multihost_ortho

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "benchmarks"))
import design_lens as jax_design_lens  # noqa: E402  (the JAX script, as a module)

torch.set_num_threads(2)


def _jax_record_keys(name: str) -> set:
    """Every key path ("a.b") of the JAX package's committed record."""
    with open(os.path.join(REPO, name)) as f:
        rec = json.load(f)

    def paths(d, prefix=""):
        for k, v in d.items():
            yield prefix + k
            if isinstance(v, dict):
                yield from paths(v, prefix + k + ".")
    return set(paths(rec))


def _has_keys(record: dict, keys: set):
    def get(path):
        node = record
        for k in path.split("."):
            assert isinstance(node, dict) and k in node, (path, sorted(record))
            node = node[k]
    for key in keys:
        get(key)


# ---- design_lens ------------------------------------------------------------


def test_cone_lattice_rays_are_the_jax_scripts():
    s, d = design_lens.cone_lattice_rays(4096, 13.0, device="cpu")
    s_j, d_j = jax_design_lens.cone_lattice_rays(4096, 13.0)
    assert s.dtype == d.dtype == torch.float32 and d.shape == (4096, 3)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_j))


@pytest.mark.parametrize("kind", ["flat", "ring"])
def test_structured_target_is_the_jax_scripts(kind):
    got = design_lens.structured_target(kind, 32, 4.0, 1.2, 0.15)
    want = jax_design_lens.structured_target(kind, 32, 4.0, 1.2, 0.15)
    assert got.dtype == np.float32 and got.shape == (32, 32) and got.max() > 0.5
    np.testing.assert_array_equal(got, want)


def _jax_smoke_steps(steps: int):
    """The JAX script's --smoke run for `steps` steps of one stage at its
    default lr (benchmarks/design_lens.py's main, without its 10x bar):
    (loss0, the fit's losses, vertices)."""
    mesh = jax_preprocess(jax_sphere(9, 5))
    mesh.translate(jax_scenes.LENS_CENTER)
    mesh = jax_preprocess(mesh)
    screen = jnp.asarray([1.0, 0.0, 0.0, 10.0], jnp.float32)
    s, d = jax_design_lens.cone_lattice_rays(4096, 13.0)
    topo, p0 = jax_design.topology_from_mesh(mesh)
    _, img0 = jax_design.design_loss(p0, topo, s, d, screen, jnp.ones((12, 12), jnp.float32),
                                     resolution=12, extent=4.0)
    ring = jax_design_lens.structured_target("flat", 12, 4.0, 1.2, 0.15)
    target = jnp.asarray(ring * (float(np.asarray(img0).sum()) / float(ring.sum())))
    loss0, _ = jax_design.design_loss(p0, topo, s, d, screen, target, resolution=12,
                                      extent=4.0)
    _, _, losses = jax_design.fit_design(mesh, target, s, d, screen, stages=[(5e-4, steps)],
                                         resolution=12, extent=4.0)
    return float(loss0), losses, np.asarray(p0.vertices).shape[0]


def test_design_lens_smoke_first_steps_match_jax():
    """--smoke --steps 3 (4,096 cone rays, 12^2 target, the sphere 9 x 5 at
    LENS_CENTER) against the JAX script's same run: the configuration
    equal, the initial loss and each step's loss within 2e-3 and 5e-3
    relative, the loss falling in both.  The bars of
    tests/test_torch_design.py (1e-4) are set on the sphere at the origin;
    at LENS_CENTER the barycentric inverse is ill-conditioned (entries up to
    1.5e4) and rays cross patch borders with the last bits: the JAX
    package's own jitted and op-by-op forwards of this initial loss differ
    by 4.0e-4 relative (image totals 3034.49 and 3035.49: a ray moved),
    and its fit's first loss from its eager one by 7.1e-4.  Measured
    against the fit: 1.1e-4, 1.0e-3 and 2.1e-3 (Adam's normalised step
    magnifies the difference of near-zero gradients, ROADMAP queue C)."""
    rec = design_lens.run(smoke=True, steps=3, device="cpu")
    loss0_j, losses_j, vertices_j = _jax_smoke_steps(3)
    assert (rec["rays"], rec["resolution"], rec["steps"]) == (4096, 12, 3)
    assert rec["vertices"] == vertices_j and rec["stages"] == [[5e-4, 3]]
    np.testing.assert_allclose(rec["loss_initial"], loss0_j, rtol=2e-3)
    np.testing.assert_allclose(rec["losses"][0], losses_j[0], rtol=2e-3)
    np.testing.assert_allclose(rec["losses"], losses_j, rtol=5e-3)
    assert rec["losses"][2] < rec["losses"][0] and losses_j[2] < losses_j[0]
    assert rec["device"] == "cpu" and rec["card"] is None


@pytest.mark.slow
def test_design_lens_smoke_run_drops_the_loss_tenfold():
    """The whole --smoke run (200 staged Adam steps) through the script's
    command line: it asserts a 10x drop itself (the JAX script's bar)."""
    import subprocess

    proc = subprocess.run([sys.executable, "-m", "cbtr_tpu_torch.benchmarks.design_lens",
                           "--smoke", "--device", "cpu"], capture_output=True, text=True,
                          timeout=3000, cwd=REPO)
    assert proc.returncode == 0, (proc.stdout[-2000:], proc.stderr[-2000:])
    assert json.loads(proc.stdout.strip().splitlines()[-1])["loss_drop_x"] >= 10.0


# ---- the 4K scripts at 32^2 ------------------------------------------------


@pytest.fixture(scope="module")
def robot():
    """The JAX robot scene's geometry, and the same tables in the port."""
    scene = jax_robot_scene(res=1)
    port = types.SimpleNamespace(
        patches=patches_from_numpy({k: np.asarray(v) for k, v in
                                    scene.patches._asdict().items()}, device="cpu"),
        refractive_index=scene.refractive_index,
        screen_plane=torch.tensor(np.asarray(scene.screen_plane)))
    return scene, port


def test_render4k_body_matches_jax(robot):
    """run_gpu at a 32^2 grid (chunks of 256 rays) -> 32^2 image: the image
    sum against the JAX `render_multihost_ortho` of the same grid (rtol
    1e-4, tests/test_torch_multihost.py's bar; jitted XLA moves pixels of
    this lens by up to 3.0e-3 but no ray: the sums are equal), two calls
    equal, the row-major grid the same ray multiset; the record has the JAX
    record's keys and its checksum is the image's."""
    scene, port = robot
    rec = render4k.run_gpu(res=32, image_res=32, chunk=256, device="cpu", scene=port)
    img_j = np.asarray(jax_mh.render_multihost_ortho(
        jax_mh.multihost_mesh(), scene.patches, scene.refractive_index,
        jax_scenes.scene_ortho_grid(32), scene.screen_plane, resolution=32, chunk_size=256))
    assert img_j.sum() > 50
    np.testing.assert_allclose(rec["image_sum"], img_j.sum(), rtol=1e-4)
    assert rec["deterministic"] and rec["image_max_abs_diff_between_calls_rel"] == 0.0
    assert rec["rays"] == 1024 and rec["chunk"] == 256
    assert rec["row_major"]["live_ray_weight_delta"] == 0.0
    assert rec["row_major"]["image_max_abs_diff_rel"] <= 1e-6
    assert rec["device"] == "cpu" and rec["card"] is None and rec["peak_memory_gib"] is None
    _has_keys(rec, _jax_record_keys("RENDER4K_r05.json"))
    with torch.no_grad():
        img = render_multihost_ortho(None, port.patches, port.refractive_index,
                                     scene_ortho_grid(32), port.screen_plane, resolution=32,
                                     chunk_size=256)
    assert records.checksum(img) == rec["image_checksum"]


def test_train4k_body_matches_jax(robot):
    """run_gpu at a 32^2 grid, a 16^2 zero target: loss, control-point
    gradient norm and index gradient against the JAX
    `make_multihost_train_step_ortho` step at the same lens (loss rtol 1e-4,
    gradients 1e-3: the bars of tests/test_torch_multihost.py and
    tests/test_torch_lens_model.py against jitted XLA); two calls from the
    same parameters bit-equal on the CPU; the JAX record's keys."""
    scene, port = robot
    rec = train4k.run_gpu(res=32, image_res=16, chunk=256, device="cpu", scene=port)
    step = jax_mh.make_multihost_train_step_ortho(
        jax_mh.multihost_mesh(), scene.patches, scene.screen_plane,
        jnp.zeros((16, 16), jnp.float32), jax_scenes.scene_ortho_grid(32), resolution=16,
        learning_rate=1e-4)
    _, loss_j, grads_j = step(jax_params_from_scene(scene))
    g_j = np.asarray(grads_j.control_points)
    assert rec["grad_cp_norm"] > 0 and float(loss_j) > 0
    np.testing.assert_allclose(rec["loss"], float(loss_j), rtol=1e-4)
    np.testing.assert_allclose(rec["grad_cp_norm"], np.linalg.norm(g_j), rtol=1e-3)
    np.testing.assert_allclose(rec["grad_n_refr"], float(grads_j.refractive_index), rtol=1e-3)
    assert rec["deterministic"] and rec["grad_cp_max_abs_diff_between_calls_rel"] == 0.0
    _has_keys(rec, _jax_record_keys("TRAIN4K_r05.json"))


def test_emitter4k_matches_jax(robot):
    """run at 2,048 rays (8 belts, seed 7) -> 24^2 image: the device path's
    image sum against the JAX `render_multihost_emitter` (rtol 1e-4), the
    train step's loss positive with a nonzero gradient (at this size the
    normalised target is not the image itself), the host path uncut; the
    JAX record's keys."""
    scene, port = robot
    rec = emitter4k.run(n=2048, belts=8, image_res=24, chunk=1024, device="cpu",
                        scene=port)
    origin = tuple((np.asarray(jax_scenes.LENS_CENTER) - np.array([3.0, 0, 0],
                                                                  np.float32)).tolist())
    img_j = np.asarray(jax_mh.render_multihost_emitter(
        jax_mh.multihost_mesh(), scene.patches, scene.refractive_index,
        JaxEmitter(origin, 8, 2048, 7), scene.screen_plane, resolution=24))
    assert img_j.sum() > 10
    np.testing.assert_allclose(rec["flux_per_ray"]["device_path"] * 2048, img_j.sum(),
                               rtol=1e-4)
    assert rec["device_path"]["deterministic"] and rec["train_step"]["deterministic"]
    assert rec["host_path"]["rays"] == 2048 and not rec["host_path"]["cut"]
    assert rec["train_step"]["loss"] > 0 and rec["train_step"]["grad_cp_norm"] > 0
    assert 0.0 <= rec["flux_per_ray_agreement"] < 1.0
    _has_keys(rec, _jax_record_keys("EMITTER4K_r05.json"))


def test_deterministic_mode_is_scoped_to_the_run(robot):
    """--deterministic: the render and the step run under torch's
    deterministic algorithms, say so in the record, give equal results
    twice, and leave the mode off afterwards."""
    _, port = robot
    rec = render4k.run_gpu(res=16, image_res=16, chunk=128, device="cpu", scene=port,
                           deterministic=True)
    assert rec["torch_deterministic_algorithms"] and rec["deterministic"]
    rec = train4k.run_gpu(res=16, image_res=8, chunk=128, device="cpu", scene=port,
                          deterministic=True)
    assert rec["torch_deterministic_algorithms"] and rec["deterministic"]
    assert not torch.are_deterministic_algorithms_enabled()


def test_records_count_launches_without_resetting(tmp_path, capsys):
    """`cuda_lib.counted` reports the launches its call made and leaves the
    counts running, so a caller counting around it sees every launch;
    `emit` writes the record (with its label) and prints it last."""
    from cbtr_tpu_torch.ops import cuda_lib

    cuda_lib.add_launches({"sweep_select": 5})
    before = cuda_lib.launch_counts()["sweep_select"]

    def launch_twice():
        cuda_lib.add_launches({"sweep_select": 2})
        return "done"

    out, launches = cuda_lib.counted(launch_twice)
    assert out == "done" and launches["sweep_select"] == 2 and launches["winner"] == 0
    assert cuda_lib.launch_counts()["sweep_select"] == before + 2
    cuda_lib.add_launches({"sweep_select": -7})
    rec = records.emit({"x": 1}, str(tmp_path / "r.json"), "L")
    assert json.loads((tmp_path / "r.json").read_text()) == rec == {"x": 1, "label": "L"}
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
