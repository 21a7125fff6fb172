"""The port's native (C++) preprocessing runtime against the JAX package's
and against the port's NumPy path.

The port builds its own copy of cbtr_native.cpp with the JAX loader's g++
flags, so on the same triangles the two libraries give the same arrays
bit for bit (`array_equal`).  Against the NumPy oracle the bars are
tests/test_native.py's: tris within 1e-6, the topology equal, corner
normals within 1e-5 (the native sums round differently: up to 1.04e-7).

Since the port's `preprocess` defaults to the runtime, its default lenses
start from the JAX package's default mesh: the robot's `device_arrays()`
are equal, where the NumPy path differs in 418 of 1,350 corner-normal
entries.  Where g++ is on PATH the runtime must build: nothing skips.
"""
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from cbtr_tpu import native as jax_native
from cbtr_tpu.harness.measure import preprocess as jax_preprocess
from cbtr_tpu.mesh.core import TriMesh as JaxTriMesh
from cbtr_tpu.models import scenes as jax_scenes

from cbtr_tpu_torch import native
from cbtr_tpu_torch.bezier import build_from_trimesh
from cbtr_tpu_torch.harness import preprocess
from cbtr_tpu_torch.mesh.core import TriMesh, make_ellipsoid, make_unit_sphere
from cbtr_tpu_torch.models import scenes
from cbtr_tpu_torch.ops import intersect as ix
from cbtr_tpu_torch.ops.cuda_lib import BUILD_DIR

from test_torch_scene import _assert_no_further_from_f64

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("tris", "fellow_triangles", "fellow_common_side_starts", "corner_average_normals")


@pytest.fixture(scope="module")
def runtime():
    """The runtime, built: where g++ is on PATH it must build."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on PATH: the native runtime cannot build")
    assert native.available(), native.build_error()
    return native


def _robot_normalized(pre, trimesh):
    """robot_lens_scene's mesh before any split or refinement, by one
    package's own pipeline (read, preprocess, centre, scale, preprocess)."""
    mesh = pre(trimesh().read(scenes.robot_stl_path()))
    mesh.translate(-mesh.tris.reshape(-1, 3).mean(axis=0))
    mesh.scale(1.0 / float(np.abs(mesh.tris).max()))
    return pre(mesh)


def _split6():
    mesh = _robot_normalized(preprocess, TriMesh)
    mesh.split_triangles(6)
    return mesh.tris.copy()


MESHES = {
    "sphere7x3": lambda: make_unit_sphere(7, 3).tris,
    "ellipsoid15x5": lambda: make_ellipsoid(15, 5, (1.0, 4.0, 2.0)).tris,
    "robot": lambda: TriMesh().read(scenes.robot_stl_path()).tris,
    "robot_split6": _split6,
}


def _numpy_pipeline(tris):
    arrays = preprocess(TriMesh(tris.copy()), use_native=False).device_arrays()
    return tuple(arrays[k] for k in KEYS)


@pytest.mark.parametrize("name", list(MESHES))
def test_native_matches_jax_native(runtime, name):
    tris = MESHES[name]()
    got = runtime.preprocess(tris)
    want = jax_native.preprocess(tris)
    for key, a, b in zip(KEYS, got, want):
        assert a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b, err_msg=key)


@pytest.mark.parametrize("name", list(MESHES))
def test_native_matches_numpy_pipeline(runtime, name):
    tris = MESHES[name]()
    nt, nf, ns, na = runtime.preprocess(tris)
    pt, pf, ps, pa = _numpy_pipeline(tris)
    np.testing.assert_allclose(nt, pt, atol=1e-6)
    np.testing.assert_array_equal(nf, pf)
    np.testing.assert_array_equal(ns, ps)
    np.testing.assert_allclose(na, pa, atol=1e-5)


def test_native_raises_on_open_mesh(runtime):
    open_tris = make_unit_sphere(5, 2).tris[:3]
    with pytest.raises(ValueError, match="Vertex on edge"):
        runtime.preprocess(open_tris)
    with pytest.raises(ValueError, match="Vertex on edge"):
        preprocess(TriMesh(open_tris))          # the default path raises too


def test_native_weld_collapses_close_vertices(runtime):
    tris = make_unit_sphere(7, 3).tris
    welded = runtime.weld(tris)
    # welding must reduce distinct instances to the watertight vertex count
    assert len(np.unique(welded.reshape(-1, 3), axis=0)) <= len(
        np.unique(tris.reshape(-1, 3), axis=0))
    np.testing.assert_array_equal(welded, jax_native.weld(tris))
    # near-duplicates (1e-6 apart) collapse onto one instance
    noisy = tris + np.random.default_rng(0).normal(scale=1e-6, size=tris.shape).astype(
        np.float32)
    assert len(np.unique(runtime.weld(noisy).reshape(-1, 3), axis=0)) == len(
        np.unique(welded.reshape(-1, 3), axis=0))


def test_native_patches_trace_identically(runtime):
    """Patches built from native preprocessing give the same intersections
    as the NumPy-preprocessed ones (test_native.py's rays and bars)."""
    base = make_unit_sphere(9, 4)
    base.translate((5.0, 0.0, 0.0))
    built = []
    for use_native in (True, False):
        mesh = preprocess(TriMesh(base.tris.copy()), use_native=use_native)
        assert (mesh.corner_average_normals is not None) == use_native
        built.append(build_from_trimesh(mesh, device="cpu"))
    rng = np.random.default_rng(0)
    d = np.concatenate([np.ones((16, 1)), rng.uniform(-0.1, 0.1, (16, 2))], 1)
    d = torch.tensor(d / np.linalg.norm(d, axis=1, keepdims=True), dtype=torch.float32)
    s = torch.zeros((16, 3))
    a, b = (ix.intersect_rays(p, s, d) for p in built)
    assert torch.equal(a.what, b.what)
    hit = a.what == ix.WHAT_INTERSECT
    assert int(hit.sum()) >= 8
    torch.testing.assert_close(a.point[hit], b.point[hit], rtol=0, atol=1e-4)


def test_preprocess_defaults_to_native_and_matches_numpy(runtime):
    """The default path is the native one, matches the NumPy oracle and
    fills the per-vertex view the visualizers read."""
    tris = make_unit_sphere(7, 3).tris
    m_native = preprocess(TriMesh(tris.copy()))
    assert m_native.corner_average_normals is not None, "native path not taken"
    m_numpy = preprocess(TriMesh(tris.copy()), use_native=False)
    assert m_numpy.corner_average_normals is None
    a, b = m_native.device_arrays(), m_numpy.device_arrays()
    np.testing.assert_allclose(a["tris"], b["tris"], atol=1e-6)
    np.testing.assert_array_equal(a["fellow_triangles"], b["fellow_triangles"])
    np.testing.assert_array_equal(a["fellow_common_side_starts"],
                                  b["fellow_common_side_starts"])
    np.testing.assert_allclose(a["corner_average_normals"], b["corner_average_normals"],
                               atol=1e-5)
    # the per-vertex view, consistent with the corner view and the JAX one
    np.testing.assert_array_equal(
        m_native.vertex_average_normals[m_native.face2vertex], m_native.corner_average_normals)
    ref = jax_preprocess(JaxTriMesh(tris.copy()))
    for name in ("vertices", "face2vertex", "vertex_average_normals"):
        np.testing.assert_array_equal(getattr(m_native, name), getattr(ref, name), err_msg=name)
    assert len(m_native.vertices) == len(m_numpy.vertices)
    # standardize_normals drops the native stash: the NumPy view takes over
    m_native.standardize_normals()
    assert m_native.corner_average_normals is None


def test_cbtr_native_0_forces_numpy(runtime, monkeypatch):
    monkeypatch.setenv("CBTR_NATIVE", "0")
    mesh = preprocess(make_unit_sphere(7, 3))
    assert mesh.corner_average_normals is None
    want = preprocess(make_unit_sphere(7, 3), use_native=False).device_arrays()
    for key, value in mesh.device_arrays().items():
        np.testing.assert_array_equal(value, want[key], err_msg=key)
    monkeypatch.setenv("CBTR_NATIVE", "1")
    assert preprocess(make_unit_sphere(7, 3)).corner_average_normals is not None


def test_library_lands_in_the_build_directory(runtime):
    assert os.path.dirname(native.LIB_PATH) == BUILD_DIR
    assert BUILD_DIR == os.path.join(REPO, "build", "cbtr_tpu_torch")
    assert os.path.isfile(native.LIB_PATH) and native.build_error() is None
    assert os.path.getmtime(native.LIB_PATH) >= os.path.getmtime(native.SOURCE)
    package_dir = os.path.dirname(native.SOURCE)
    assert not [f for f in os.listdir(package_dir) if f.endswith(".so")]
    with open(native.SOURCE, "rb") as mine, open(
            os.path.join(REPO, "cbtr_tpu", "native", "cbtr_native.cpp"), "rb") as theirs:
        assert mine.read() == theirs.read()


_BUILD_AT_ONCE = r"""
import sys, time
import numpy as np
import cbtr_tpu_torch.native as n
from cbtr_tpu_torch.mesh.core import make_unit_sphere
build_dir, go = sys.argv[1], float(sys.argv[2])
n.BUILD_DIR, n.LIB_PATH = build_dir, build_dir + "/libcbtr_native.so"
while time.time() < go:
    time.sleep(0.005)
assert n.available(), n.build_error()
tris, fellow, starts, avg = n.preprocess(make_unit_sphere(7, 3).tris)
np.savez(sys.argv[3], tris=tris, fellow=fellow, starts=starts, avg=avg)
print("BUILT_OK")
"""


def test_two_processes_building_at_once_both_load_a_good_library(runtime, tmp_path):
    """Each process compiles under a name of its own and moves the library
    into place: both load a whole library and compute the same arrays as
    the one already built."""
    build_dir = tmp_path / "build"
    go = time.time() + 8.0
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AT_ONCE, str(build_dir),
                               str(go), str(tmp_path / f"out{i}.npz")],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for i in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and "BUILT_OK" in out, err[-2000:]
    assert sorted(os.listdir(build_dir)) == ["libcbtr_native.so"]   # no stray temporaries
    want = runtime.preprocess(make_unit_sphere(7, 3).tris)
    for i in range(2):
        with np.load(tmp_path / f"out{i}.npz") as got:
            for key, w in zip(("tris", "fellow", "starts", "avg"), want):
                np.testing.assert_array_equal(got[key], w, err_msg=key)


def test_rebuilds_when_the_source_is_newer(runtime, tmp_path, monkeypatch):
    lib = tmp_path / "libcbtr_native.so"
    shutil.copy(native.LIB_PATH, lib)
    os.utime(lib, (0, 0))                       # older than the source
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "LIB_PATH", str(lib))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    assert native.available()
    assert os.path.getmtime(lib) >= os.path.getmtime(native.SOURCE)


def test_build_error_is_reported(runtime, tmp_path, monkeypatch):
    """A failed build is never silent: available() is False, build_error()
    holds g++'s message, preprocess raises it."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "LIB_PATH", str(tmp_path / "libcbtr_native.so"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    assert not native.available()
    assert "error" in native.build_error()
    with pytest.raises(RuntimeError, match="native runtime unavailable"):
        native.preprocess(make_unit_sphere(5, 2).tris)
    assert not (tmp_path / "libcbtr_native.so").exists()


# ---------------------------------------------------------------------------
# the repair: the port's default lenses start from the JAX package's mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["robot", "robot_before_refinement"])
def test_default_preprocess_matches_jax_default(runtime, name):
    """With the default environment both packages' `preprocess` give the
    same device arrays, bit for bit: the robot as read, and the normalized
    robot that robot_lens_scene(refine=True) refines.  (Before the port had
    the runtime, 418 of the robot's 1,350 corner-normal entries differed.)"""
    assert os.environ.get("CBTR_NATIVE", "") != "0"
    if name == "robot":
        port = preprocess(TriMesh().read(scenes.robot_stl_path()))
        ref = jax_preprocess(JaxTriMesh().read(jax_scenes.robot_stl_path()))
    else:
        port = _robot_normalized(preprocess, TriMesh)
        ref = _robot_normalized(jax_preprocess, JaxTriMesh)
    got, want = port.device_arrays(), ref.device_arrays()
    for key in KEYS:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    # the NumPy path is the one that differs
    numpy_path = preprocess(TriMesh(port.tris.copy()), use_native=False).device_arrays()
    assert (numpy_path["corner_average_normals"] != want["corner_average_normals"]).any()


def test_default_robot_scene_matches_jax_default_scene(runtime):
    """The port's default robot scene (native preprocessing) against the JAX
    package's default scene: the same rays, screen and topology, and f32
    patch tables no further from the port's float64 build than the JAX
    package's are (test_torch_scene.py's bar for the NumPy path)."""
    assert os.environ.get("CBTR_NATIVE", "") != "0"
    port = scenes.robot_lens_scene(res=32, device="cpu")
    port64 = scenes.robot_lens_scene(res=32, dtype=torch.float64, device="cpu")
    ref = jax_scenes.robot_lens_scene(res=32)
    assert port.patches.num_patches == 450
    np.testing.assert_array_equal(port.start.numpy(), np.asarray(ref.start))
    np.testing.assert_array_equal(port.direction.numpy(), np.asarray(ref.direction))
    np.testing.assert_array_equal(port.fellow, ref.fellow)
    np.testing.assert_array_equal(port.fellow_starts, ref.fellow_starts)
    _assert_no_further_from_f64(port.patches, ref.patches, port64.patches)


def test_trimesh_copy_and_getitem_keep_the_native_stash(runtime):
    """TriMesh.copy (the JAX package's container facade) copies every table,
    the native corner normals too, into arrays of its own."""
    mesh = preprocess(make_unit_sphere(7, 3))
    twin = mesh.copy()
    for key, value in mesh.device_arrays().items():
        np.testing.assert_array_equal(twin.device_arrays()[key], value, err_msg=key)
    twin.corner_average_normals[0, 0, 0] += 1.0
    twin.tris[0, 0, 0] += 1.0
    assert mesh.corner_average_normals[0, 0, 0] != twin.corner_average_normals[0, 0, 0]
    np.testing.assert_array_equal(mesh[3], mesh.tris[3])
    assert mesh[0][0, 0] != twin[0][0, 0]
