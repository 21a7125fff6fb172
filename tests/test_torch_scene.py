"""The port's host stage and Bezier construction against the JAX package.

Same inputs on both sides: the robot.stl fixture and the unit sphere go
through the port's read_stl -> preprocess -> build_patches and through the
JAX package's NumPy preprocessing (use_native=False on both sides) ->
build_from_trimesh; the sphere also through both default (native) paths.

Tolerances: the welded triangles and the topology are NumPy on both sides
and must be equal (tris to 1e-6 for the f32 transforms).  On the sphere the
f32 patch tables agree to rtol 1e-5 / atol 1e-6 (reduction order).  On the
free-form robot mesh the three-plane intersections of the construction are
ill-conditioned in f32: rounding differences between XLA and torch grow to
1e-2 in the control points, so the robot build is held two other ways:
the float64 builds of both packages agree to 1e-9 (same formulas), and the
port's f32 build is no further from that float64 build than the JAX
package's f32 build is.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cbtr_tpu.bezier import build_from_trimesh as jax_build
from cbtr_tpu.harness.measure import preprocess as jax_preprocess
from cbtr_tpu.mesh.core import TriMesh as JaxTriMesh
from cbtr_tpu.mesh.core import make_unit_sphere as jax_sphere
from cbtr_tpu.models import scenes as jax_scenes
from cbtr_tpu.render.camera import ortho_ray_grid as jax_ortho

from cbtr_tpu_torch.bezier import build_from_trimesh
from cbtr_tpu_torch.harness import preprocess
from cbtr_tpu_torch.mesh.core import TriMesh, make_unit_sphere
from cbtr_tpu_torch.models import scenes
from cbtr_tpu_torch.render.camera import ortho_ray_grid

torch.set_num_threads(2)

LEAVES = ("control_points", "underlying", "dividers", "bary_inverse",
          "heights", "deriv_b")


def _port_robot_mesh():
    mesh = TriMesh().read(scenes.robot_stl_path())
    return preprocess(mesh, use_native=False)


def _jax_robot_mesh():
    mesh = JaxTriMesh().read(jax_scenes.robot_stl_path())
    return jax_preprocess(mesh, use_native=False)


def _assert_topology_equal(port_mesh, jax_mesh):
    np.testing.assert_allclose(port_mesh.tris, jax_mesh.tris, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(port_mesh.fellow_triangles,
                                  jax_mesh.fellow_triangles)
    np.testing.assert_array_equal(port_mesh.fellow_common_side_starts,
                                  jax_mesh.fellow_common_side_starts)


def _assert_no_further_from_f64(port32, jax32, port64, factor=1.0):
    """Leaf by leaf: max |port f32 - f64| <= factor * max |JAX f32 - f64|."""
    assert port32.num_patches == jax32.num_patches == port64.num_patches
    np.testing.assert_array_equal(port32.neighbours.numpy(),
                                  np.asarray(jax32.neighbours))
    for name in LEAVES:
        exact = getattr(port64, name).numpy()
        err_port = np.abs(getattr(port32, name).double().numpy() - exact).max()
        err_jax = np.abs(np.asarray(getattr(jax32, name), np.float64) - exact).max()
        assert err_port <= factor * err_jax, (name, err_port, err_jax)


def test_sphere_preprocess_and_build_match_jax():
    port_mesh = preprocess(make_unit_sphere(7, 3), use_native=False)
    jax_mesh = jax_preprocess(jax_sphere(7, 3), use_native=False)
    _assert_topology_equal(port_mesh, jax_mesh)
    port = build_from_trimesh(port_mesh, device="cpu")
    ref = jax_build(jax_mesh)
    assert port.num_patches == ref.num_patches == 3 * len(jax_mesh)
    np.testing.assert_array_equal(port.neighbours.numpy(), np.asarray(ref.neighbours))
    for name in LEAVES:
        np.testing.assert_allclose(
            getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
            rtol=1e-5, atol=1e-6, err_msg=name,
        )


def test_sphere_default_preprocess_and_build_match_jax():
    """Both packages' default path (the native runtime): the same mesh bit
    for bit, and the sphere's f32 tables within the NumPy path's bars.  The
    robot's default scene is held in tests/test_torch_native.py."""
    port_mesh = preprocess(make_unit_sphere(7, 3))
    jax_mesh = jax_preprocess(jax_sphere(7, 3))
    assert port_mesh.corner_average_normals is not None
    for key, value in port_mesh.device_arrays().items():
        np.testing.assert_array_equal(value, jax_mesh.device_arrays()[key], err_msg=key)
    port = build_from_trimesh(port_mesh, device="cpu")
    ref = jax_build(jax_mesh)
    np.testing.assert_array_equal(port.neighbours.numpy(), np.asarray(ref.neighbours))
    for name in LEAVES:
        np.testing.assert_allclose(
            getattr(port, name).numpy(), np.asarray(getattr(ref, name)),
            rtol=1e-5, atol=1e-6, err_msg=name,
        )


def test_robot_preprocess_and_build_match_jax():
    port_mesh, jax_mesh = _port_robot_mesh(), _jax_robot_mesh()
    _assert_topology_equal(port_mesh, jax_mesh)
    _assert_no_further_from_f64(build_from_trimesh(port_mesh, device="cpu"), jax_build(jax_mesh),
                                build_from_trimesh(port_mesh, device="cpu", dtype=torch.float64))


_JAX_F64_BUILD = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import cbtr_tpu.bezier.build as build


class _F64:
    # the module's jnp with float32 read as float64: the same construction
    # evaluated in double precision
    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


build.jnp = _F64()
from cbtr_tpu.harness.measure import preprocess
from cbtr_tpu.mesh.core import TriMesh
from cbtr_tpu.models.scenes import robot_stl_path

arrays = preprocess(TriMesh().read(robot_stl_path()), use_native=False).device_arrays()
args = [jnp.asarray(arrays[k].astype(np.float64) if arrays[k].dtype == np.float32
                    else arrays[k])
        for k in ("tris", "fellow_triangles", "fellow_common_side_starts",
                  "corner_average_normals")]
patches = build.build_patches.__wrapped__(*args)
np.savez(sys.argv[1], **{k: np.asarray(v) for k, v in patches._asdict().items()})
"""


def test_robot_float64_build_formulas_match_jax(tmp_path):
    """The construction's formulas are the JAX package's: evaluated in
    float64 (JAX in x64 mode, in a fresh process) both builds agree to
    1e-9 relative."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = tmp_path / "jax_f64.npz"
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _JAX_F64_BUILD, str(out)],
                          capture_output=True, text=True, timeout=300,
                          cwd=repo, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = np.load(out)
    port = build_from_trimesh(_port_robot_mesh(), device="cpu", dtype=torch.float64)
    assert ref["control_points"].dtype == np.float64
    np.testing.assert_array_equal(port.neighbours.numpy(), ref["neighbours"])
    for name in LEAVES:
        got = getattr(port, name).numpy()
        np.testing.assert_allclose(got, ref[name], rtol=1e-9,
                                   atol=1e-9 * np.abs(ref[name]).max(),
                                   err_msg=name)


@pytest.mark.parametrize("res", [(32, 32), (20, 12), (512, 512)])
def test_ortho_ray_grid_bit_equal(res):
    """Tiled (16x8 blocks) and untiled ray orders are bit-identical."""
    kw = dict(center=(0.0, 0.0, 0.0), direction=(1.0, 0.0, 0.0),
              up=(0.0, 0.0, 1.0), width=1.8, height=1.8,
              res_x=res[0], res_y=res[1])
    for a, b in zip(ortho_ray_grid(**kw), jax_ortho(**kw)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_robot_lens_scene_matches_jax(monkeypatch):
    """The whole scene: 450 patches, the 32^2 ray grid, the screen plane."""
    monkeypatch.setenv("CBTR_NATIVE", "0")
    port = scenes.robot_lens_scene(res=32, device="cpu")
    port64 = scenes.robot_lens_scene(res=32, dtype=torch.float64, device="cpu")
    ref = jax_scenes.robot_lens_scene(res=32)
    assert port.patches.num_patches == 450
    np.testing.assert_array_equal(port.start.numpy(), np.asarray(ref.start))
    np.testing.assert_array_equal(port.direction.numpy(), np.asarray(ref.direction))
    np.testing.assert_array_equal(port.screen_plane.numpy(), np.asarray(ref.screen_plane))
    np.testing.assert_array_equal(port.fellow, ref.fellow)
    _assert_no_further_from_f64(port.patches, ref.patches, port64.patches)


@pytest.mark.parametrize("name,num_patches", [
    ("refined", 1800), ("split2", 1800), ("ellipsoid", 450), ("dimpled", 1890)])
def test_large_scene_matches_jax(monkeypatch, name, num_patches):
    """The scenes above the fused path's cap, and the ellipsoid: the same
    rays, screen plane and (refined or split) topology as the JAX package's,
    and f32 patch tables within 8 times the JAX package's f32 distance from
    the port's float64 build, leaf by leaf.  Both are f32 roundings of the
    same formulas in different orders (the float64 formulas agree to 1e-9,
    test_robot_float64_build_formulas_match_jax), and either can be the
    closer one: the port is closer on every leaf of the refined robot and
    the dimpled solid, up to 4.6 times further on the ellipsoid
    (bary_inverse) and 1.003 times on split-2 (bary_inverse, an entry of
    magnitude 7e4).  The refined robot is compared this way only because
    both packages' own f32 builds pick the same thick faces
    (tests/test_torch_refine.py counts 0 flips); where they differ, the
    refined meshes differ and this test fails on the topology."""
    monkeypatch.setenv("CBTR_NATIVE", "0")
    make, jax_make, kw = {
        "refined": (scenes.robot_lens_scene, jax_scenes.robot_lens_scene,
                    dict(refine=True)),
        "split2": (scenes.robot_lens_scene, jax_scenes.robot_lens_scene,
                   dict(split=2)),
        "ellipsoid": (scenes.ellipsoid_lens_scene, jax_scenes.ellipsoid_lens_scene, {}),
        "dimpled": (scenes.dimpled_lens_scene, jax_scenes.dimpled_lens_scene, {}),
    }[name]
    port = make(res=16, device="cpu", **kw)
    port64 = make(res=16, dtype=torch.float64, device="cpu", **kw)
    ref = jax_make(res=16, **kw)
    assert port.patches.num_patches == ref.patches.num_patches == num_patches
    np.testing.assert_array_equal(port.start.numpy(), np.asarray(ref.start))
    np.testing.assert_array_equal(port.direction.numpy(), np.asarray(ref.direction))
    np.testing.assert_array_equal(port.screen_plane.numpy(), np.asarray(ref.screen_plane))
    np.testing.assert_array_equal(port.fellow, ref.fellow)
    np.testing.assert_array_equal(port.fellow_starts, ref.fellow_starts)
    _assert_no_further_from_f64(port.patches, ref.patches, port64.patches, factor=8.0)


def test_packed_table_round_trip():
    from cbtr_tpu_torch.bezier import BezierPatches

    patches = build_from_trimesh(preprocess(make_unit_sphere(7, 3)), device="cpu")
    back = BezierPatches.from_packed_f32(patches.packed_f32(), patches.neighbours)
    for name, leaf in patches.leaves().items():
        assert torch.equal(getattr(back, name), leaf), name
