"""Tessellation, thick-patch refinement and the accuracy harness of the port
against the JAX package.

Same inputs on both sides: the JAX package's patches, handed over as NumPy,
go through the port's `tessellate` and `split_thick_patches`.  Tolerances:
the tessellated points and the split vertices are cubic evaluations summed
in another order (XLA's reduction against the port's left-to-right sum), so
they agree to 1e-6 (a few f32 ulps at magnitude 5); the thick-face count,
the emitted triangle count and every copied corner are equal.  The port's
`measure_approximation` reproduces the reference's published table
(tests/test_accuracy.py) at that file's tolerances.

On its own f32 build (not the JAX package's patches) a face near the 3%
height/perimeter threshold could flip; the thick sets are counted here for
the robot and for the accuracy-table ellipsoids (0 flips on each).
"""
import numpy as np
import pytest
import torch

from cbtr_tpu.bezier import build_from_trimesh as jax_build
from cbtr_tpu.bezier import interpolate_linear as jax_interpolate_linear
from cbtr_tpu.bezier import split_thick_patches as jax_split
from cbtr_tpu.bezier import tessellate as jax_tessellate
from cbtr_tpu.bezier.refine import _face_heights as jax_face_heights
from cbtr_tpu.harness.measure import preprocess as jax_preprocess
from cbtr_tpu.mesh.core import TriMesh as JaxTriMesh
from cbtr_tpu.mesh.core import make_dimpled_solid as jax_dimpled
from cbtr_tpu.mesh.core import make_ellipsoid as jax_ellipsoid
from cbtr_tpu.models import scenes as jax_scenes

from cbtr_tpu_torch.bezier import (
    build_from_trimesh,
    interpolate_linear,
    split_thick_patches,
    tessellate,
)
from cbtr_tpu_torch.bezier.refine import _face_heights
from cbtr_tpu_torch.convert import patches_from_numpy
from cbtr_tpu_torch.harness import measure_approximation, preprocess
from cbtr_tpu_torch.mesh.core import TriMesh, make_dimpled_solid, make_ellipsoid
from cbtr_tpu_torch.models import scenes

torch.set_num_threads(2)

AXES = (1.0, 4.0, 2.0)

# tests/test_accuracy.py: split_steps, sectors, belts, divisor, reference
# error (reference/test.cpp:515-521), relative tolerance
TABLE = [
    (0, 4, 1, 1, 1.2555894, 1e-4),
    (0, 7, 3, 3, 2.2721614e-3, 1e-4),
    (0, 15, 5, 3, 1.9426199e-5, 1e-4),
    (1, 7, 3, 3, 7.0956006e-4, 5e-3),
    (1, 15, 5, 3, 4.0229771e-4, 5e-3),
    (2, 7, 3, 3, 1.1259826e-3, 5e-3),
    (2, 15, 5, 3, 6.7134395e-5, 5e-3),
]


def _to_port(patches):
    return patches_from_numpy({k: np.asarray(v) for k, v in patches._asdict().items()})


def _jax_ellipsoid_mesh(sectors, belts):
    return jax_preprocess(jax_ellipsoid(sectors, belts, AXES), use_native=False)


@pytest.fixture(scope="module")
def fixtures():
    """name -> (JAX patches, fellow, fellow_starts): the robot scene's lens
    and the accuracy-table ellipsoids."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CBTR_NATIVE", "0")
        robot = jax_scenes.robot_lens_scene(res=8)
    out = {"robot": (robot.patches, robot.fellow, robot.fellow_starts)}
    for sectors, belts in ((7, 3), (15, 5)):
        mesh = _jax_ellipsoid_mesh(sectors, belts)
        out[f"ellipsoid{sectors}x{belts}"] = (
            jax_build(mesh), mesh.fellow_triangles, mesh.fellow_common_side_starts)
    return out


def test_interpolate_linear_matches_jax():
    rng = np.random.default_rng(0)
    cp = rng.normal(size=(50, 10, 3)).astype(np.float32)
    bary = rng.dirichlet((1.0, 1.0, 1.0), size=50).astype(np.float32)
    got = interpolate_linear(torch.tensor(cp), torch.tensor(bary)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_interpolate_linear(cp, bary)),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("divisor,blend", [(1, 1.0), (3, 1.0), (3, 0.7)])
def test_tessellate_matches_jax(fixtures, divisor, blend):
    ref_p = fixtures["robot"][0]
    got = tessellate(_to_port(ref_p), divisor, blend).numpy()
    ref = np.asarray(jax_tessellate(ref_p, divisor, blend))
    assert got.shape == ref.shape == (ref_p.num_patches * divisor ** 2, 3, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["robot", "ellipsoid7x3", "ellipsoid15x5"])
def test_split_thick_patches_on_jax_patches(fixtures, name):
    ref_p, fellow, starts = fixtures[name]
    ref_tris, ref_thick = jax_split(ref_p, fellow, starts)
    tris, thick = split_thick_patches(_to_port(ref_p), fellow, starts)
    assert thick == ref_thick > 0
    assert tris.dtype == np.float32 and tris.shape == ref_tris.shape
    np.testing.assert_allclose(tris, ref_tris, rtol=0, atol=1e-6)
    # every vertex that is a copied corner is bit-equal
    corners = np.isin(ref_tris.reshape(-1, 3).view("V12"),
                      np.asarray(ref_p.control_points[:, 0, :]).view("V12"))
    assert corners.any()
    np.testing.assert_array_equal(tris.reshape(-1, 3)[corners.ravel()],
                                  ref_tris.reshape(-1, 3)[corners.ravel()])


def _thick(heights, control_points):
    c = control_points[:, 0, :].reshape(-1, 3, 3)
    perim = sum(np.linalg.norm(c[:, i] - c[:, (i + 1) % 3], axis=-1) for i in range(3))
    return heights / perim > 0.03


@pytest.mark.parametrize("name", ["robot", "ellipsoid7x3", "ellipsoid15x5"])
def test_thick_sets_of_own_builds_agree(name, monkeypatch):
    """Each package's own f32 build of the same mesh: 0 thick-face flips
    (ROADMAP queue C counts them)."""
    if name == "robot":
        monkeypatch.setenv("CBTR_NATIVE", "0")
        port = scenes.robot_lens_scene(res=8).patches
        ref = jax_scenes.robot_lens_scene(res=8).patches
    else:
        sectors, belts = (7, 3) if name == "ellipsoid7x3" else (15, 5)
        port = build_from_trimesh(preprocess(make_ellipsoid(sectors, belts, AXES)))
        ref = jax_build(_jax_ellipsoid_mesh(sectors, belts))
    thick_p = _thick(_face_heights(port), port.control_points.numpy())
    thick_r = _thick(np.asarray(jax_face_heights(ref)), np.asarray(ref.control_points))
    assert thick_r.sum() > 0
    assert int((thick_p != thick_r).sum()) == 0


@pytest.mark.parametrize("steps,sectors,belts,divisor,expected,rtol", TABLE)
def test_measure_approximation_table(steps, sectors, belts, divisor, expected, rtol):
    err = measure_approximation(steps, sectors, belts, AXES, divisor)
    assert err == pytest.approx(expected, rel=rtol)


def test_dimpled_solid_matches_jax():
    port = make_dimpled_solid(21, 15, AXES)
    ref = jax_dimpled(21, 15, AXES)
    assert len(port) == len(ref) == 630
    np.testing.assert_array_equal(port.tris, ref.tris)


def test_unique_vertices_match_jax():
    mesh = preprocess(make_ellipsoid(7, 3, AXES))
    ref = JaxTriMesh(mesh.tris)
    got = TriMesh(mesh.tris).unique_vertices()
    np.testing.assert_array_equal(got, ref.unique_vertices())
    assert got.shape == (len(np.unique(mesh.tris.reshape(-1, 3), axis=0)), 3)
