"""The port's drivers and visualizers (cbtr_tpu_torch/harness/drivers.py,
visual.py) against tests/test_drivers.py's assertions and against the JAX
package's drivers on the same inputs.

The seven tests of tests/test_drivers.py run here on the port with the
same inputs and bars (patches on the CPU).  Then each driver is held
against its JAX twin: both packages preprocess on the native runtime by
default, so the round-tripped, split and refined meshes are equal arrays;
the thick-patch counts are equal; `followers_report` on the same patch
tables (the JAX package's, handed over as NumPy) gives the same (patch,
side, neighbour) triples for every ray, where the port sweeps through K3's
plain twin (culled) and the JAX package through `sweep_codes_xla`
(unculled); the visualizers are allclose within 1e-6.
"""
import numpy as np
import pytest
import torch

from cbtr_tpu.harness import drivers as jax_drivers
from cbtr_tpu.harness import visual as jax_visual
from cbtr_tpu.harness.measure import preprocess as jax_preprocess
from cbtr_tpu.mesh.core import TriMesh as JaxTriMesh
from cbtr_tpu.models import scenes as jax_scenes

from cbtr_tpu_torch.convert import patches_from_numpy
from cbtr_tpu_torch.harness import visual
from cbtr_tpu_torch.harness.drivers import (
    bezier2plane_driver,
    control_point_markers,
    custom_stl_driver,
    dump_control_points,
    follow_triples,
    followers_report,
    split_divisor_driver,
    split_maxside_driver,
    split_tall_driver,
)
from cbtr_tpu_torch.harness.measure import preprocess
from cbtr_tpu_torch.mesh.core import TriMesh
from cbtr_tpu_torch.models import robot_lens_scene, sphere_lens_scene
from cbtr_tpu_torch.models.scenes import robot_stl_path
from cbtr_tpu_torch.ops import WHAT_INTERSECT, intersect_rays

torch.set_num_threads(2)
ROBOT = robot_stl_path()


def test_split_divisor_roundtrip(tmp_path):
    """testDequeDivisor: divisor-split multiplies faces by divisor^2, stays
    on the sphere, and the visualizations are non-empty."""
    r = split_divisor_driver("deque", 7, 3, 2.0, 3, out_dir=str(tmp_path))
    assert len(r.roundtripped) == len(r.original) * 9
    radii = np.linalg.norm(r.roundtripped.tris.reshape(-1, 3), axis=-1)
    # split points of flat triangles lie ON the chords — inside the sphere
    assert radii.max() <= 2.0 * (1 + 1e-4)
    assert radii.min() >= 2.0 * 0.5
    assert len(r.normals_vis) > 0 and len(r.vertex_normals_vis) > 0
    # outward orientation survived the round trip: face normals point away
    tris = r.roundtripped.tris
    n = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    c = tris.mean(axis=1)
    assert (np.einsum("fi,fi->f", n, c) > 0).all()
    for stem in ("test_deque", "back_test_deque", "norm_test_deque",
                 "vertexNorm_test_deque"):
        assert (tmp_path / f"{stem}.stl").stat().st_size > 0


def test_split_maxside_roundtrip(tmp_path):
    """testVectorMax: every emitted side obeys the max-side bound."""
    max_side = 0.7
    r = split_maxside_driver("vmax", 7, 3, 2.0, max_side, out_dir=str(tmp_path))
    tris = r.roundtripped.tris
    sides = np.stack([
        np.linalg.norm(tris[:, 0] - tris[:, 1], axis=-1),
        np.linalg.norm(tris[:, 1] - tris[:, 2], axis=-1),
        np.linalg.norm(tris[:, 2] - tris[:, 0], axis=-1),
    ])
    assert sides.max() <= max_side * (1 + 1e-4)
    assert len(r.roundtripped) > len(r.original)


def test_bezier2plane_and_control_dump(tmp_path):
    """testBezier2plane: the tessellation has P*div^2 triangles hugging the
    sphere better than the flat mesh; the control-point dump has P*10 points
    within the bounding shell."""
    radius, div = 2.0, 3
    r = bezier2plane_driver(9, 4, radius, div, out_dir=str(tmp_path), device="cpu")
    P = len(r.original) * 3
    assert len(r.planified) == P * div * div
    assert r.control_points.shape == (P * 10, 3)

    # Bezier tessellation points hug the sphere (sub-percent worst case,
    # vs the flat mesh whose mid-chord sag at sectors=9/belts=4 is ~6%)
    vr = np.linalg.norm(r.planified.tris.reshape(-1, 3), axis=-1)
    chord_mid = r.original.tris.mean(axis=1)
    flat_sag = np.abs(np.linalg.norm(chord_mid, axis=-1) - radius).max()
    assert np.abs(vr - radius).max() < flat_sag / 2
    assert np.abs(vr / radius - 1.0).mean() < 5e-3
    cr = np.linalg.norm(r.control_points, axis=-1)
    assert cr.max() < radius * 1.1 and cr.min() > radius * 0.8

    markers = control_point_markers(
        sphere_lens_scene(res=4, sectors=5, belts=2, device="cpu").patches, 0.01
    )
    assert len(markers) > 0


def test_split_tall_refines_thick_patches(tmp_path):
    """testBezierSplitTall: a coarse tall ellipsoid must trigger thick
    splits in round 1, produce more faces, and strictly reduce the max
    height ratio in round 2."""
    r = split_tall_driver(7, 3, (1.0, 4.0, 2.0), out_dir=str(tmp_path), device="cpu")
    assert r.num_thick1 > 0
    assert len(r.split1) > len(r.original)
    # refinement converges: round 2 finds at most as many thick faces
    assert r.num_thick2 <= r.num_thick1


@pytest.fixture(scope="module")
def robot_driver(tmp_path_factory):
    out = tmp_path_factory.mktemp("robot")
    return out, custom_stl_driver(ROBOT, 2, refine=True, out_dir=str(out), device="cpu")


def test_custom_stl_robot_with_refinement(robot_driver):
    """testCustomStl on robot.stl + the refinement pass the reference never
    ran on it: the refined surface must still be a closed, orientable mesh
    that preprocesses cleanly and intersects rays."""
    out, r = robot_driver
    assert r.patches.num_patches == 450
    assert len(r.planified) == 450 * 4
    assert r.num_thick > 0, "robot.stl has thick patches; refinement must act"
    assert r.refined_patches is not None
    assert r.refined_patches.num_patches > r.patches.num_patches
    assert torch.isfinite(r.refined_patches.control_points).all()
    # the dumped STLs read back as the meshes they were written from (ASCII:
    # the reference's 6 significant digits, 5e-6 relative)
    back = TriMesh().read(str(out / "refined_robot.stl"))
    np.testing.assert_allclose(back.tris, r.refined_mesh.tris, rtol=5e-6, atol=1e-6)


def test_refined_robot_scene_traces_rays():
    """robot_lens_scene(refine=True) end-to-end: the refined lens still
    intersects a healthy fraction of a centered beam."""
    scene = robot_lens_scene(res=8, refine=True, device="cpu")
    assert scene.patches.num_patches > 450  # refinement actually split
    hit = intersect_rays(scene.patches, scene.start, scene.direction)
    frac = (hit.what == WHAT_INTERSECT).double().mean()
    # the robot silhouette covers ~19% of the 1.8-wide beam unrefined;
    # refinement must not lose coverage
    assert frac >= 0.15, f"refined robot lens hit rate {frac}"
    assert torch.isfinite(hit.point).all()


def test_followers_report():
    """visualizeFollowers: rays near patch seams produce follow-side
    candidates; the report must name valid (patch, side, neighbour) triples."""
    scene = sphere_lens_scene(res=12, sectors=9, belts=4, device="cpu")
    rep = followers_report(scene.patches, scene.start, scene.direction)
    assert rep["total_follow_candidates"] > 0
    P = scene.patches.num_patches
    nb = scene.patches.neighbours.numpy()
    for lst in rep["followers"]:
        for patch, side, neighbour in lst:
            assert 0 <= patch < P and 0 <= side < 3
            assert neighbour == nb[patch, side]
    assert len(rep["followers"]) == scene.start.shape[0]
    assert rep["rays_with_followers"] == sum(1 for lst in rep["followers"] if lst)


# ---------------------------------------------------------------------------
# against the JAX drivers on the same inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["divisor", "maxside"])
@pytest.mark.parametrize("binary", [True, False])
def test_split_roundtrips_match_jax(tmp_path, kind, binary):
    """The round-tripped, split and re-preprocessed spheres are equal arrays;
    the normals visualizations allclose."""
    args = ("rt", 7, 3, 2.0, 3 if kind == "divisor" else 0.7)
    port_fn, jax_fn = {
        "divisor": (split_divisor_driver, jax_drivers.split_divisor_driver),
        "maxside": (split_maxside_driver, jax_drivers.split_maxside_driver),
    }[kind]
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = port_fn(*args, out_dir=str(tmp_path / "port"), binary=binary)
    want = jax_fn(*args, out_dir=str(tmp_path / "jax"), binary=binary)
    np.testing.assert_array_equal(got.original.tris, want.original.tris)
    np.testing.assert_array_equal(got.roundtripped.tris, want.roundtripped.tris)
    np.testing.assert_array_equal(got.roundtripped.fellow_triangles,
                                  want.roundtripped.fellow_triangles)
    for a, b in ((got.normals_vis, want.normals_vis),
                 (got.vertex_normals_vis, want.vertex_normals_vis)):
        np.testing.assert_allclose(a.tris, b.tris, rtol=1e-6, atol=1e-6)
    for name in sorted(p.name for p in (tmp_path / "jax").iterdir()):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_split_tall_and_bezier2plane_match_jax(tmp_path):
    got = split_tall_driver(7, 3, (1.0, 4.0, 2.0), device="cpu")
    want = jax_drivers.split_tall_driver(7, 3, (1.0, 4.0, 2.0))
    assert (got.num_thick1, got.num_thick2) == (want.num_thick1, want.num_thick2)
    np.testing.assert_array_equal(got.original.tris, want.original.tris)
    assert len(got.split1) == len(want.split1) and len(got.split2) == len(want.split2)
    b_got = bezier2plane_driver(9, 4, 2.0, 3, device="cpu")
    b_want = jax_drivers.bezier2plane_driver(9, 4, 2.0, 3)
    np.testing.assert_array_equal(b_got.original.tris, b_want.original.tris)
    # the f32 patch tables of torch and XLA differ by rounding
    np.testing.assert_allclose(b_got.control_points, b_want.control_points,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(b_got.planified.tris, b_want.planified.tris,
                               rtol=1e-5, atol=1e-5)


def test_custom_stl_matches_jax(robot_driver):
    _, got = robot_driver
    want = jax_drivers.custom_stl_driver(ROBOT, 2, refine=True)
    np.testing.assert_array_equal(got.mesh.tris, want.mesh.tris)
    assert got.num_thick == want.num_thick
    assert got.refined_patches.num_patches == want.refined_patches.num_patches == 1800
    np.testing.assert_array_equal(got.refined_mesh.fellow_triangles,
                                  want.refined_mesh.fellow_triangles)
    assert dump_control_points(got.patches).shape == (4500, 3)


def test_followers_report_matches_jax():
    """The sphere 12^2 of test_drivers.py on the JAX package's patch tables:
    the same triples for every ray, and the totals."""
    scene = jax_scenes.sphere_lens_scene(res=12, sectors=9, belts=4)
    port = patches_from_numpy({k: np.asarray(v) for k, v in scene.patches._asdict().items()},
                              device="cpu")
    start, direction = np.array(scene.start), np.array(scene.direction)
    got = followers_report(port, start, direction)
    want = jax_drivers.followers_report(scene.patches, start, direction)
    assert got["total_follow_candidates"] == want["total_follow_candidates"] > 0
    assert got["rays_with_followers"] == want["rays_with_followers"]
    assert got["followers"] == want["followers"]
    triples = got["triples"]
    assert triples.shape == (want["total_follow_candidates"], 4)
    assert (np.diff(triples[:, 0]) >= 0).all()


def test_follow_triples_of_any_layout():
    """K3's wrapper returns a transposed [R, P] view on the card: the
    triples read the logical layout, not the storage order."""
    rng = np.random.default_rng(5)
    code = torch.tensor(rng.integers(0, 16, size=(40, 30)), dtype=torch.int32)
    nb = torch.tensor(rng.integers(0, 30, size=(30, 3)), dtype=torch.int32)
    want = follow_triples(code, nb)
    got = follow_triples(code.T.contiguous().T, nb)
    np.testing.assert_array_equal(got, want)
    what_on = np.where(code.numpy() >> 3 > 0, code.numpy() & 7, 3)
    rays, pids = np.nonzero(what_on < 3)
    np.testing.assert_array_equal(want[:, :2], np.stack([rays, pids], 1))
    np.testing.assert_array_equal(want[:, 3], nb.numpy()[pids, want[:, 2]])


def test_visualizers_match_jax():
    port = preprocess(TriMesh().read(ROBOT))
    ref = jax_preprocess(JaxTriMesh().read(ROBOT))
    for name in ("visualize_normals", "visualize_vertex_normals"):
        a = getattr(visual, name)(port).tris
        b = getattr(jax_visual, name)(ref).tris
        assert a.shape == b.shape and a.shape[0] > 0, name
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6, err_msg=name)
    for start, direction in (((0.0, 0.0, 0.0), (1.0, 0.2, -0.1)),
                             ((1.0, -2.0, 0.5), (0.0, 0.0, 1.0))):
        a = visual.visualize_ray(start, direction, 3.0).tris
        b = jax_visual.visualize_ray(start, direction, 3.0).tris
        assert a.shape == (8, 3, 3)
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
