"""The port's geometry kit (cbtr_tpu_torch/geom.py) against the reference
gtest suite, as tests/test_geom.py holds the JAX package's, and against the
JAX functions on seeded batches.

Every test of tests/test_geom.py has its counterpart here with the same
inputs and bars.  Each function the drivers and the debug path brought in
(perimeter, bary_to_cart, altitude, to_which_side, the plane and ray
helpers, spherical_from_cartesian, ray_sphere_hit) is then held against its
JAX twin on the same seeded f32 batch: allclose within 1e-6 (relative and
absolute; the two packages sum three terms in different orders), integer
and boolean results equal.  The one exception is the inclination of
spherical_from_cartesian, an arccos, which magnifies one ulp of its
argument by 1 / sin(inclination) (9.4 at 0.106, where the packages differ
by 1.1e-6): its cosine is held within 1e-6, and the angle itself within
1e-6 where sin(inclination) > 0.5.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cbtr_tpu import geom as jax_geom

from cbtr_tpu_torch import geom

EPS = 1e-4


def v(*xs):
    return torch.tensor(xs, dtype=torch.float32)


def assert_close(a, b, eps=EPS):
    assert float(geom.norm(torch.as_tensor(a) - torch.as_tensor(b))) < eps, (a, b)


# --- vector.getAperpendicular (googleTest.cpp:46-67) ---
@pytest.mark.parametrize(
    "vec",
    [
        (1.0, 0.0, 0.0),
        (1.0, 1.0, 0.0),
        (1.0, 0.0, 1.0),
        (1.0, -1.0, -1.0),
    ],
)
def test_a_perpendicular(vec):
    x = geom.safe_normalize(v(*vec))
    p = geom.a_perpendicular(x)
    assert abs(float(geom.dot(p, x))) < 1e-7
    assert abs(float(geom.norm(p)) - 1.0) < 1e-6


def test_a_perpendicular_batched():
    vs = geom.safe_normalize(torch.tensor(np.random.RandomState(0).randn(32, 3),
                                          dtype=torch.float32))
    p = geom.a_perpendicular(vs)
    assert float(geom.dot(p, vs).abs().max()) < 1e-6


# --- ray.averageErrorSquared (googleTest.cpp:69-85) ---
def test_ray_average_error_squared():
    start, direction = v(0, 0, 0), v(1, 0, 0)
    pts = torch.zeros((0, 3))
    assert float(geom.ray_average_error_squared(start, direction, pts)) == 0.0
    pts = torch.tensor([[2.0, 0, 0], [-3.0, 0, 0]])
    assert float(geom.ray_average_error_squared(start, direction, pts)) == 0.0
    pts = torch.tensor([[2.0, 1, 0], [-3.0, 0, 1]])
    assert float(geom.ray_average_error_squared(start, direction, pts)) > 0.0


# --- planeIntersection.Normals (googleTest.cpp:87-103) ---
def plane_from_normal_through(point, direction):
    n = geom.safe_normalize(v(*direction))
    return geom.make_plane(n, geom.dot(n, v(*point)))


@pytest.mark.parametrize(
    "common,d1,d2,d3",
    [
        ((1, 2, 3), (1, 2, 3), (3, 1, 2), (3, 2, 1)),
        ((3, -2, 1), (1, 0, 0), (0, 1, 0), (0, 0, 1)),
        ((3, -2, -1), (1, -2, 3), (-1, 2, 3), (1, 2, -3)),
    ],
)
def test_plane_intersection_normals(common, d1, d2, d3):
    p1 = plane_from_normal_through(common, d1)
    p2 = plane_from_normal_through(common, d2)
    p3 = plane_from_normal_through(common, d3)
    assert_close(geom.intersect_3planes(p1, p2, p3), v(*common))


# --- planeIntersection.Proportion (googleTest.cpp:105-141) ---
@pytest.mark.parametrize(
    "common,tr1,tr2,tr3",
    [
        ((0, 0, 0), (0.5, (1, 0, 0)), (0.5, (0, 1, 0)), (0.5, (0, 0, 1))),
        ((0, 0, 0), (0.5, (1, 0, 0)), (0.2, (0, 1, 0)), (0.1, (0, 0, 1))),
        ((-1, 2, 3), (0.1, (10, 10, 0)), (0.2, (0, 10, 10)), (0.3, (10, 0, 10))),
        ((-1, 2, 3), (0.1, (-10, 10, 0)), (0.2, (0, -10, 10)), (0.3, (10, 0, 10))),
        ((-1, 2, 3), (0.1, (10, 10, 0)), (0.2, (0, -10, 10)), (0.3, (-10, 0, 10))),
    ],
)
def test_plane_intersection_proportion(common, tr1, tr2, tr3):
    planes = []
    for prop, one in (tr1, tr2, tr3):
        one = v(*one)
        other = one + (v(*common) - one) / prop
        planes.append(geom.plane_from_proportion_2points(prop, one, other))
    assert_close(geom.intersect_3planes(*planes), v(*common))


# --- planeIntersection.Vertices (googleTest.cpp:143-174) ---
@pytest.mark.parametrize(
    "o1,o2,o3",
    [
        ((10, 0, 0), (0, 10, 0), (0, 0, 10)),
        ((-10, 0, 0), (0, 10, 0), (0, 0, 10)),
        ((-10, 0, 0), (0, -10, 0), (0, 0, 10)),
        ((-10, 0, 0), (0, -10, 0), (0, 0, -10)),
    ],
)
def test_plane_intersection_vertices(o1, o2, o3):
    common = v(1, 2, 3)
    p1 = geom.plane_from_3points(v(*o1), v(*o2), common)
    p2 = geom.plane_from_3points(v(*o2), v(*o3), common)
    p3 = geom.plane_from_3points(v(*o1), v(*o3), common)
    assert_close(geom.intersect_3planes(p1, p2, p3), common)


# --- planeIntersection.VectorPoints (googleTest.cpp:176-208) ---
@pytest.mark.parametrize(
    "sets",
    [
        (((10, 0, 0), (0, 1, 0)), ((0, 10, 0), (0, 0, 1)), ((0, 0, 10), (1, 0, 0))),
        (((10, 0, 0), (0, 1, 1)), ((0, 10, 0), (1, 0, -1)), ((0, 0, 10), (1, 1, 0))),
        (((10, 0, 0), (-4, 1, 1)), ((0, 10, 0), (1, -4, -1)), ((0, 0, 10), (1, 1, -4))),
    ],
)
def test_plane_intersection_vector_points(sets):
    common = v(1, 2, -3)
    planes = [
        geom.plane_from_1vector_2points(v(*d), v(*pt), common) for pt, d in sets
    ]
    assert_close(geom.intersect_3planes(*planes), common)


# --- planeIntersection.VectorsPoint (googleTest.cpp:210-235) ---
def test_plane_intersection_vectors_point():
    common = v(1, 2, -3)
    p1 = geom.plane_from_2vectors_1point(v(10, 1, 0), v(1, 10, 0), common)
    p2 = geom.plane_from_2vectors_1point(v(0, 10, 1), v(0, 1, 10), common)
    p3 = geom.plane_from_2vectors_1point(v(1, 0, 10), v(10, 0, 1), common)
    assert_close(geom.intersect_3planes(p1, p2, p3), common)


# --- planeIntersection.Ray (googleTest.cpp:237-265) ---
def test_plane_ray_intersect():
    plane = geom.plane_from_3points(v(10, 1, 2), v(11, 11.1, 2), v(12, 1.1, 4.4))
    valid, _, _, _ = geom.plane_ray_intersect(
        plane, v(1, 2, -3), geom.safe_normalize(v(1, 1, 1))
    )
    assert bool(valid)

    valid, _, _, dist = geom.plane_ray_intersect(
        plane, v(1, 2, -3), geom.safe_normalize(v(-1, 2, 3))
    )
    # ray points away; reference reports valid=false because distance < 0
    assert not bool(valid)
    assert float(dist) < 0.0

    plane = geom.plane_from_3points(v(10, 1, 2), v(10, 11.1, 2), v(10, 1.1, 4.4))
    valid, _, _, _ = geom.plane_ray_intersect(
        plane, v(1, 2, -3), geom.safe_normalize(v(0, 2, 0))
    )
    assert not bool(valid)

    plane = geom.plane_from_3points(v(10, 10, 2), v(0, 10, 2), v(10, 10, 10.4))
    valid, point, cos_inc, _ = geom.plane_ray_intersect(
        plane, v(1, 2, -3), geom.safe_normalize(v(0, 2, 0))
    )
    assert bool(valid)
    assert_close(point, v(1, 10, -3), 1e-4)
    assert abs(float(cos_inc)) > 0.9999


# --- planeProjection.Point (googleTest.cpp:267-298) ---
@pytest.mark.parametrize(
    "point,tri,expected",
    [
        ((0, 0, 0), ((2, 0, 0), (0, 2, 0), (0, 0, 2)), (0.666666, 0.666666, 0.666666)),
        ((0, 0, 0), ((2, 0, 0), (2, 1, 0), (2, 0, 1)), (2, 0, 0)),
        ((1, 2, 3), ((3, 2, 3), (1, 4, 3), (1, 2, 5)), (1.666666, 2.666666, 3.666666)),
        ((-1, -2, 3), ((1, -2, 3), (1, -3, 3), (1, -2, 4)), (1, -2, 3)),
        (
            (1.666666, 2.666666, 3.666666),
            ((3, 2, 3), (1, 4, 3), (1, 2, 5)),
            (1.666666, 2.666666, 3.666666),
        ),
    ],
)
def test_plane_project(point, tri, expected):
    plane = geom.plane_from_3points(v(*tri[0]), v(*tri[1]), v(*tri[2]))
    assert_close(geom.plane_project(plane, v(*point)), v(*expected))


# --- planeDistance.Point (googleTest.cpp:300-331) ---
@pytest.mark.parametrize(
    "point,tri,expected",
    [
        ((0, 0, 0), ((2, 0, 0), (0, 2, 0), (0, 0, 2)), 1.15468),
        ((0, 0, 0), ((2, 0, 0), (2, 1, 0), (2, 0, 1)), 2.0),
        ((1, 2, 3), ((3, 2, 3), (1, 4, 3), (1, 2, 5)), 1.15468),
        ((-1, -2, 3), ((1, -2, 3), (1, -3, 3), (1, -2, 4)), 2.0),
        ((1.666666, 2.666666, 3.666666), ((3, 2, 3), (1, 4, 3), (1, 2, 5)), 0.0),
    ],
)
def test_plane_distance(point, tri, expected):
    plane = geom.plane_from_3points(v(*tri[0]), v(*tri[1]), v(*tri[2]))
    assert abs(abs(float(geom.plane_distance(plane, v(*point)))) - expected) < EPS


# --- toWhichSide.Points (googleTest.cpp:333-353) ---
def test_to_which_side():
    t0, t1, t2 = v(3, 2, 5), v(1, 4, 5), v(6, 5, 5)
    start = (t0 + t1 + t2) / 3.0
    conv = geom.barycentric_inverse(t0, t1, t2)
    for direction, expected in [
        ((1, 0, 0), 2),
        ((0, 1, 0), 1),
        ((-1, -1, 0), 0),
    ]:
        end = start + v(*direction)
        got = int(
            geom.to_which_side(geom.apply_mat3(conv, start), geom.apply_mat3(conv, end))
        )
        assert got == expected, (direction, got, expected)


# --- extras: inverse + subdivision invariants ---
def test_inv3x3_matches_numpy():
    rng = np.random.RandomState(1)
    m = rng.randn(64, 3, 3).astype(np.float32)
    ours = geom.inv3x3(torch.tensor(m)).numpy()
    ref = np.linalg.inv(m)
    assert np.allclose(ours, ref, atol=1e-3, rtol=1e-3)


def test_barycentric_inverse_roundtrip():
    t0, t1, t2 = v(3, 2, 5), v(1, 4, 5), v(6, 5, 5)
    conv = geom.barycentric_inverse(t0, t1, t2)
    for b in [(1, 0, 0), (0, 1, 0), (0, 0, 1), (0.2, 0.3, 0.5)]:
        p = geom.bary_to_cart(t0, t1, t2, v(*b))
        assert_close(geom.apply_mat3(conv, p), v(*b))


def test_subdivision_barycentrics():
    for d in (1, 2, 3, 5):
        tris = geom.subdivision_barycentrics(d)
        assert tris.shape == (d * d, 3, 3)
        assert np.allclose(tris.sum(axis=-1), 1.0, atol=1e-6)
        np.testing.assert_array_equal(tris, jax_geom.subdivision_barycentrics(d))
    # divisor 1 reproduces the original triangle exactly
    t1 = geom.subdivision_barycentrics(1)
    assert np.allclose(t1[0], np.eye(3, dtype=np.float32))


def test_divide_triangle_covers_area():
    tri = np.asarray([[0, 0, 0], [2, 0, 0], [0, 2, 0]], np.float32)
    for d in (1, 2, 4):
        subs = geom.divide_triangle_np(tri, d)
        np.testing.assert_array_equal(subs, jax_geom.divide_triangle_np(tri, d))
        areas = 0.5 * np.linalg.norm(
            np.cross(subs[:, 1] - subs[:, 0], subs[:, 2] - subs[:, 0]), axis=-1
        )
        assert abs(areas.sum() - 2.0) < 1e-5
        # orientation preserved for every sub-triangle
        normals = np.cross(subs[:, 1] - subs[:, 0], subs[:, 2] - subs[:, 0])
        assert (normals[:, 2] > 0).all()


def test_ritter_sphere_and_ray_hit():
    rng = np.random.RandomState(2)
    pts = rng.randn(100, 3).astype(np.float32)
    center, radius = geom.ritter_bounding_sphere(pts)
    dists = np.linalg.norm(pts - center, axis=1)
    assert (dists <= radius + 1e-4).all()
    ref_center, ref_radius = jax_geom.ritter_bounding_sphere(pts)
    np.testing.assert_array_equal(center, ref_center)
    assert radius == ref_radius
    # a ray through the center hits; a faraway parallel one misses
    c = torch.tensor(center)
    hit = geom.ray_sphere_hit(c + torch.tensor([10.0, 0, 0]), v(-1, 0, 0), c, radius)
    assert bool(hit)
    miss = geom.ray_sphere_hit(c + torch.tensor([10.0, 10 * float(radius), 0]),
                               v(-1, 0, 0), c, radius)
    assert not bool(miss)


# ---------------------------------------------------------------------------
# each ported function against its JAX twin on a seeded batch
# ---------------------------------------------------------------------------

N = 256


def _batch(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(N,) + s).astype(np.float32) for s in shapes]


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _planes(seed):
    (p0, p1, p2) = _batch(seed, (3,), (3,), (3,))
    return np.asarray(jax_geom.plane_from_3points(jnp.asarray(p0), jnp.asarray(p1),
                                                  jnp.asarray(p2)))


def _cases():
    (tri,) = _batch(10, (3, 3))
    (b,) = _batch(11, (3,))
    c1, c2, ind = _batch(12, (3,), (3,), (3,))
    d0, d1, p = _batch(13, (3,), (3,), (3,))
    start, direction, point = _batch(14, (3,), (3,), (3,))
    direction = _unit(direction)
    (cloud,) = _batch(15, (7, 3))
    # barycentric segments starting inside the unit triangle, ending anywhere
    rng = np.random.default_rng(16)
    s_in = rng.dirichlet((1.0, 1.0, 1.0), size=N).astype(np.float32)
    e_any = (s_in + 2.0 * rng.normal(size=(N, 3))).astype(np.float32)
    center, radius = _batch(17, (3,), ())
    radius = np.abs(radius).astype(np.float32)
    return {
        "perimeter": ((tri,), {}),
        "bary_to_cart": ((tri[:, 0], tri[:, 1], tri[:, 2], b), {}),
        "altitude": ((c1, c2, ind), {}),
        "to_which_side": ((s_in, e_any), {}),
        "plane_from_triangle": ((tri,), {}),
        "plane_from_2vectors_1point": ((d0, d1, p), {}),
        "plane_project": ((_planes(18), point), {}),
        "ray_perpendicular_to": ((start, direction, point), {}),
        "ray_point_distance": ((start, direction, point), {}),
        "ray_point_distance2": ((start, direction, point), {}),
        "ray_average_error_squared": ((start, direction, cloud), {}),
        "spherical_from_cartesian": ((point,), {}),
        "ray_sphere_hit": ((start, direction, center, radius), {}),
    }


CASES = _cases()


@pytest.mark.parametrize("name", list(CASES))
def test_function_matches_jax(name):
    args, _ = CASES[name]
    got = getattr(geom, name)(*(torch.tensor(a) for a in args))
    want = getattr(jax_geom, name)(*(jnp.asarray(a) for a in args))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        g, w = g.numpy(), np.asarray(w)
        if name == "spherical_from_cartesian" and k == 2:
            np.testing.assert_allclose(np.cos(g), np.cos(w), rtol=1e-6, atol=1e-6)
            steep = np.sin(w) > 0.5
            assert steep.mean() > 0.5
            g, w = g[steep], w[steep]
        assert g.shape == w.shape, (g.shape, w.shape)
        if w.dtype.kind in "biu":
            assert g.dtype.kind == w.dtype.kind
            np.testing.assert_array_equal(g, w)
        else:
            assert g.dtype == w.dtype == np.float32
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    if name == "to_which_side":
        # every exit side and the no-exit answer occur in the batch
        assert set(np.unique(got[0].numpy())) == {0, 1, 2, 3}
    if name == "ray_sphere_hit":
        assert 0 < got[0].sum() < N
