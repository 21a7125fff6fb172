"""Mesh-vertex lens design (cbtr_tpu_torch/models/design.py) against the
JAX package's models/design.py.

Both packages take the same preprocessed mesh (the port's TriMesh: the JAX
`topology_from_mesh` reads only its tris and fellow tables), so the welded
vertices and the topology are the same arrays.  Counterpart of
tests/test_design.py:19-78 (its slow trajectory test runs the JAX artifact
script; here a two-stage fit runs in both packages).
"""
import inspect
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cbtr_tpu.models import design as jax_design

from cbtr_tpu_torch.bezier import build_from_trimesh
from cbtr_tpu_torch.bezier.build import build_patches
from cbtr_tpu_torch.harness import preprocess
from cbtr_tpu_torch.mesh.core import make_unit_sphere
from cbtr_tpu_torch.models import design
from cbtr_tpu_torch.models.scenes import LENS_CENTER

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOAT_LEAVES = ("control_points", "underlying", "dividers", "bary_inverse", "heights",
                "deriv_b")


@pytest.fixture(scope="module")
def sphere():
    """The JAX test's sphere 7 x 3 (23 vertices, 126 patches)."""
    mesh = preprocess(make_unit_sphere(7, 3))
    return (mesh, *design.topology_from_mesh(mesh, device="cpu"),
            *jax_design.topology_from_mesh(mesh))


@pytest.fixture(scope="module")
def lens():
    """The JAX gradient test's setup: sphere 5 x 2 at LENS_CENTER, 256 rays
    from the origin spread 0.1 around +x (seed 3), 8^2 image."""
    mesh = preprocess(make_unit_sphere(5, 2))
    mesh.translate(LENS_CENTER)
    mesh = preprocess(mesh)
    rng = np.random.default_rng(3)
    n = 256
    d = np.stack([np.ones(n), 0.1 * rng.normal(size=n), 0.1 * rng.normal(size=n)], -1)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return mesh, np.zeros((n, 3), np.float32), d, np.asarray([1.0, 0.0, 0.0, 10.0],
                                                             np.float32)


def test_topology_matches_jax(sphere):
    """The same welded vertices and face table; each corner once in the
    vertex-corner table, ascending in its row."""
    _, topo, params, topo_j, params_j = sphere
    np.testing.assert_array_equal(params.vertices.detach().numpy(),
                                  np.asarray(params_j.vertices))
    for name in ("face2vertex", "fellow", "fellow_starts"):
        assert getattr(topo, name).dtype == torch.int64
        np.testing.assert_array_equal(getattr(topo, name).numpy(),
                                      np.asarray(getattr(topo_j, name)))
    table = topo.vertex_corners.numpy()
    n_corners = topo.face2vertex.numel()
    real = table[table < n_corners]
    np.testing.assert_array_equal(np.sort(real), np.arange(n_corners))
    for v, row in enumerate(table):
        row = row[row < n_corners]
        assert (np.diff(row) > 0).all()
        assert (topo.face2vertex.reshape(-1)[row] == v).all()


def test_patches_from_vertices_matches_jax_and_host_build(sphere):
    """Every field within 2e-5 of the JAX rebuild and of the host build
    `build_from_trimesh` (the JAX test's atol; measured 2.4e-6 at most, in
    bary_inverse), neighbours equal; two calls bit-equal."""
    mesh, topo, params, topo_j, params_j = sphere
    got = design.patches_from_vertices(params, topo)
    again = design.patches_from_vertices(params, topo)
    want = jax_design.patches_from_vertices(params_j, topo_j)
    host = build_from_trimesh(mesh, device="cpu")
    for name, leaf in got.leaves().items():
        assert torch.equal(leaf, getattr(again, name)), name
        for ref in (np.asarray(getattr(want, name)), getattr(host, name).numpy()):
            if name == "neighbours":
                np.testing.assert_array_equal(leaf.numpy(), ref)
            else:
                np.testing.assert_allclose(leaf.detach().numpy(), ref, rtol=0, atol=2e-5,
                                           err_msg=name)


def test_corner_average_normals_match_jax(sphere):
    """Within 1e-6 of the JAX function (segment_sum against the port's
    in-order gather; measured 1.2e-7)."""
    _, topo, params, topo_j, params_j = sphere
    got = design.corner_average_normals(params.vertices[topo.face2vertex],
                                        topo.face2vertex, topo.vertex_corners)
    want = jax_design.corner_average_normals(params_j.vertices[topo_j.face2vertex],
                                             topo_j.face2vertex, params_j.vertices.shape[0])
    assert got.shape == (topo.face2vertex.shape[0], 3, 3)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-6)


_JAX_F64_GRAD = r"""
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
from cbtr_tpu.models import design

a = np.load(sys.argv[1])
topo = design.DesignTopology(*(jnp.asarray(a[k]) for k in
                               ("face2vertex", "fellow", "fellow_starts")))


def probe(v):
    patches = design.patches_from_vertices(design.DesignParams(v, jnp.float64(1.3)), topo)
    return sum(jnp.sum(getattr(patches, k) * a["w_" + k]) for k in a["leaves"])


np.save(sys.argv[2], np.asarray(jax.grad(probe)(jnp.asarray(a["vertices"]))))
"""


def test_build_gradient_to_vertices_matches_jax_f64(sphere, tmp_path):
    """d/d(vertices) of a random weighting of every float leaf, through the
    corner normals and `build_patches`, against jax.grad of the JAX
    rebuild.  In float64 (JAX in x64 mode, in a fresh process): the
    three-plane intersections make the f32 gradient ill-conditioned (1.5e-3
    of max |g| apart in f32); in float64 within 1e-9 of max |g|."""
    _, topo, params, topo_j, _ = sphere
    rng = np.random.default_rng(0)
    shapes = {k: v.shape for k, v in design.patches_from_vertices(params, topo).leaves().items()}
    weights = {k: rng.normal(size=shapes[k]) for k in FLOAT_LEAVES}
    vertices = params.vertices.detach().numpy().astype(np.float64)
    arrays = tmp_path / "in.npz"
    np.savez(arrays, vertices=vertices, leaves=np.asarray(FLOAT_LEAVES),
             **{k: np.asarray(getattr(topo_j, k)) for k in ("face2vertex", "fellow",
                                                            "fellow_starts")},
             **{"w_" + k: w for k, w in weights.items()})
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", _JAX_F64_GRAD, str(arrays),
                           str(tmp_path / "grad.npy")], capture_output=True, text=True,
                          timeout=300, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = np.load(tmp_path / "grad.npy")
    assert want.dtype == np.float64

    v = torch.tensor(vertices, requires_grad=True)
    tris = v[topo.face2vertex]
    navg = design.corner_average_normals(tris, topo.face2vertex, topo.vertex_corners)
    patches = build_patches(tris, topo.fellow, topo.fellow_starts, navg, dtype=torch.float64)
    sum((getattr(patches, k) * torch.tensor(w)).sum() for k, w in weights.items()).backward()
    assert np.abs(want).max() > 1.0
    np.testing.assert_allclose(v.grad.numpy(), want, rtol=0, atol=1e-9 * np.abs(want).max())


def _port_loss(lens, target):
    mesh, s, d, screen = lens
    topo, params = design.topology_from_mesh(mesh, device="cpu")
    loss, img = design.design_loss(params, topo, torch.tensor(s), torch.tensor(d),
                                   torch.tensor(screen), torch.tensor(target), resolution=8)
    return loss, img, params


def _both_losses(lens, target):
    mesh, s, d, screen = lens
    loss, img, params = _port_loss(lens, target)
    loss.backward()
    topo_j, params_j = jax_design.topology_from_mesh(mesh)
    (loss_j, img_j), grads_j = jax.jit(jax.value_and_grad(
        lambda p: jax_design.design_loss(p, topo_j, jnp.asarray(s), jnp.asarray(d),
                                         jnp.asarray(screen), jnp.asarray(target),
                                         resolution=8), has_aux=True))(params_j)
    return (loss.detach(), img.detach(), params), (loss_j, img_j, grads_j)


def test_design_loss_and_gradients_match_jax(lens):
    """The JAX gradient test's setup (uniform target): loss within 1e-5
    relative (measured 9e-8), image within 1e-3 (4.2e-4: rays whose splat
    weights move with the last bits of a hit point), the refractive-index
    gradient within 1e-5 relative (7.6e-7), the vertex gradient within
    2e-4 of its max |g| (3.0e-5); every gradient finite and nonzero."""
    (loss, img, params), (loss_j, img_j, grads_j) = _both_losses(
        lens, np.ones((8, 8), np.float32))
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(img_j), rtol=0, atol=1e-3)
    g, g_j = params.vertices.grad.numpy(), np.asarray(grads_j.vertices)
    assert np.isfinite(g).all() and np.abs(g).max() > 0
    np.testing.assert_allclose(g, g_j, rtol=0, atol=2e-4 * np.abs(g_j).max())
    np.testing.assert_allclose(float(params.refractive_index.grad),
                               float(grads_j.refractive_index), rtol=1e-5)


@pytest.mark.parametrize("n", [3, 800])
def test_learning_rate_schedule_matches_optax(n):
    """The rate Adam applies at updates 0, 1 and n-1 (LambdaLR stepped after
    each update) against optax.cosine_decay_schedule(peak, n): step 0 at the
    peak; within 1e-6 relative, or 1e-6 of the peak near 0, where optax's
    f32 cosine is 2.8e-3 off the f64 one at step 799 of 800."""
    peak = 5e-4
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.Adam([p], lr=peak)
    schedule = torch.optim.lr_scheduler.LambdaLR(opt, design.cosine_decay(n))
    rates = []
    for _ in range(n):
        rates.append(opt.param_groups[0]["lr"])
        opt.step()
        schedule.step()
    want = optax.cosine_decay_schedule(peak, n)
    assert rates[0] == peak
    for t in (0, 1, n - 1):
        np.testing.assert_allclose(rates[t], float(want(t)), rtol=1e-6, atol=1e-6 * peak)
    with pytest.raises(ValueError):
        design.cosine_decay(0)


def test_staged_fit_matches_jax(lens):
    """fit_design with stages [(2e-3, 3), (5e-4, 3)] in both packages from
    the same mesh: losses within 1e-4 relative (measured 4.1e-6), the same
    best step, and best vertices within 1e-5 (4.8e-7).  The best parameters
    are those after the best step's update (the reference's bookkeeping),
    so they differ from every iterate whose loss was taken."""
    mesh, s, d, screen = lens
    _, img, _ = _port_loss(lens, np.ones((8, 8), np.float32))
    target = np.full((8, 8), float(img.detach().sum()) / 64, np.float32)
    stages = [(2e-3, 3), (5e-4, 3)]
    seen = []
    best, topo, losses = design.fit_design(
        mesh, target, torch.tensor(s), torch.tensor(d), torch.tensor(screen), stages=stages,
        resolution=8, on_step=lambda i, l: seen.append((i, l)), device="cpu")
    best_j, _, losses_j = jax_design.fit_design(
        mesh, jnp.asarray(target), jnp.asarray(s), jnp.asarray(d), jnp.asarray(screen),
        stages=stages, resolution=8)
    assert seen == list(enumerate(losses)) and len(losses) == 6
    np.testing.assert_allclose(losses, losses_j, rtol=1e-4)
    assert int(np.argmin(losses)) == int(np.argmin(losses_j))
    np.testing.assert_allclose(best.vertices.detach().numpy(), np.asarray(best_j.vertices),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(best.refractive_index.item(), float(best_j.refractive_index),
                               rtol=1e-6)
    assert isinstance(best, design.DesignParams) and topo.face2vertex.shape[1] == 3


def test_nonfinite_design_loss_raises(lens):
    mesh, s, d, screen = lens
    with pytest.raises(FloatingPointError, match="step 0"):
        design.fit_design(mesh, np.full((8, 8), np.nan, np.float32), torch.tensor(s),
                          torch.tensor(d), torch.tensor(screen), steps=2, resolution=8,
                          device="cpu")


@pytest.mark.parametrize("fn", [design.topology_from_mesh, design.fit_design])
def test_design_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"
