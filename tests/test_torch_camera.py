"""Ray grids and the surface-normal render against the JAX package.

`angle_sweep_rays`, `pinhole_ray_grid` and the host `ortho_ray_grid` are
NumPy in both packages: arrays equal.  `OrthoGrid.rays_at` repeats the host
grid's f32 operations one torch op at a time: bit-equal to the host grid,
tiled and row-major (tests/test_render.py's bar for the JAX OrthoGrid).
`render_surface_normals` goes through the port's winner search (K1's plain
twin on the CPU) and the recompute: hit mask equal to the JAX package's run
op by op (`jax.disable_jit()`; jitted XLA rounds the unconverged Newton
iterations otherwise, up to 1e-3 in shade on 22 of 576 sphere rays, ROADMAP
queue C), shade and depth allclose 1e-5.
"""
import jax
import numpy as np
import pytest
import torch

from cbtr_tpu.models import scenes as jax_scenes
from cbtr_tpu.render import camera as jax_camera
from cbtr_tpu.render import render as jax_render

from cbtr_tpu_torch.convert import patches_from_numpy
from cbtr_tpu_torch.models import scenes, sphere_lens_scene
from cbtr_tpu_torch.render import camera, render

torch.set_num_threads(2)

GRID_SPECS = [
    ((0, 0, 0), (1, 0, 0), (0, 0, 1), 2.0, 1.5, 32, 16),
    ((0.3, -0.2, 0.1), (1, 0.2, -0.1), (0, 0.3, 1), 1.7, 2.3, 48, 24),
    ((0, 0, 0), (1, 0, 0), (0, 0, 1), 1.8, 1.8, 37, 11),
]


# the 16x8 layout needs res_x % 16 == 0 and res_y % 8 == 0: not spec 2
@pytest.mark.parametrize("spec,tiled", [(0, True), (0, False), (0, None), (1, True),
                                        (1, False), (2, False), (2, None)])
def test_ortho_grid_bit_equal_host_grid(spec, tiled):
    args = GRID_SPECS[spec]
    res_x, res_y = args[5:]
    s_host, d_host = camera.ortho_ray_grid(*args, tiled=tiled)
    s_jax, d_jax = jax_camera.ortho_ray_grid(*args, tiled=tiled)
    np.testing.assert_array_equal(s_host, s_jax)
    np.testing.assert_array_equal(d_host, d_jax)
    grid = camera.OrthoGrid(*args, tiled=tiled)
    s, d = grid.rays_at(torch.arange(grid.n_rays, dtype=torch.int32))
    assert s.dtype == d.dtype == torch.float32 and s.shape == (res_x * res_y, 3)
    assert torch.equal(s, torch.from_numpy(s_host))
    assert torch.equal(d, torch.from_numpy(d_host))
    # any slice of indices gives the same rows (sharded synthesis)
    part = torch.arange(5, grid.n_rays, 7)
    assert torch.equal(grid.rays_at(part)[0], s[part])


def test_tiled_grid_same_multiset():
    """The 16x8-block layout is a permutation of the row-major grid, and
    each 128-ray tile spans one 16x8 pixel block."""
    grid = camera.OrthoGrid(*GRID_SPECS[0])
    s_t = grid.rays_at(torch.arange(grid.n_rays))[0].numpy()
    s_r = grid._replace(tiled=False).rays_at(torch.arange(grid.n_rays))[0].numpy()
    key = lambda a: np.lexsort((a[:, 2], a[:, 1], a[:, 0]))  # noqa: E731
    np.testing.assert_array_equal(s_t[key(s_t)], s_r[key(s_r)])
    assert (np.unique(s_t[:128, 1]).size, np.unique(s_t[:128, 2]).size) in ((16, 8), (8, 16))


@pytest.mark.parametrize("res", [16, 24])
def test_scene_ortho_grid_equals_scene_rays(res):
    scene = sphere_lens_scene(res=res, sectors=9, belts=4, device="cpu")
    grid = scenes.scene_ortho_grid(res, scenes.SPHERE_BEAM_WIDTH)
    assert grid.tiled == (res % 16 == 0)
    s, d = grid.rays_at(torch.arange(grid.n_rays))
    assert torch.equal(s, scene.start) and torch.equal(d, scene.direction)
    assert scenes.scene_ortho_grid(res) == jax_scenes.scene_ortho_grid(res)


@pytest.mark.parametrize("args", [(3.0, 3.0, 4, 4), (1.5, 2.5, 7, 5)])
def test_angle_sweep_rays_equal_jax(args):
    got = camera.angle_sweep_rays(*args)
    for a, b in zip(got, jax_camera.angle_sweep_rays(*args)):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("args", [((0, 0, 0), (5, 0, 0), (0, 0, 1), 40.0, 6, 6),
                                  ((0.5, 1, -1), (5, 0, 0.2), (0, 0, 1), 25.0, 9, 4)])
def test_pinhole_ray_grid_equal_jax(args):
    got = camera.pinhole_ray_grid(*args)
    for a, b in zip(got, jax_camera.pinhole_ray_grid(*args)):
        assert a.dtype == np.float32 and a.flags.c_contiguous
        np.testing.assert_array_equal(a, b)


def test_surface_normal_render_matches_jax():
    """The sphere at 24^2 (tests/test_render.py's fixture), light along +x:
    hit masks equal, shade and depth allclose 1e-5."""
    scene = jax_scenes.sphere_lens_scene(res=24, sectors=9, belts=4)
    patches = patches_from_numpy(
        {k: np.asarray(v) for k, v in scene.patches._asdict().items()}, device="cpu")
    start = torch.tensor(np.asarray(scene.start))
    direction = torch.tensor(np.asarray(scene.direction))
    with jax.disable_jit():
        ref = [np.asarray(x) for x in jax_render.render_surface_normals(
            scene.patches, scene.start, scene.direction, light_dir=(1.0, 0, 0))]
    shade, depth, mask = render.render_surface_normals(
        patches, start, direction, light_dir=(1.0, 0, 0))
    np.testing.assert_array_equal(mask.numpy(), ref[2])
    assert ref[2].sum() > 100 and (depth.numpy()[ref[2]] > 3.0).all()
    assert (shade.numpy()[ref[2]] > 0).any()
    np.testing.assert_allclose(shade.numpy(), ref[0], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(depth.numpy(), ref[1], rtol=1e-5, atol=1e-5)
    plain = render.render_surface_normals(patches, start, direction, (1.0, 0, 0),
                                          backend="plain")
    for a, b in zip(plain, (shade, depth, mask)):
        assert torch.equal(a, b)
