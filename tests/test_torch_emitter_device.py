"""DeviceEmitter, the threefry generator and the point-source renders
against the JAX package.

Counterpart of tests/test_emitter_device.py:34-127 (its multihost tests wait
for the port's `parallel/`).  `utils.prng` is threefry-2x32 in torch integer
ops, so the emitter's uniform draws `u`, its bin `patch`, the index in the
bin `j` and the bin's count `cnt` are bit-equal to the JAX package's; the
float tail (cos, sin, sqrt, the norm) is XLA's against torch's, held to
atol 1e-6.  The statistical tests run on the port alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbtr_tpu.models import scenes as jax_scenes
from cbtr_tpu.render import emitters as jax_em
from cbtr_tpu.render import render as jax_render

from cbtr_tpu_torch.convert import patches_from_numpy
from cbtr_tpu_torch.models import scenes
from cbtr_tpu_torch.render import emitters, render
from cbtr_tpu_torch.utils import prng

torch.set_num_threads(2)

EMITTER_ORIGIN = tuple(
    (np.asarray(scenes.LENS_CENTER) - np.array([3.0, 0, 0], np.float32)).tolist()
)


def _u32(x):
    return np.asarray(x).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 + 5, -3])
def test_prng_bit_equal_jax(seed):
    """prng_key, fold_in, split, random bits and uniform against jax.random
    (jax_threefry_partitionable, the default of jax 0.9.0)."""
    assert jax.config.jax_threefry_partitionable
    key, key_j = prng.prng_key(seed, device="cpu"), jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(key.numpy(), _u32(key_j))
    for data in (0, 7, 2**32 - 1):
        np.testing.assert_array_equal(prng.fold_in(key, data).numpy(),
                                      _u32(jax.random.fold_in(key_j, data)))
    np.testing.assert_array_equal(prng.split(key, 3).numpy(),
                                  _u32(jax.random.split(key_j, 3)))
    np.testing.assert_array_equal(prng.random_bits(key, 9).numpy(),
                                  _u32(jax.random.bits(key_j, (9,))))
    np.testing.assert_array_equal(prng.uniform(key, 1000).numpy(),
                                  np.asarray(jax.random.uniform(key_j, (1000,))))
    np.testing.assert_array_equal(
        prng.uniform(key, 100, 0.0, 2.0 * np.pi).numpy(),
        np.asarray(jax.random.uniform(key_j, (100,), minval=0.0, maxval=2.0 * np.pi)))


def _jax_draws(em, idx):
    """The JAX DeviceEmitter.rays_at's integer and random part
    (cbtr_tpu/render/emitters.py:132-142), spelled out."""
    t = {k: jnp.asarray(v) for k, v in em._tables().items()}
    key = jax.random.PRNGKey(em.seed)
    u = jax.vmap(lambda i: jax.random.uniform(jax.random.fold_in(key, i), (2,)))(idx)
    patch = jnp.minimum(jnp.searchsorted(t["bounds"], idx, side="right"),
                        t["bounds"].shape[0] - 1)
    cnt = jnp.maximum(t["nb"][patch], 1).astype(jnp.float32)
    j = (idx - t["starts"][patch]).astype(jnp.float32)
    return [np.asarray(x) for x in (u, patch, j, cnt)]


@pytest.mark.parametrize("belts,n,seed", [(16, 262144, 1), (5, 4096, 3), (8, 100_000, 2)])
def test_device_emitter_matches_jax(belts, n, seed):
    """At 4096 indices spread over the set: u, patch, j, cnt bit-equal;
    start equal; direction and weight allclose atol 1e-6."""
    em = emitters.DeviceEmitter(EMITTER_ORIGIN, belts, n, seed)
    em_j = jax_em.DeviceEmitter(EMITTER_ORIGIN, belts, n, seed)
    idx = np.unique(np.linspace(0, n - 1, 4096).astype(np.int32))
    idx_t = torch.tensor(idx)
    for got, want in zip(em.bins_at(idx_t), _jax_draws(em_j, jnp.asarray(idx))):
        np.testing.assert_array_equal(got.numpy(), want)
    s, d, w = em.rays_at(idx_t)
    s_j, d_j, w_j = (np.asarray(x) for x in em_j.rays_at(jnp.asarray(idx)))
    np.testing.assert_array_equal(s.numpy(), s_j)
    np.testing.assert_allclose(d.numpy(), d_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(w.numpy(), w_j, rtol=0, atol=1e-6)


def test_sample_hemisphere_matches_jax():
    d = emitters.sample_hemisphere(prng.prng_key(0, device="cpu"), 512)
    d_j = np.asarray(jax_em.sample_hemisphere(jax.random.PRNGKey(0), 512))
    assert d.shape == (512, 3) and d.dtype == torch.float32
    np.testing.assert_allclose(torch.linalg.vector_norm(d, dim=-1).numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(d.numpy(), d_j, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def em():
    return emitters.DeviceEmitter(origin=(0.0, 0.0, 0.0), belts=8, n_rays=100_000, seed=2)


@pytest.fixture(scope="module")
def rays(em):
    s, d, w = em.rays_at(torch.arange(em.n_rays))
    return s.numpy(), d.numpy(), w.numpy()


def test_device_emitter_uniform_over_area(em, rays):
    _, d, _ = rays
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-5)
    assert (d[:, 0] >= 0).all()
    hist, _ = np.histogram(d[:, 0], bins=10, range=(0.0, 1.0))
    assert hist.min() > 0.97 * em.n_rays / 10 and hist.max() < 1.03 * em.n_rays / 10
    turn = np.arctan2(d[:, 2], d[:, 1]) % (2 * np.pi)
    hist_t, _ = np.histogram(turn, bins=8, range=(0.0, 2 * np.pi))
    assert hist_t.min() > 0.95 * em.n_rays / 8 and hist_t.max() < 1.05 * em.n_rays / 8


def test_device_emitter_sorted_by_reference_bin(em, rays):
    """Rays arrive ordered by the reference's belt/patch bin on at least
    0.995 of adjacent pairs (float roundoff at a bin edge may flip one)."""
    _, d, _ = rays
    hemi = emitters.UniformHemisphere(belts=em.belts)
    incidence = np.arccos(np.clip(d[:, 0], -1.0, 1.0))
    turn = np.arctan2(d[:, 2], d[:, 1]) % (2 * np.pi)
    belt = np.minimum((incidence / hemi.belt_width).astype(np.int64), em.belts - 1)
    patch = hemi.patch_starts[belt] + np.minimum(
        (turn / hemi.patch_widths[belt]).astype(np.int64),
        emitters.belt_patch_counts(em.belts)[belt] - 1)
    assert float(np.mean(np.diff(patch) >= 0)) > 0.995


def test_device_emitter_weights_unbiased(em, rays):
    _, _, w = rays
    assert abs(w.sum() - em.n_rays) < 1e-3 * em.n_rays
    assert w.min() > 0.3 and w.max() < 3.0


def test_device_emitter_deterministic_in_global_index(em, rays):
    part = em.rays_at(torch.arange(37, 91))
    for a, b in zip(rays, part):
        np.testing.assert_array_equal(a[37:91], b.numpy())


@pytest.fixture(scope="module")
def sphere():
    # rays unused; geometry only
    scene = jax_scenes.sphere_lens_scene(res=4, sectors=9, belts=4)
    patches = patches_from_numpy(
        {k: np.asarray(v) for k, v in scene.patches._asdict().items()}, device="cpu")
    return scene, patches, torch.tensor(np.asarray(scene.screen_plane))


def _assert_image_close(img, img_j):
    """Pixels within 2e-4 of the peak, total flux rtol 1e-5: jitted XLA
    rounds the four unconverged Newton iterations on a few rays otherwise
    than torch (measured on the sphere: 1.1e-3 of a peak of 30.3, sums
    equal; ROADMAP queue C)."""
    assert img.shape == img_j.shape and img_j.sum() > 0
    np.testing.assert_allclose(img.numpy(), img_j, rtol=0, atol=2e-4 * img_j.max())
    np.testing.assert_allclose(float(img.sum()), float(img_j.sum()), rtol=1e-5)


def test_device_emitter_image_matches_jax_and_host_emitter(sphere):
    """4096 rays through the sphere into a 32^2 image: the port's device
    render close to the JAX package's, and its flux within 0.12 of the
    host emitter's (two estimators of one integral; the JAX package's bar)."""
    scene, patches, screen = sphere
    n = 4096
    em = emitters.DeviceEmitter(EMITTER_ORIGIN, 5, n, 3)
    img = render.render_emitter_image_device(patches, scene.refractive_index, em,
                                             screen, resolution=32)
    img_j = np.asarray(jax_render.render_emitter_image_device(
        scene.patches, scene.refractive_index,
        jax_em.DeviceEmitter(EMITTER_ORIGIN, 5, n, 3), scene.screen_plane,
        resolution=32))
    assert img.shape == (32, 32) and img_j.sum() > 100
    _assert_image_close(img, img_j)
    host = render.render_emitter_image(
        patches, scene.refractive_index, emitters.UniformHemisphere(5, seed=3), n,
        np.asarray(EMITTER_ORIGIN, np.float32), screen, resolution=32)
    f_dev, f_host = float(img.sum()), float(host.sum())
    assert f_dev > 0.0 and f_host > 0.0
    assert abs(f_dev - f_host) < 0.12 * max(f_dev, f_host), (f_dev, f_host)


def test_host_emitter_image_matches_jax(sphere):
    """Host-sampled emitter render: the same rays in both packages (NumPy
    sampling), images close as above."""
    scene, patches, screen = sphere
    origin = np.asarray(EMITTER_ORIGIN, np.float32)
    img = render.render_emitter_image(patches, scene.refractive_index,
                                      emitters.UniformHemisphere(5, seed=3), 512,
                                      origin, screen, resolution=32)
    img_j = np.asarray(jax_render.render_emitter_image(
        scene.patches, scene.refractive_index, jax_em.UniformHemisphere(5, seed=3),
        512, origin, scene.screen_plane, resolution=32))
    _assert_image_close(img, img_j)
