"""Hemisphere emitter, ray-coherence sort and emitter rays against the JAX
package.

`UniformHemisphere` and `emitter_rays` are NumPy on the host in both
packages: the same seed gives bit-identical directions and bins.  The
coherence keys are integers: equal exactly.  `intersect_rays_sorted` is a
permutation around `intersect_rays`: winners equal, surface fields on hit
rays within 1e-6 (tests/test_fit_resume.py's bar for the JAX package).
"""
import numpy as np
import pytest
import torch

from cbtr_tpu.models.fit import emitter_rays as jax_emitter_rays
from cbtr_tpu.render import emitters as jax_em
from cbtr_tpu.render import ray_sort as jax_rs

from cbtr_tpu_torch.models import sphere_lens_scene
from cbtr_tpu_torch.models.fit import emitter_rays
from cbtr_tpu_torch.ops.intersect import intersect_rays
from cbtr_tpu_torch.render import emitters, ray_sort

torch.set_num_threads(2)


@pytest.mark.parametrize("belts", [1, 4, 16])
def test_belt_patch_counts_equal(belts):
    got = emitters.belt_patch_counts(belts)
    np.testing.assert_array_equal(got, jax_em.belt_patch_counts(belts))
    assert got.dtype == np.int64


@pytest.mark.parametrize("belts,seed", [(16, 1), (4, 0)])
def test_hemisphere_samples_bit_equal(belts, seed):
    port = emitters.UniformHemisphere(belts, seed)
    ref = jax_em.UniformHemisphere(belts, seed)
    assert port.patch_count == ref.patch_count
    for n in (1000, 37):          # two draws: the generator's state carries on
        d, patch = port.sample(n)
        d_r, patch_r = ref.sample(n)
        assert d.dtype == np.float32 and patch.dtype == np.int32
        np.testing.assert_array_equal(d, d_r)
        np.testing.assert_array_equal(patch, patch_r)
        assert (patch >= 0).all() and (patch < port.patch_count).all()


def test_emitter_rays_bit_equal():
    s, d = emitter_rays(4096, belts=16, seed=1, device="cpu")
    s_r, d_r = jax_emitter_rays(4096, belts=16, seed=1)
    assert s.dtype == d.dtype == torch.float32 and s.shape == d.shape == (4096, 3)
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_r))
    np.testing.assert_array_equal(d.numpy(), np.asarray(d_r))
    s2, _ = emitter_rays(8, origin=(1.0, 2.0, 3.0), device="cpu")
    s2_r, _ = jax_emitter_rays(8, origin=(1.0, 2.0, 3.0))
    np.testing.assert_array_equal(s2.numpy(), np.asarray(s2_r))


def _shuffled_rays(n, seed):
    rng = np.random.default_rng(seed)
    s = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return s, d


@pytest.mark.parametrize("bits", [3, 5])
def test_coherence_keys_equal(bits):
    s, d = _shuffled_rays(2000, bits)
    got = ray_sort.coherence_keys(torch.tensor(s), torch.tensor(d), bits)
    ref = np.asarray(jax_rs.coherence_keys(s, d, bits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert len(np.unique(ref)) > 50


def test_sort_rays_round_trips():
    s, d = _shuffled_rays(500, 0)
    ss, dd, inv = ray_sort.sort_rays(torch.tensor(s), torch.tensor(d))
    np.testing.assert_array_equal(dd[inv].numpy(), d)
    np.testing.assert_array_equal(ss[inv].numpy(), s)
    keys = ray_sort.coherence_keys(ss, dd)
    assert (keys[1:] >= keys[:-1]).all()
    ref_s, ref_d, ref_inv = (np.asarray(x) for x in jax_rs.sort_rays(s, d))
    np.testing.assert_array_equal(ss.numpy(), ref_s)
    np.testing.assert_array_equal(inv.numpy(), ref_inv)


def test_sorted_intersection_identical_results():
    """tests/test_fit_resume.py::test_sorted_intersection_identical_results on
    the port: a shuffled emitter-style bundle through the sphere lens."""
    scene = sphere_lens_scene(res=8, device="cpu")
    rng = np.random.default_rng(3)
    d, patch = emitters.UniformHemisphere(belts=4, seed=1).sample(256)
    d = d * np.array([1.0, 0.25, 0.25], np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    s = np.zeros((256, 3), np.float32)
    s[:, 1:] = rng.uniform(-0.3, 0.3, (256, 2)).astype(np.float32)
    s, d = torch.tensor(s), torch.tensor(d)

    a = intersect_rays(scene.patches, s, d)
    b = ray_sort.intersect_rays_sorted(scene.patches, s, d)
    assert torch.equal(a.what, b.what) and torch.equal(a.patch, b.patch)
    live = a.what == 4
    assert live.sum() >= 30
    for leaf_a, leaf_b in zip(a, b):
        torch.testing.assert_close(leaf_a[live], leaf_b[live], rtol=1e-6, atol=1e-6)
    c = ray_sort.intersect_rays_sorted(scene.patches, s, d, keys=torch.tensor(patch))
    assert torch.equal(a.what, c.what) and torch.equal(a.patch, c.patch)
