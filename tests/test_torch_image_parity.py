"""BASELINE config 1 on the port: the sphere-lens image against the f64
oracle.

The port renders the image; the oracle (`FastReferenceTracer`, f64 NumPy,
held here against the scalar `ReferenceTracer` and against the JAX
package's `FastReferenceTracer`) traces the same rays one by one through
both refractions (`oracle_screen_hits`) and splats them with an
independent NumPy bilinear splat.  The bars are tests/test_image_parity.py's:

* per-ray disagreement (kept by one side only, or landing more than 5e-3
  apart) at most 0.5 % of the rays, median position error under 5e-4;
* the image's total weight within 1e-3 relative, no pixel more than 2
  apart, at most 0.5 % of the pixels more than 0.05 apart, relative L1
  error at most 0.01.

Tier 1 runs the 16^2-ray grid (256 rays, about 15 s of oracle); the full
128^2 image (16,384 rays, several minutes of oracle) is marked slow, as
its JAX counterpart is.
"""
import numpy as np
import pytest
import torch

from cbtr_tpu.harness.reference_tracer import FastReferenceTracer as JaxFastTracer
from cbtr_tpu.models import scenes as jax_scenes

from cbtr_tpu_torch.convert import patches_from_numpy
from cbtr_tpu_torch.harness.reference_tracer import (
    FastReferenceTracer,
    R_INSIDE,
    R_OUTSIDE,
    ReferenceTracer,
    landing_disagreement,
    oracle_screen_hits,
)
from cbtr_tpu_torch.models import sphere_lens_scene
from cbtr_tpu_torch.optics import REFRACT_INSIDE, REFRACT_OUTSIDE, refract_rays
from cbtr_tpu_torch.render.render import render_lens_image, screen_hits

torch.set_num_threads(2)
EXTENT = 4.0


def _sample_rays(n=48, seed=21):
    """test_image_parity.py's 48 rays toward the lens."""
    rng = np.random.default_rng(seed)
    d = np.concatenate([np.ones((n, 1)), rng.uniform(-0.15, 0.15, (n, 2))], axis=1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    s = np.zeros((n, 3))
    s[:, 1:] = rng.uniform(-0.3, 0.3, (n, 2))
    return s, d


@pytest.fixture(scope="module")
def patches():
    return sphere_lens_scene(res=16, sectors=15, belts=7, device="cpu").patches


def test_fast_tracer_matches_scalar_tracer(patches):
    """The vectorized oracle used for image parity is pinned to the scalar
    ground-truth oracle on a ray sample."""
    fast, slow = FastReferenceTracer(patches), ReferenceTracer(patches)
    s, d = _sample_rays()
    hits = 0
    for i in range(len(s)):
        a, b = fast.intersect(s[i], d[i]), slow.intersect(s[i], d[i])
        assert (a is None) == (b is None), f"ray {i} hit mismatch"
        if a is not None:
            hits += 1
            assert a["patch"] == b["patch"], f"ray {i} patch mismatch"
            np.testing.assert_allclose(a["point"], b["point"], atol=1e-12)
    assert hits >= 24


def test_fast_tracer_matches_jax_fast_tracer():
    """On the JAX package's patch tables both fast oracles give the same
    hits and landings (atol 1e-12: the same float64 NumPy arithmetic)."""
    scene = jax_scenes.sphere_lens_scene(res=16, sectors=15, belts=7)
    port = patches_from_numpy({k: np.asarray(v) for k, v in scene.patches._asdict().items()},
                              device="cpu")
    mine, ref = FastReferenceTracer(port), JaxFastTracer(scene.patches)
    s, d = _sample_rays()
    for i in range(len(s)):
        a, b = mine.intersect(s[i], d[i]), ref.intersect(s[i], d[i])
        assert (a is None) == (b is None), i
        if a is not None:
            assert (a["what"], a["patch"]) == (b["what"], b["patch"]), i
            for key in ("distance", "point", "normal", "bary", "cos_incidence"):
                np.testing.assert_allclose(a[key], b[key], rtol=0, atol=1e-12, err_msg=key)
        for expected in (R_INSIDE, R_OUTSIDE):
            ga, gb = mine.refract(s[i], d[i], 1.3, expected), ref.refract(s[i], d[i], 1.3,
                                                                          expected)
            assert ga[2] == gb[2], i
            np.testing.assert_allclose(ga[0], gb[0], rtol=0, atol=1e-12)
            np.testing.assert_allclose(ga[1], gb[1], rtol=0, atol=1e-12)


def _splat_numpy(hit2d, keep, extent, res):
    img = np.zeros((res, res))
    xy = (hit2d / (2.0 * extent) + 0.5) * res - 0.5
    x0 = np.floor(xy).astype(int)
    frac = xy - np.floor(xy)
    for i in np.flatnonzero(keep):
        for dx in (0, 1):
            for dy in (0, 1):
                wx = frac[i, 0] if dx else 1.0 - frac[i, 0]
                wy = frac[i, 1] if dy else 1.0 - frac[i, 1]
                ix, iy = x0[i, 0] + dx, x0[i, 1] + dy
                if 0 <= ix < res and 0 <= iy < res:
                    img[ix, iy] += wx * wy
    return img


def _image_parity(res):
    scene = sphere_lens_scene(res=res, sectors=15, belts=7, device="cpu")
    with torch.no_grad():
        s1, d1, st1 = refract_rays(scene.patches, scene.refractive_index, scene.start,
                                   scene.direction, REFRACT_INSIDE)
        s2, d2, st2 = refract_rays(scene.patches, scene.refractive_index, s1, d1,
                                   REFRACT_OUTSIDE)
        hit2d, on = screen_hits(s2, d2, scene.screen_plane)
        img = render_lens_image(scene.patches, scene.refractive_index, scene.start,
                                scene.direction, scene.screen_plane, extent=EXTENT,
                                resolution=res).numpy()
    keep = ((st1 == REFRACT_INSIDE) & (st2 == REFRACT_OUTSIDE) & on).numpy()
    hit2d_ref, keep_ref = oracle_screen_hits(
        FastReferenceTracer(scene.patches), scene.refractive_index,
        scene.screen_plane.numpy(), scene.start.numpy(), scene.direction.numpy())

    masks, positions, pos_err = landing_disagreement(hit2d.numpy(), keep, hit2d_ref,
                                                     keep_ref)
    assert keep_ref.sum() > 0.3 * len(keep_ref)
    assert (masks + positions) / len(keep) <= 0.005, (masks, positions)
    assert np.median(pos_err) < 5e-4

    img_ref = _splat_numpy(hit2d_ref, keep_ref, EXTENT, res)
    assert img.sum() == pytest.approx(img_ref.sum(), rel=1e-3)
    diff = np.abs(img - img_ref)
    assert diff.max() <= 2.0 + 1e-3, f"max pixel diff {diff.max()}"
    assert (diff > 0.05).mean() <= 0.005, "too many differing pixels"
    assert diff.sum() / max(img_ref.sum(), 1.0) <= 0.01


def test_sphere_image_16_matches_oracle():
    """BASELINE config 1's lens at 16^2 rays (and a 16^2 image)."""
    _image_parity(16)


@pytest.mark.slow
def test_sphere_image_128_matches_oracle():
    """BASELINE config 1 as tests/test_image_parity.py runs it: 128^2 rays,
    a 128^2 image."""
    _image_parity(128)
