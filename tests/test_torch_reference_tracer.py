"""The port's NumPy reference tracer against the JAX package's.

Both are float64 NumPy over the same patch tables (the JAX package's,
handed to the port as tensors), so the outputs must be equal exactly.  The
tracer is also an oracle for the port's tensor path: the winning patch of
each hit ray equals the one `intersect_rays` picks.
"""
import numpy as np
import pytest
import torch

from cbtr_tpu.harness.reference_tracer import ReferenceTracer as JaxTracer
from cbtr_tpu.models import scenes as jax_scenes

from cbtr_tpu_torch.convert import patches_from_numpy
from cbtr_tpu_torch.harness.reference_tracer import R_NONE, ReferenceTracer
from cbtr_tpu_torch.ops.intersect import intersect_rays

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def robot():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CBTR_NATIVE", "0")
        scene = jax_scenes.robot_lens_scene(res=16)
    port = patches_from_numpy({k: np.asarray(v)
                               for k, v in scene.patches._asdict().items()}, device="cpu")
    s, d = np.asarray(scene.start), np.asarray(scene.direction)
    # eight rays the tensor path sees hit the lens and four it sees miss
    what = intersect_rays(port, torch.tensor(s), torch.tensor(d)).what.numpy()
    rays = np.concatenate([np.flatnonzero(what == 4)[::9][:8],
                           np.flatnonzero(what != 4)[::9][:4]])
    return scene, port, s[rays].astype(np.float64), d[rays].astype(np.float64)


def test_refract_equals_jax_tracer(robot):
    scene, port, s, d = robot
    mine, ref = ReferenceTracer(port), JaxTracer(scene.patches)
    hits = 0
    for expected in (1, 2):
        for i in range(len(s)):
            got = mine.refract(s[i], d[i], scene.refractive_index, expected)
            want = ref.refract(s[i], d[i], scene.refractive_index, expected)
            assert got[2] == want[2]
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
            hits += got[2] != R_NONE
    assert hits >= 4


def test_winners_equal_tensor_path(robot):
    _, port, s, d = robot
    tracer = ReferenceTracer(port)
    hit = intersect_rays(port, torch.tensor(s, dtype=torch.float32),
                         torch.tensor(d, dtype=torch.float32))
    n_hit = 0
    for i in range(len(s)):
        best = tracer.intersect(s[i], d[i])
        assert (best is not None) == bool(hit.what[i] == 4)
        if best is not None:
            n_hit += 1
            assert best["patch"] == int(hit.patch[i])
            assert abs(best["distance"] - float(hit.distance[i])) < 1e-4
    assert n_hit >= 6
