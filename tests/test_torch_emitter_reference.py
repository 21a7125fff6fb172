"""The benchmark's plain reference of the point source
(`portbench/reference/emitter.py`) against jax.random and the port, on the
CPU.

Its Threefry-2x32 `fold_in` and `uniform` give jax.random's bits; its rays
are the port's `DeviceEmitter` rays within one ulp at 8 belts and 16,384
rays; and at that size, through the robot lens, the port's
`render_multihost_emitter` keeps within the `robot450-emitter4k` cell's
limits against the reference's float64 weighted render: the share of rays
whose winner or status differs in each pass, and the image.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from cbtr_tpu_torch.parallel.multihost import render_multihost_emitter
from cbtr_tpu_torch.render.emitters import DeviceEmitter

from portbench import cell as cells
from portbench import compare, program
from portbench.reference import emitter as ref_emitter
from portbench.reference import scene as ref_scene

torch.set_num_threads(2)

WORKLOAD = "robot450-emitter4k"
SMALL = {"belts": 8, "n_rays": 16384, "chunk": 4096, "image_res": 32,
         "reference_chunk": 4096}
SEED = 3900000001


def _words(key):
    return np.stack([np.asarray(k) for k in key], axis=-1)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, -3])
def test_fold_in_and_uniform_give_jax_random_bits(seed):
    assert jax.config.jax_threefry_partitionable
    key, key_j = ref_emitter.prng_key(seed, "cpu"), jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(_words(key), np.asarray(key_j).astype(np.int64))
    data = torch.tensor([0, 1, 7, 123456, 2**31 + 9, 2**32 - 1])
    folded = ref_emitter.fold_in(key, data)
    want = np.stack([np.asarray(jax.random.fold_in(key_j, int(x))) for x in data])
    np.testing.assert_array_equal(_words(folded), want.astype(np.int64))
    np.testing.assert_array_equal(ref_emitter.uniform(key, 1000).numpy(),
                                  np.asarray(jax.random.uniform(key_j, (1000,))))
    idx = torch.arange(0, 5000, 7)
    u = ref_emitter.uniform(ref_emitter.fold_in(key, idx), 2)
    u_j = jax.vmap(lambda i: jax.random.uniform(jax.random.fold_in(key_j, i), (2,)))(
        np.asarray(idx))
    np.testing.assert_array_equal(u.numpy(), np.asarray(u_j))


def _spec(seed):
    return {"origin": (2.0, 0.0, 0.0), "belts": SMALL["belts"], "n_rays": SMALL["n_rays"],
            "seed": seed}


@pytest.mark.parametrize("seed", [SEED, 11])
def test_reference_rays_are_the_ports_within_one_ulp(seed):
    spec = _spec(seed)
    idx = torch.arange(spec["n_rays"])
    got = ref_emitter.rays(spec, idx)
    want = DeviceEmitter(**spec).rays_at(idx)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape
        np.testing.assert_array_max_ulp(a.numpy(), b.numpy(), maxulp=1)
    assert abs(float(got[2].double().sum()) - spec["n_rays"]) < 1e-3 * spec["n_rays"]


@pytest.fixture(scope="module")
def small_render():
    """The port's render at the small size with its passes captured, and the
    reference's weighted render of the reference's own rays."""
    c = cells.find_cell(cells.load_benchmark(), WORKLOAD, traffic_override=SMALL)
    mesh = cells.mesh_path(c)
    t = c.traffic
    spec = _spec(SEED)
    spec["origin"] = tuple((np.asarray(c.config["lens_center"], np.float32)
                            + np.asarray(t["source_from_lens"], np.float32)).tolist())
    scene = program.lens_scene(c, mesh, "cpu")
    screen = torch.tensor([1.0, 0.0, 0.0, float(t["screen_x"])])
    with torch.no_grad(), program.capture_passes() as passes:
        image = render_multihost_emitter(None, scene.patches, scene.refractive_index,
                                         DeviceEmitter(**spec), screen,
                                         resolution=t["image_res"], extent=t["extent"],
                                         chunk_size=t["chunk"])
    lens = ref_scene.build_lens(c.config, mesh, "cpu")
    start, direction, weight = ref_emitter.rays(spec, torch.arange(spec["n_rays"]))
    ref_image, trace = ref_emitter.render(lens, start, direction, weight, screen.double(),
                                          float(t["extent"]), int(t["image_res"]),
                                          chunk=t["reference_chunk"])
    path = os.path.join(c.package_dir, "limits", f"{WORKLOAD}.json")
    with open(path) as f:
        limits = {k: v["limit"] for k, v in json.load(f)["numbers"].items()}
    return passes, image, program.reference_passes(trace), ref_image, limits


@pytest.mark.parametrize("k", [1, 2])
def test_winners_and_statuses_within_the_cells_limit(small_render, k):
    passes, _, ref_passes, _, limits = small_render
    assert len(passes) == 2
    live = int((ref_passes[k - 1]["status"] > 0).sum())
    assert live > 50, live                     # the lens is in the fan
    assert compare.pass_gap(passes[k - 1], ref_passes[k - 1]) <= limits[f"pass{k}"]


def test_image_within_the_cells_limit(small_render):
    _, image, _, ref_image, limits = small_render
    assert float(ref_image.sum()) > 0.0 and image.shape == ref_image.shape
    assert compare.image_gap(image, ref_image) <= limits["image"]
