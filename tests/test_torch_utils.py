"""Checkpoints against the JAX package, and the trace.

Counterpart of tests/test_utils.py.  Both packages write the same `.npz`
layout, so a file written by one loads in the other with every array
equal: params files hold `control_points`, `refractive_index` and an int64
`__step__`, patches files the seven BezierPatches fields.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbtr_tpu.bezier import build_from_trimesh as jax_build
from cbtr_tpu.harness import preprocess as jax_preprocess
from cbtr_tpu.mesh.core import make_unit_sphere as jax_unit_sphere
from cbtr_tpu.models.lens_model import LensParams as JaxLensParams
from cbtr_tpu.utils import checkpoint as jax_ckpt

from cbtr_tpu_torch.bezier import build_from_trimesh
from cbtr_tpu_torch.harness import preprocess
from cbtr_tpu_torch.mesh.core import make_unit_sphere
from cbtr_tpu_torch.models.lens_model import LensParams
from cbtr_tpu_torch.render.render import screen_hits
from cbtr_tpu_torch.utils import (
    load_params,
    load_patches,
    save_params,
    save_patches,
    trace,
)
from cbtr_tpu_torch.utils.checkpoint import latest_checkpoint

torch.set_num_threads(2)

PATCH_FIELDS = ("control_points", "neighbours", "underlying", "dividers",
                "bary_inverse", "heights", "deriv_b")


@pytest.fixture(scope="module")
def patches():
    return build_from_trimesh(preprocess(make_unit_sphere(5, 2)), device="cpu")


def _params(patches, n=1.31):
    params = LensParams(patches, n)
    with torch.no_grad():
        params.control_points.mul_(1.5)
    return params


def test_patches_roundtrip(patches, tmp_path):
    path = str(tmp_path / "patches.npz")
    save_patches(path, patches)
    loaded = load_patches(path, device="cpu")
    for f in PATCH_FIELDS:
        a, b = getattr(patches, f), getattr(loaded, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    with np.load(path) as data:
        assert tuple(data.files) == PATCH_FIELDS


def test_patches_cross_package(tmp_path):
    """A JAX patches file loads in the port and the port's in JAX."""
    jax_patches = jax_build(jax_preprocess(jax_unit_sphere(5, 2)))
    path = str(tmp_path / "jax.npz")
    jax_ckpt.save_patches(path, jax_patches)
    port = load_patches(path, device="cpu")
    for f, leaf in zip(PATCH_FIELDS, jax_patches):
        np.testing.assert_array_equal(getattr(port, f).numpy(), np.asarray(leaf))
        assert getattr(port, f).numpy().dtype == np.asarray(leaf).dtype
    back = str(tmp_path / "port.npz")
    save_patches(back, port)
    for a, b in zip(jax_ckpt.load_patches(back), jax_patches):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_params_roundtrip_and_latest(patches, tmp_path):
    params = _params(patches)
    for step in (3, 11, 7):
        save_params(str(tmp_path / f"ckpt_{step}.npz"), params, step=step)
    best = latest_checkpoint(str(tmp_path))
    assert best is not None and best.endswith("ckpt_11.npz")
    loaded, step = load_params(best, patches, device="cpu")
    assert step == 11
    assert torch.equal(loaded.control_points, params.control_points)
    assert loaded.refractive_index.item() == np.float32(1.31)
    # the tables are the given patches', not stored in the file
    assert torch.equal(loaded.dividers, patches.dividers)
    with np.load(best) as data:
        assert sorted(data.files) == ["__step__", "control_points", "refractive_index"]
        assert data["__step__"].dtype == np.int64


def test_params_cross_package(patches, tmp_path):
    """A JAX `save_params` file loads in the port, and the port's in JAX:
    arrays equal, step carried."""
    cp = np.random.default_rng(1).normal(size=tuple(patches.control_points.shape))
    jax_params = JaxLensParams(jnp.asarray(cp, jnp.float32), jnp.float32(1.42))
    path = str(tmp_path / "ckpt_5.npz")
    jax_ckpt.save_params(path, jax_params, step=5)
    port, step = load_params(path, patches, device="cpu")
    assert step == 5
    np.testing.assert_array_equal(port.control_points.detach().numpy(),
                                  np.asarray(jax_params.control_points))
    assert port.refractive_index.item() == np.float32(1.42)

    back = str(tmp_path / "ckpt_6.npz")
    save_params(back, port, step=6)
    got, step = jax_ckpt.load_params(back, JaxLensParams)
    assert step == 6
    np.testing.assert_array_equal(np.asarray(got.control_points),
                                  np.asarray(jax_params.control_points))
    assert np.asarray(got.refractive_index).dtype == np.float32
    assert float(got.refractive_index) == np.float32(1.42)
    assert jax_ckpt.latest_checkpoint(str(tmp_path)) == latest_checkpoint(str(tmp_path))


def test_latest_checkpoint_skips_malformed_names(tmp_path):
    assert latest_checkpoint(str(tmp_path / "missing")) is None
    assert latest_checkpoint(str(tmp_path)) is None
    for name in ("ckpt_x.npz", "ckpt_.npz", "other_50.npz", "ckpt_90.npz.tmp",
                 "ckpt_4.npz", "ckpt_12.npz", "ckpt_3.npy"):
        (tmp_path / name).write_bytes(b"")
    assert latest_checkpoint(str(tmp_path)) == str(tmp_path / "ckpt_12.npz")
    assert latest_checkpoint(str(tmp_path), prefix="other_") == str(tmp_path / "other_50.npz")


def test_writes_leave_no_tmp_file(patches, tmp_path):
    save_params(str(tmp_path / "ckpt_1.npz"), _params(patches), step=1)
    save_patches(str(tmp_path / "patches.npz"), patches)
    save_params(str(tmp_path / "ckpt_1.npz"), _params(patches, 1.5), step=2)  # overwrite
    assert sorted(os.listdir(tmp_path)) == ["ckpt_1.npz", "patches.npz"]
    _, step = load_params(str(tmp_path / "ckpt_1.npz"), patches, device="cpu")
    assert step == 2


def test_trace_writes_into_logdir(tmp_path):
    """The Chrome trace holds the program's spans: `trace` turns them on."""
    logdir = tmp_path / "trace"
    with trace(str(logdir)):
        torch.ones(64).cumsum(0)
        screen_hits(torch.zeros(4, 3), torch.tensor([[1.0, 0.0, 0.0]] * 4),
                    torch.tensor([1.0, 0.0, 0.0, -10.0]))
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    assert (logdir / files[0]).stat().st_size > 0
    with open(logdir / files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "cbtr.screen_hits" in names
