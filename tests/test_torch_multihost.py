"""The multi-process layer (cbtr_tpu_torch/parallel/multihost.py) against the
single-process port and the JAX package's parallel/multihost.py.

Counterpart of tests/test_multihost.py and of the two multihost tests of
tests/test_emitter_device.py:129-175.  The multi-rank cases run in ONE
two-rank gloo group of fresh processes (a `file://` store under tmp_path,
one thread a rank, killed after 120 s); this process compares what they
saved with the JAX functions on the virtual 8-device CPU mesh
(tests/conftest.py) and with the port in one process.  Both packages read
the same patch tables (the JAX build's, through `patches_from_numpy`) and
the same rays.
"""
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbtr_tpu.models import sphere_lens_scene as jax_sphere_scene
from cbtr_tpu.models.lens_model import params_from_scene as jax_params_from_scene
from cbtr_tpu.parallel import multihost as jax_mh
from cbtr_tpu.render.emitters import DeviceEmitter as JaxEmitter

from cbtr_tpu_torch.convert import patches_from_numpy
from cbtr_tpu_torch.models import lens_model, scenes
from cbtr_tpu_torch.parallel import multihost as mh
from cbtr_tpu_torch.parallel import sharding
from cbtr_tpu_torch.render.emitters import DeviceEmitter
from cbtr_tpu_torch.render.render import render_emitter_image_device, render_lens_image

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EMITTER_ORIGIN = tuple((np.asarray(scenes.LENS_CENTER) - np.array([3.0, 0, 0],
                                                                  np.float32)).tolist())
RANK_TIMEOUT_S = 120


def run_ranks(script: str, world: int, tmp_path, args=()):
    """Run `script` in `world` fresh processes, rank r as `script r world
    store tmp_path *args`, each with one thread; fail (and kill them all)
    if any has not exited within RANK_TIMEOUT_S or one exits non-zero."""
    # gloo on the loopback interface: the ranks talk to this machine only
    env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    env.pop("XLA_FLAGS", None)
    logs = [open(tmp_path / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), str(world),
                               str(tmp_path / "store"), str(tmp_path), *map(str, args)],
                              stdout=log, stderr=subprocess.STDOUT, cwd=REPO, env=env)
             for r, log in enumerate(logs)]
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pytest.fail(f"{world} ranks still running after {RANK_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (tmp_path / f"rank{r}.log").read_text()[-3000:]


_RANKS = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from cbtr_tpu_torch.convert import patches_from_numpy
from cbtr_tpu_torch.models import lens_model
from cbtr_tpu_torch.models.scenes import SPHERE_BEAM_WIDTH, scene_ortho_grid
from cbtr_tpu_torch.parallel import multihost as mh
from cbtr_tpu_torch.parallel import sharding
from cbtr_tpu_torch.render.emitters import DeviceEmitter
from cbtr_tpu_torch.render.render import render_emitter_image_device

rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
assert mh.init_distributed(f"file://{store}", world, rank, backend="gloo")
mesh = mh.multihost_mesh()
a = np.load(f"{out}/scene.npz")
patches = patches_from_numpy({k[2:]: a[k] for k in a.files if k.startswith("p_")}, device="cpu")
s, d, screen, n_refr = a["start"], a["direction"], torch.tensor(a["screen"]), float(a["n"])
r = {}


def lens():
    return lens_model.LensParams(patches, n_refr)


r["img"] = mh.render_multihost(mesh, patches, n_refr, s, d, screen, resolution=32)
r["img253"] = mh.render_multihost(mesh, patches, n_refr, s[:253], d[:253], screen, resolution=32)
r["shard_s"], r["shard_d"], r["shard_w"] = mh.process_ray_shard(
    np.zeros((13, 3), np.float32), np.tile(np.float32([1, 0, 0]), (13, 1)), mesh, device="cpu")
target = torch.zeros((32, 32))
step = mh.make_multihost_train_step(mesh, screen, target, resolution=32, learning_rate=1e-4)
p, loss1 = step(lens(), s, d)
r["grad_cp"], r["grad_n"] = p.control_points.grad, p.refractive_index.grad
r["cp1"], r["n1"] = p.control_points.detach().clone(), p.refractive_index.detach().clone()
_, loss2 = step(p, s, d)
r["losses"] = torch.stack([loss1, loss2])

grid = scene_ortho_grid(16, beam_width=SPHERE_BEAM_WIDTH)
r["img_ortho"] = mh.render_multihost_ortho(mesh, patches, n_refr, grid, screen, resolution=32)
step_o = mh.make_multihost_train_step_ortho(mesh, screen, target, grid, resolution=32,
                                            learning_rate=1e-4)
p, lo1, (g_cp, _) = step_o(lens())
r["ortho_cp1"], r["ortho_grad_cp"] = p.control_points.detach().clone(), g_cp.clone()
_, lo2, _ = step_o(p)
r["ortho_losses"] = torch.stack([lo1, lo2])

p = lens()
with torch.no_grad():
    p.control_points += rank
r["replicated_cp"] = sharding.replicate(mesh, p).control_points
r["replicated_t"] = sharding.replicate(mesh, torch.full((3,), float(rank)))

em = DeviceEmitter(tuple(float(x) for x in a["origin"]), 5, 2048, 3)
r["img_emitter"] = mh.render_multihost_emitter(mesh, patches, n_refr, em, screen, resolution=32)
target_e = render_emitter_image_device(patches, n_refr, em, screen, resolution=32)
step_e = mh.make_multihost_train_step_emitter(mesh, screen, target_e, em, resolution=32,
                                              learning_rate=2e-4)
p = lens()
with torch.no_grad():
    p.control_points *= 1.02
losses = []
for _ in range(3):
    p, loss, (g_cp, _) = step_e(p)
    losses.append(loss)
    if len(losses) == 1:
        r["emitter_grad_norm"] = torch.linalg.vector_norm(g_cp)
r["emitter_losses"] = torch.stack(losses)
np.savez(f"{out}/rank{rank}.npz", **{k: v.detach().numpy() if torch.is_tensor(v) else v
                                     for k, v in r.items()})
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The JAX sphere 9 x 4 scene at 16^2 rays (the JAX tests' scene), its
    patches in the port, and what two gloo ranks computed with them: {name:
    [rank 0, rank 1]}."""
    tmp_path = tmp_path_factory.mktemp("multihost")
    scene = jax_sphere_scene(res=16, sectors=9, belts=4)
    np.savez(tmp_path / "scene.npz",
             **{"p_" + k: np.asarray(v) for k, v in scene.patches._asdict().items()},
             start=np.asarray(scene.start), direction=np.asarray(scene.direction),
             screen=np.asarray(scene.screen_plane), n=scene.refractive_index,
             origin=np.asarray(EMITTER_ORIGIN, np.float32))
    t = time.monotonic()
    run_ranks(_RANKS, 2, tmp_path)
    print(f"two gloo ranks: {time.monotonic() - t:.1f} s")
    runs = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    patches = patches_from_numpy({k: np.asarray(v) for k, v in scene.patches._asdict().items()},
                                 device="cpu")
    return scene, patches, {k: [run[k] for run in runs] for k in runs[0]}


def _port(scene, patches, rays=slice(None)):
    s = torch.tensor(np.asarray(scene.start)[rays])
    d = torch.tensor(np.asarray(scene.direction)[rays])
    return s, d, torch.tensor(np.asarray(scene.screen_plane))


def test_init_distributed_noop_single_process(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert mh.init_distributed() is False
    assert mh.multihost_mesh() is None
    with pytest.raises(ValueError):
        mh.init_distributed(num_processes=2)


def test_process_ray_shard_pads_to_device_multiple(monkeypatch):
    """13 rays over 8 ranks (the JAX test's case): every rank's slice, put
    together, is 16 rays; real rays weight 1, padding weight 0 heading -x
    from the origin."""
    start = np.zeros((13, 3), np.float32)
    direction = np.tile(np.float32([1.0, 0, 0]), (13, 1))
    shards = []
    for i in range(8):
        monkeypatch.setattr(mh, "axis_group", lambda mesh, axis, i=i: (None, 8, i))
        shards.append(mh.process_ray_shard(start, direction, "mesh", device="cpu"))
    s, d, w = (torch.cat(x).numpy() for x in zip(*shards))
    assert s.shape == (16, 3) and w.shape == (16,) and all(x[0].shape == (2, 3) for x in shards)
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-6)
    np.testing.assert_array_equal(w, [1.0] * 13 + [0.0] * 3)
    np.testing.assert_array_equal(d[13:, 0], [-1.0] * 3)
    np.testing.assert_array_equal(s[13:], 0.0)


def test_world_of_one_is_the_single_process_render():
    """No process group: render_multihost (weights all 1), the ortho render
    and render_sharded are torch.equal to render_lens_image; the emitter
    render to render_emitter_image_device."""
    sc = scenes.sphere_lens_scene(res=16, sectors=9, belts=4, device="cpu")
    want = render_lens_image(sc.patches, sc.refractive_index, sc.start, sc.direction,
                             sc.screen_plane, resolution=32)
    got = mh.render_multihost(None, sc.patches, sc.refractive_index, sc.start.numpy(),
                              sc.direction.numpy(), sc.screen_plane, resolution=32)
    grid = scenes.scene_ortho_grid(16, beam_width=scenes.SPHERE_BEAM_WIDTH)
    ortho = mh.render_multihost_ortho(None, sc.patches, sc.refractive_index, grid,
                                      sc.screen_plane, resolution=32)
    sharded = sharding.render_sharded(None, sc.patches, sc.refractive_index, sc.start,
                                      sc.direction, sc.screen_plane, resolution=32)
    assert float(want.sum()) > 100
    for img in (got, ortho, sharded):
        assert torch.equal(img, want)
    em = DeviceEmitter(EMITTER_ORIGIN, 5, 1024, 3)
    assert torch.equal(
        mh.render_multihost_emitter(None, sc.patches, sc.refractive_index, em,
                                    sc.screen_plane, resolution=32),
        render_emitter_image_device(sc.patches, sc.refractive_index, em, sc.screen_plane,
                                    resolution=32))


def test_two_rank_renders_match_jax_and_one_process(two_ranks):
    """The image of the 2-rank group, the same on both ranks, against the
    JAX `render_multihost` on 8 virtual devices (atol 1e-4; 2e-3 for the
    unaligned 253 rays, whose padding ray must add nothing: the JAX tests'
    bars) and against the port in one process (f32 summation order of two
    partial images: within 1e-5); `replicate` and the padding of 13 rays
    over the two ranks.  The JAX side runs op by op
    (`jax.disable_jit()`): jitted XLA rounds the unconverged Newton
    iterations of some rays otherwise than torch and moves pixels of this
    sphere by up to 5.1e-3 (ROADMAP queue C); op by op, 6.9e-5."""
    scene, patches, runs = two_ranks
    mesh = jax_mh.multihost_mesh()
    for key, n, atol in (("img", 256, 1e-4), ("img253", 253, 2e-3)):
        a, b = runs[key]
        np.testing.assert_array_equal(a, b)
        with jax.disable_jit():
            img_j = np.asarray(jax_mh.render_multihost(
                mesh, scene.patches, scene.refractive_index, np.asarray(scene.start)[:n],
                np.asarray(scene.direction)[:n], scene.screen_plane, resolution=32))
        np.testing.assert_allclose(a, img_j, rtol=0, atol=atol)
        np.testing.assert_allclose(a.sum(), img_j.sum(), rtol=1e-4)
        s, d, screen = _port(scene, patches, slice(0, n))
        one = render_lens_image(patches, scene.refractive_index, s, d, screen,
                                resolution=32).numpy()
        assert one.sum() > 100
        np.testing.assert_allclose(a, one, rtol=0, atol=1e-5)
    # replicate: rank 0's module and tensor on both ranks
    for r in range(2):
        np.testing.assert_array_equal(runs["replicated_cp"][r], patches.control_points.numpy())
        np.testing.assert_array_equal(runs["replicated_t"][r], 0.0)
    # 13 rays over 2 ranks: 7 a rank, the last weighted 0 and heading -x
    np.testing.assert_array_equal(np.concatenate(runs["shard_w"]), [1.0] * 13 + [0.0])
    assert runs["shard_s"][1].shape == (7, 3) and runs["shard_d"][1][-1, 0] == -1.0


def test_two_rank_train_step_gradient_is_the_one_process_gradient(two_ranks):
    """make_multihost_train_step: both ranks hold the same loss, gradient
    and parameters after the step; the gradient, summed over the ranks, is
    the one-process gradient of the loss on the full image within f32
    summation order (2e-5 of max |g|; measured 3.1e-6, and 1.6e-7 relative
    for the index), and the loss within 1e-4 of the JAX step's (the bar of
    tests/test_torch_lens_model.py)."""
    scene, patches, runs = two_ranks
    for key in ("losses", "grad_cp", "grad_n", "cp1", "n1"):
        np.testing.assert_array_equal(runs[key][0], runs[key][1])
    s, d, screen = _port(scene, patches)
    params = lens_model.LensParams(patches, scene.refractive_index)
    loss = lens_model.lens_loss(params, s, d, screen, torch.zeros(32, 32), resolution=32)
    loss.backward()
    g, g_n = params.control_points.grad.numpy(), float(params.refractive_index.grad)
    assert np.abs(g).max() > 0
    np.testing.assert_allclose(runs["losses"][0][0], loss.item(), rtol=1e-6)
    np.testing.assert_allclose(runs["grad_cp"][0], g, rtol=0, atol=2e-5 * np.abs(g).max())
    np.testing.assert_allclose(runs["grad_n"][0], g_n, rtol=2e-5)
    np.testing.assert_allclose(runs["cp1"][0], patches.control_points.numpy()
                               - 1e-4 * runs["grad_cp"][0], rtol=0, atol=1e-6)
    assert runs["losses"][0][1] < runs["losses"][0][0]
    step_j = jax_mh.make_multihost_train_step(
        jax_mh.multihost_mesh(), scene.patches, scene.screen_plane,
        jnp.zeros((32, 32), jnp.float32), resolution=32, learning_rate=1e-4)
    _, loss_j = step_j(jax_params_from_scene(scene), scene.start, scene.direction)
    # jitted XLA moves some pixels (see the render test): 1.9e-5 measured
    np.testing.assert_allclose(runs["losses"][0][0], float(loss_j), rtol=1e-4)


def test_two_rank_ortho_render_and_step(two_ranks):
    """Rays made on each rank from the OrthoGrid: the image equals the
    uploaded-ray render of the same grid (the grid's rays are bit-equal to
    the host grid's), and the step equals the uploaded-ray step."""
    _, _, runs = two_ranks
    np.testing.assert_array_equal(runs["img_ortho"][0], runs["img_ortho"][1])
    np.testing.assert_array_equal(runs["img_ortho"][0], runs["img"][0])
    np.testing.assert_array_equal(runs["ortho_losses"][0], runs["ortho_losses"][1])
    np.testing.assert_array_equal(runs["ortho_losses"][0], runs["losses"][0])
    np.testing.assert_array_equal(runs["ortho_grad_cp"][0], runs["grad_cp"][0])
    np.testing.assert_array_equal(runs["ortho_cp1"][0], runs["cp1"][0])


def test_two_rank_emitter_render_and_step(two_ranks):
    """The emitter render of two ranks against one process's
    render_emitter_image_device (atol 2e-4, the JAX test's) and against the
    JAX `render_multihost_emitter`; three emitter steps from a lens 2 %
    too large descend, with a finite nonzero gradient."""
    scene, patches, runs = two_ranks
    a, b = runs["img_emitter"]
    np.testing.assert_array_equal(a, b)
    screen = torch.tensor(np.asarray(scene.screen_plane))
    em = DeviceEmitter(EMITTER_ORIGIN, 5, 2048, 3)
    one = render_emitter_image_device(patches, scene.refractive_index, em, screen,
                                      resolution=32).numpy()
    assert one.sum() > 100
    np.testing.assert_allclose(a, one, rtol=0, atol=2e-4)
    img_j = np.asarray(jax_mh.render_multihost_emitter(
        jax_mh.multihost_mesh(), scene.patches, scene.refractive_index,
        JaxEmitter(EMITTER_ORIGIN, 5, 2048, 3), scene.screen_plane, resolution=32))
    np.testing.assert_allclose(a, img_j, rtol=0, atol=2e-4 * img_j.max())
    losses = runs["emitter_losses"][0]
    np.testing.assert_array_equal(losses, runs["emitter_losses"][1])
    assert np.isfinite(losses).all() and losses[2] < losses[0]
    assert np.isfinite(runs["emitter_grad_norm"][0]) and runs["emitter_grad_norm"][0] > 0
