"""Ray- and patch-sharded steps (cbtr_tpu_torch/parallel/sharding.py,
patch_parallel.py), `refract_rays(intersect_fn=)` and the entry points
(cbtr_tpu_torch/entry.py) against the single-process port and the JAX
package's parallel/ functions.

Counterpart of tests/test_parallel.py.  The multi-rank cases run in ONE
four-rank gloo group of fresh processes, a ('rays', 'patches') mesh of
2 x 2 and a ('patches',) mesh of 4 over the same ranks (a `file://` store
under tmp_path, one thread a rank, killed after 120 s); this process holds
what they saved against the JAX functions on the virtual 8-device CPU mesh
(tests/conftest.py) and against the port in one process.  Both packages
read the same patch tables (the JAX build's) and the same rays.
"""
import inspect
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from cbtr_tpu.models import sphere_lens_scene as jax_sphere_scene
from cbtr_tpu.ops import intersect_rays as jax_intersect_rays
from cbtr_tpu.parallel import intersect_rays_patch_sharded as jax_patch_sharded
from cbtr_tpu.parallel import patch_parallel as jax_pp

from cbtr_tpu_torch import entry
from cbtr_tpu_torch.convert import patches_from_numpy
from cbtr_tpu_torch.models import lens_model, scenes
from cbtr_tpu_torch.ops import cuda_codes, cuda_sweep, cuda_tables
from cbtr_tpu_torch.ops.intersect import WHAT_INTERSECT, WHAT_NONE, intersect_rays
from cbtr_tpu_torch.optics.lens import (REFRACT_INSIDE, refract_rays,
                                        trace_through_lens)
from cbtr_tpu_torch.parallel import multihost, patch_parallel, sharding

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 120


def run_ranks(script: str, world: int, tmp_path):
    """Run `script` in `world` fresh processes, rank r as `script r world
    store tmp_path`, each with one thread; fail (and kill them all) if any
    has not exited within RANK_TIMEOUT_S or one exits non-zero."""
    # gloo on the loopback interface: the ranks talk to this machine only
    env = dict(os.environ, OMP_NUM_THREADS="1", GLOO_SOCKET_IFNAME="lo")
    env.pop("XLA_FLAGS", None)
    logs = [open(tmp_path / f"rank{r}.log", "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), str(world),
                               str(tmp_path / "store"), str(tmp_path)],
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


def _jax_scene(sectors, belts, res):
    """A JAX sphere scene and the port's copy of its patch tables."""
    scene = jax_sphere_scene(res=res, sectors=sectors, belts=belts)
    return scene, patches_from_numpy(
        {k: np.asarray(v) for k, v in scene.patches._asdict().items()}, device="cpu")


def _leaves(patches, prefix):
    return {prefix + k: v.numpy() for k, v in patches.leaves().items()}


_RANKS = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from cbtr_tpu_torch import entry
from cbtr_tpu_torch.convert import patches_from_numpy
from cbtr_tpu_torch.models import lens_model
from cbtr_tpu_torch.parallel import multihost, sharding
from cbtr_tpu_torch.parallel.patch_parallel import intersect_rays_patch_sharded

rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
assert multihost.init_distributed(f"file://{store}", world, rank, backend="gloo")
mesh2 = init_device_mesh("cpu", (2, 2), mesh_dim_names=("rays", "patches"))
mesh1 = init_device_mesh("cpu", (4,), mesh_dim_names=("patches",))
a = np.load(f"{out}/inputs.npz")


def lens(prefix):
    return patches_from_numpy({k[len(prefix):]: a[k] for k in a.files if k.startswith(prefix)},
                              device="cpu")


p9, p7 = lens("p9_"), lens("p7_")
s, d, screen = torch.tensor(a["start"]), torch.tensor(a["direction"]), torch.tensor(a["screen"])
r = {}
for name, hit in (
        ("rp", intersect_rays_patch_sharded(p9, s[:64], d[:64], mesh2, ray_axis="rays")),
        ("p", intersect_rays_patch_sharded(p7, s[:64], d[:64], mesh1))):
    for field in ("what", "patch", "distance", "point"):
        r[f"{name}_{field}"] = getattr(hit, field)
step = sharding.make_sharded_train_step(mesh2, screen, torch.zeros((32, 32)), resolution=32,
                                        learning_rate=1e-4, patch_axis="patches")
params, loss = step(lens_model.LensParams(p9, float(a["n"])), s, d)
r["loss"], r["grad_cp"] = loss, params.control_points.grad
r["grad_n"], r["cp1"] = params.refractive_index.grad, params.control_points
r["dryrun_loss"] = np.float32(entry.dryrun_multichip(4, device="cpu"))
np.savez(f"{out}/rank{rank}.npz", **{k: v.detach().numpy() if torch.is_tensor(v) else v
                                     for k, v in r.items()})
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    """The JAX sphere 9 x 4 scene at 32^2 rays (the JAX tests' scene), the
    sphere 7 x 3 (126 patches: 2 padding rows over 4 ranks), and what four
    gloo ranks computed with them: {name: [rank 0 .. rank 3]}."""
    tmp_path = tmp_path_factory.mktemp("parallel")
    scene9, p9 = _jax_scene(9, 4, 32)
    scene7, p7 = _jax_scene(7, 3, 4)
    np.savez(tmp_path / "inputs.npz", **_leaves(p9, "p9_"), **_leaves(p7, "p7_"),
             start=np.asarray(scene9.start), direction=np.asarray(scene9.direction),
             screen=np.asarray(scene9.screen_plane), n=scene9.refractive_index)
    run_ranks(_RANKS, 4, tmp_path)
    runs = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(4)]
    return (scene9, p9, scene7, p7), {k: [run[k] for run in runs] for k in runs[0]}


def test_patch_sharded_winners_match_jax_and_intersect_rays(four_ranks):
    """64 rays.  On the 2 x 2 mesh each rank holds the RayHit of its ray
    shard (ranks 0-1 rays 0-31, ranks 2-3 rays 32-63), the same within a
    ray group; on the ('patches',) mesh of 4 every rank holds all 64.
    Winners equal the port's `intersect_rays` and the JAX function's on its
    (4, 2) and (8,) meshes; distances and points bit-equal to the port's
    `intersect_rays` (the same recompute of the same winners), distances
    within 1e-4 relative of the JAX package's (its test's bar)."""
    (scene9, p9, scene7, p7), runs = four_ranks
    devices = np.asarray(jax.devices())
    cases = (("rp", scene9, p9, Mesh(devices.reshape(4, 2), ("rays", "patches")), "rays"),
             ("p", scene7, p7, Mesh(devices, ("patches",)), None))
    s, d = np.asarray(scene9.start)[:64], np.asarray(scene9.direction)[:64]
    for name, scene, patches, mesh_j, ray_axis in cases:
        got = {f: runs[f"{name}_{f}"] for f in ("what", "patch", "distance", "point")}
        if ray_axis:
            for f, v in got.items():
                for lo, hi in ((0, 1), (2, 3)):
                    np.testing.assert_array_equal(v[lo], v[hi])
                got[f] = np.concatenate([v[0], v[2]])
        else:
            for f, v in got.items():
                for other in v[1:]:
                    np.testing.assert_array_equal(other, v[0])
                got[f] = v[0]
        want = intersect_rays(patches, torch.tensor(s), torch.tensor(d))
        hit_j = jax_patch_sharded(scene.patches, jnp.asarray(s), jnp.asarray(d), mesh_j,
                                  ray_axis=ray_axis)
        ref_j = jax_intersect_rays(scene.patches, jnp.asarray(s), jnp.asarray(d))
        assert (got["what"] == WHAT_INTERSECT).sum() >= 16, name
        for f in ("what", "patch"):
            np.testing.assert_array_equal(got[f], getattr(want, f).numpy(), err_msg=name)
            np.testing.assert_array_equal(got[f], np.asarray(getattr(hit_j, f)), err_msg=name)
            np.testing.assert_array_equal(got[f], np.asarray(getattr(ref_j, f)), err_msg=name)
        for f in ("distance", "point"):
            np.testing.assert_array_equal(got[f], getattr(want, f).detach().numpy(),
                                          err_msg=name)
        np.testing.assert_allclose(got["distance"], np.asarray(hit_j.distance), rtol=1e-4)


def test_patch_sharded_step_gradient_is_the_one_process_gradient(four_ranks):
    """The ('rays', 'patches') SGD step through `refract_rays(intersect_fn=)`
    on 1024 rays: loss, gradients and parameters the same on all four
    ranks; the gradient the one-process gradient within f32 summation
    order (2e-5 of max |g|: the image and the gradients are summed over
    the two ray ranks, and only over them), the loss within 1e-6."""
    (scene9, p9, _, _), runs = four_ranks
    for key in ("loss", "grad_cp", "grad_n", "cp1", "dryrun_loss"):
        for other in runs[key][1:]:
            np.testing.assert_array_equal(other, runs[key][0])
    params = lens_model.LensParams(p9, scene9.refractive_index)
    loss = lens_model.lens_loss(params, torch.tensor(np.asarray(scene9.start)),
                                torch.tensor(np.asarray(scene9.direction)),
                                torch.tensor(np.asarray(scene9.screen_plane)),
                                torch.zeros(32, 32), resolution=32)
    loss.backward()
    g = params.control_points.grad.numpy()
    assert np.abs(g).max() > 0
    np.testing.assert_allclose(runs["loss"][0], loss.item(), rtol=1e-6)
    np.testing.assert_allclose(runs["grad_cp"][0], g, rtol=0, atol=2e-5 * np.abs(g).max())
    np.testing.assert_allclose(runs["grad_n"][0], params.refractive_index.grad.item(),
                               rtol=2e-5)


def test_dryrun_multichip_four_ranks_is_the_one_process_step(four_ranks):
    """dryrun_multichip(4): a (2, 2) mesh, 8 rays a ray rank; its loss is
    the one-process loss of the same 16 rays."""
    _, runs = four_ranks
    sc = scenes.sphere_lens_scene(res=8, sectors=5, belts=2, device="cpu")
    with torch.no_grad():
        loss = lens_model.lens_loss(lens_model.params_from_scene(sc), sc.start[:16],
                                    sc.direction[:16], sc.screen_plane, torch.zeros(8, 8),
                                    resolution=8)
    assert np.isfinite(runs["dryrun_loss"][0])
    np.testing.assert_allclose(runs["dryrun_loss"][0], float(loss), rtol=1e-6)


@pytest.fixture(scope="module")
def sphere():
    return _jax_scene(9, 4, 16)


def test_intersect_fn_none_is_bit_equal(sphere):
    """intersect_fn=None keeps the `intersect_rays` call bit for bit: the
    same outputs as an explicit intersect_fn=intersect_rays, gradients
    included."""
    scene, patches = sphere
    s = torch.tensor(np.asarray(scene.start))
    d = torch.tensor(np.asarray(scene.direction))
    outs = []
    for fn in (None, intersect_rays):
        cp = patches.control_points.clone().requires_grad_(True)
        p = patches.replace(control_points=cp)
        s1, d1, st = refract_rays(p, scene.refractive_index, s, d, REFRACT_INSIDE,
                                  intersect_fn=fn)
        traced = trace_through_lens(p, scene.refractive_index, s, d, intersect_fn=fn)
        (s1.sum() + traced[0].sum() + traced[1].sum()).backward()
        outs.append((s1, d1, st, *traced, cp.grad))
    assert int((outs[0][2] == REFRACT_INSIDE).sum()) >= 16
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_world_of_one_patch_sharded_is_intersect_rays(sphere):
    """mesh=None: the staged sweep (K3's twin, then the select) gives
    `intersect_rays`' RayHit bit for bit, and the patch-sharded train step
    its loss and gradients."""
    scene, patches = sphere
    s = torch.tensor(np.asarray(scene.start))
    d = torch.tensor(np.asarray(scene.direction))
    want = intersect_rays(patches, s, d)
    for backend in ("auto", "plain"):
        got = patch_parallel.intersect_rays_patch_sharded(patches, s, d, None,
                                                          backend=backend)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    with pytest.raises(ValueError):
        patch_parallel.intersect_rays_patch_sharded(patches, s, d, None, backend="pallas")
    screen = torch.tensor(np.asarray(scene.screen_plane))
    target = torch.zeros(32, 32)
    results = []
    for step in (lens_model.make_train_step(screen, target, resolution=32,
                                            learning_rate=1e-4),
                 sharding.make_sharded_train_step(None, screen, target, resolution=32,
                                                  learning_rate=1e-4,
                                                  patch_axis="patches")):
        params, loss = step(lens_model.LensParams(patches, scene.refractive_index), s, d)
        results.append((loss, params.control_points.grad, params.refractive_index.grad,
                        params.control_points))
    for a, b in zip(*results):
        assert torch.equal(a, b)


def test_pad_patches_give_no_candidate_from_the_origin(sphere):
    """pad_patches adds zero rows (the JAX function's); rays that start at
    the origin, inside the padding rows' degenerate spheres, get no
    candidate from them in K3's twin, the real rows' codes and distances
    are the unpadded sweep's, and the plain table builders take them
    (finite tables, every padding row's sphere of radius 1e-5 at the
    origin)."""
    scene, patches = sphere
    padded = patch_parallel.pad_patches(patches, 5)
    P = patches.num_patches
    assert padded.num_patches == 220 and P == 216
    want = jax_pp.pad_patches(scene.patches, 5)
    for name, leaf in padded.leaves().items():
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(getattr(want, name)))
    assert patch_parallel.pad_patches(patches, 4) is patches
    rng = np.random.default_rng(0)
    d = np.stack([np.ones(512), 0.12 * rng.normal(size=512), 0.12 * rng.normal(size=512)], -1)
    d = torch.tensor((d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32))
    s = torch.zeros_like(d)
    code, dist = cuda_codes.sweep_codes_reference(padded, s, d)
    code0, dist0 = cuda_codes.sweep_codes_reference(patches, s, d)
    assert ((code[:, P:] & 7) == WHAT_NONE).all()
    assert torch.equal(code[:, :P], code0) and torch.equal(dist[:, :P], dist0)
    assert int(((code0 & 7) == WHAT_INTERSECT).sum()) > 100
    patch_t, _, nb = cuda_tables.build_tables_reference(padded, cuda_codes.BLOCK_P)
    assert torch.isfinite(patch_t).all()
    np.testing.assert_array_equal(nb[P:padded.num_patches].numpy(), 0)
    center, radius = cuda_sweep.patch_spheres(padded)
    assert (center[P:] == 0).all() and (radius[P:] == np.float32(1e-5)).all()


def test_entry_renders_the_robot():
    fn, args = entry.entry(device="cpu")
    img = fn(*args)
    assert img.shape == (32, 32) and torch.isfinite(img).all() and float(img.sum()) > 10
    assert args[2].shape == (1024, 3)


def test_no_process_group_is_a_world_of_one():
    assert sharding.ray_device_mesh() is None and multihost.multihost_mesh() is None
    with pytest.raises(ValueError):
        sharding.ray_device_mesh(2)
    with pytest.raises(ValueError):
        entry.dryrun_multichip(2, device="cpu")
    assert np.isfinite(entry.dryrun_multichip(1, device="cpu"))


@pytest.mark.parametrize("fn", [entry.entry, entry.dryrun_multichip,
                                multihost.process_ray_shard])
def test_parallel_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"
