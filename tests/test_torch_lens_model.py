"""Refraction, splat, image, loss, gradients and one SGD step against the
JAX package.

The JAX package's patches and rays are handed over as NumPy
(`convert.patches_from_numpy`, `convert.params_from_numpy`), so both
packages trace the same lens.  The JAX side runs on the CPU through its XLA
path, op by op (`jax.disable_jit()`) for the image, loss and gradients:
jitted XLA code on the CPU rounds the four fixed Newton iterations
differently, and on rays where they are unconverged that moves hit points
and normals by up to 1e-2 (ROADMAP queue C), while op by op the robot image
and loss come out bit-identical to the port's.  The port's winner search is
the kernel's plain twin.
"""
import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cbtr_tpu.models import lens_model as jax_lm
from cbtr_tpu.models import scenes as jax_scenes
from cbtr_tpu.optics import lens as jax_lens
from cbtr_tpu.render import render as jax_render

from cbtr_tpu_torch.convert import params_from_numpy, patches_from_numpy
from cbtr_tpu_torch.models import lens_model
from cbtr_tpu_torch.optics import lens
from cbtr_tpu_torch.render import render

torch.set_num_threads(2)
RES = 128
LR = 1e-3


def _to_port(scene):
    patches = patches_from_numpy(
        {k: np.asarray(v) for k, v in scene.patches._asdict().items()}, device="cpu")
    return (patches, torch.tensor(np.asarray(scene.start)),
            torch.tensor(np.asarray(scene.direction)),
            torch.tensor(np.asarray(scene.screen_plane)))


@pytest.fixture(scope="module")
def sphere():
    scene = jax_scenes.sphere_lens_scene(res=16, sectors=9, belts=4)
    return scene, _to_port(scene)


@pytest.fixture(scope="module")
def robot():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CBTR_NATIVE", "0")
        scene = jax_scenes.robot_lens_scene(res=32)
    return scene, _to_port(scene)


@pytest.mark.parametrize("expected", [lens.REFRACT_INSIDE, lens.REFRACT_OUTSIDE])
def test_refract_rays_status_matches_jax(sphere, expected):
    """Entering rays from the grid, and exiting rays started inside the
    glass: equal status codes, refracted rays allclose 1e-4."""
    scene, (patches, start, direction, _) = sphere
    if expected == lens.REFRACT_OUTSIDE:
        # start inside the glass (every scene centres its lens at x = 5)
        rng = np.random.default_rng(4)
        s = np.array([5.0, 0.0, 0.0], np.float32) + rng.uniform(
            -0.3, 0.3, (64, 3)).astype(np.float32)
        d = rng.normal(size=(64, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        start, direction = torch.tensor(s), torch.tensor(d)
    ref = jax_lens.refract_rays(scene.patches, scene.refractive_index,
                                start.numpy(), direction.numpy(), expected)
    got = lens.refract_rays(patches, scene.refractive_index, start, direction,
                            expected)
    st = np.asarray(ref[2])
    np.testing.assert_array_equal(got[2].numpy(), st)
    assert (st == expected).sum() >= 16
    for a, b in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-4)


def test_trace_through_lens_matches_jax(robot):
    """Entry then exit on the robot lens (jitted reference): the same rays
    survive both refractions.  The outgoing rays themselves are held by the
    bit-identical image below."""
    scene, (patches, start, direction, _) = robot
    ref = jax_lens.trace_through_lens(scene.patches, scene.refractive_index,
                                      start.numpy(), direction.numpy())
    got = lens.trace_through_lens(patches, scene.refractive_index, start, direction)
    alive = np.asarray(ref[2])
    np.testing.assert_array_equal(got[2].numpy(), alive)
    assert alive.sum() >= 100


@pytest.fixture(scope="module")
def splat_inputs():
    rng = np.random.default_rng(11)
    pts = rng.normal(size=(2000, 2)).astype(np.float32) * 2.5
    pts[:10] *= 1e12          # far off screen: beyond int range once scaled
    w = rng.uniform(0.0, 1.0, 2000).astype(np.float32)
    return pts, w


def test_splat_forms_match_jax(splat_inputs, monkeypatch):
    """Outer-product form, scatter form and the JAX package's splat agree
    (atol 1e-5: f32 sums over 2000 points in different orders)."""
    pts, w = splat_inputs
    ref = np.asarray(jax_render.splat_bilinear(jnp.asarray(pts), jnp.asarray(w),
                                               4.0, RES))
    matmul = render.splat_bilinear(torch.tensor(pts), torch.tensor(w), 4.0, RES)
    monkeypatch.setattr(render, "_SPLAT_MATMUL_MAX_BYTES", 0)
    scatter = render.splat_bilinear(torch.tensor(pts), torch.tensor(w), 4.0, RES)
    assert np.isfinite(ref).all() and ref.sum() > 100
    for img in (matmul, scatter):
        assert torch.isfinite(img).all()
        np.testing.assert_allclose(img.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("limit", [render._SPLAT_MATMUL_MAX_BYTES, 0])
def test_splat_drops_far_off_screen_points(monkeypatch, limit):
    """A coordinate beyond int range lands nowhere (the index is clamped
    before its cast), in the outer-product form and in the scatter form."""
    monkeypatch.setattr(render, "_SPLAT_MATMUL_MAX_BYTES", limit)
    pts = torch.tensor([[3e12, 0.0], [-3e12, 1.0], [0.0, 5e30], [0.0, 0.0]])
    w = torch.tensor([1.0, 1.0, 1.0, 0.5])
    img = render.splat_bilinear(pts, w, 4.0, 16)
    assert torch.isfinite(img).all()
    torch.testing.assert_close(img.sum(), torch.tensor(0.5))


@pytest.fixture(scope="module")
def robot_train(robot):
    """JAX value, gradient and one SGD step on the robot lens (zero
    target, the bench's loss), plus the port's params from the same
    numbers."""
    scene, (patches, start, direction, screen) = robot
    target = np.zeros((RES, RES), np.float32)
    params = jax_lm.params_from_scene(scene)

    def loss_fn(p):
        return jax_lm.lens_loss(p, scene.patches, scene.start, scene.direction,
                                scene.screen_plane, jnp.asarray(target),
                                resolution=RES)

    with jax.disable_jit():
        img = jax_lm.lens_forward(params, scene.patches, scene.start,
                                  scene.direction, scene.screen_plane,
                                  resolution=RES)
        loss, grads = jax.value_and_grad(loss_fn)(params)
    port_params = params_from_numpy(np.asarray(params.control_points),
                                    np.asarray(params.refractive_index), patches)
    g_cp = np.asarray(grads.control_points)
    g_ri = float(grads.refractive_index)
    return dict(img=np.asarray(img), loss=float(loss), g_cp=g_cp, g_ri=g_ri,
                # make_train_step's update (cbtr_tpu/models/lens_model.py:88-93)
                cp1=np.asarray(params.control_points) - LR * g_cp,
                ri1=float(params.refractive_index) - LR * g_ri,
                port=(port_params, start, direction, screen, torch.tensor(target)))


def test_render_lens_image_matches_jax(robot_train):
    """Image allclose rtol 1e-4 / atol 1e-5 (f32 sums of the splat product;
    measured: bit-identical against the op-by-op reference)."""
    params, start, direction, screen, _ = robot_train["port"]
    with torch.no_grad():
        img = lens_model.lens_forward(params, start, direction, screen,
                                      resolution=RES)
    assert img.shape == (RES, RES) and torch.isfinite(img).all()
    assert robot_train["img"].sum() > 10
    np.testing.assert_allclose(img.numpy(), robot_train["img"], rtol=1e-4, atol=1e-5)


def test_loss_and_gradients_match_jax(robot_train):
    """Loss rtol 1e-4.  Gradients rtol 1e-3, atol 1e-5 x max|g|: the
    backward sums per-ray contributions into the control points through the
    gather's scatter-add, in another order than XLA.  With a bit-identical
    forward pass, 3 of the 13,500 control-point entries (all of patch 238)
    still differ by 1.3e-3..2.5e-3 relative: the backward's rounding order
    through the Newton iterations.  So at most 0.05% of the entries may
    exceed the bar, none rtol 5e-3."""
    params, start, direction, screen, target = robot_train["port"]
    params.zero_grad(set_to_none=True)
    loss = lens_model.lens_loss(params, start, direction, screen, target,
                                resolution=RES)
    loss.backward()
    np.testing.assert_allclose(loss.item(), robot_train["loss"], rtol=1e-4)
    g_cp = robot_train["g_cp"]
    got = params.control_points.grad.numpy()
    atol = 1e-5 * np.abs(g_cp).max()
    assert atol > 0
    outside = ~np.isclose(got, g_cp, rtol=1e-3, atol=atol)
    assert outside.mean() <= 5e-4, np.argwhere(outside)
    np.testing.assert_allclose(got, g_cp, rtol=5e-3, atol=atol)
    np.testing.assert_allclose(float(params.refractive_index.grad),
                               robot_train["g_ri"], rtol=1e-3)


def test_one_sgd_step_matches_jax(robot_train):
    params, start, direction, screen, target = robot_train["port"]
    params = params_from_numpy(params.control_points.detach().numpy(),
                               params.refractive_index.detach().numpy(),
                               params.patches())
    step = lens_model.make_train_step(screen, target, resolution=RES,
                                      learning_rate=LR)
    params, loss = step(params, start, direction)
    np.testing.assert_allclose(float(loss), robot_train["loss"], rtol=1e-4)
    np.testing.assert_allclose(params.control_points.detach().numpy(),
                               robot_train["cp1"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(params.refractive_index.item(), robot_train["ri1"],
                               rtol=1e-6)


def test_gradient_is_bit_reproducible(robot_train):
    """Two gradients at one fixed lens are bit-equal.  The recompute's row
    gather adds its backward with the fixed-order segment sum
    (`ops/cuda_segment.py`): its plain version here, its kernel on the card,
    where chip_smoke.py holds the headline gradient bit-equal too."""
    params, start, direction, screen, target = robot_train["port"]
    grads = []
    for _ in range(2):
        params.zero_grad(set_to_none=True)
        lens_model.lens_loss(params, start, direction, screen, target,
                             resolution=RES).backward()
        grads.append((params.control_points.grad.clone(),
                      params.refractive_index.grad.clone()))
    assert grads[0][0].abs().max() > 0
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the fit step's CUDA graph: when it captures and replays, and what stays
# the same on the eager path (the capture itself runs only on the card:
# tests/test_torch_step_graph_card.py)
# ---------------------------------------------------------------------------

_CUDA = torch.device("cuda")


@pytest.mark.parametrize("case", ["cpu", "grad_off", "rays_need_grad", "counting",
                                  "spans_on", "timing", "spans_on_and_timing", "none"])
def test_eager_reason_reads_the_switches(case):
    """Rays off the card, grad mode off, rays that need a gradient,
    counting() and spans_on() each make the step run eagerly; timing()
    alone, and nothing, let it replay."""
    from cbtr_tpu_torch.utils import profiling

    switches = {"counting": profiling.counting, "spans_on": profiling.spans_on,
                "timing": profiling.timing}
    want_eager = case not in ("timing", "none")
    with contextlib.ExitStack() as stack:
        for name in case.split("_and_"):
            if name in switches:
                stack.enter_context(switches[name]())
        if case == "grad_off":
            stack.enter_context(torch.no_grad())
        reason = lens_model.eager_reason(torch.device("cpu") if case == "cpu" else _CUDA,
                                         rays_need_grad=case == "rays_need_grad")
    assert (reason is not None) == want_eager, reason


@pytest.mark.parametrize("index", range(len(lens_model.GRAPH_PATH)))
def test_eager_reason_sees_a_rebound_path_function(index, monkeypatch):
    """Each function of the step's path re-bound (a caller's hook) makes it
    run eagerly; put back, the step may replay again."""
    module, name = lens_model.GRAPH_PATH[index]
    assert lens_model.eager_reason(_CUDA) is None
    original = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *args, **kwargs: original(*args, **kwargs))
    assert name in lens_model.eager_reason(_CUDA)
    monkeypatch.setattr(module, name, original)
    assert lens_model.eager_reason(_CUDA) is None


def test_step_path_warms_captures_then_replays():
    """The first eligible call with a key warms up, the second captures,
    later ones replay; a new key drops the graph and warms up again."""
    step = lens_model.make_opt_train_step(torch.zeros(4), torch.zeros((2, 2)), resolution=2)
    assert [step.path(("a",)), step.path(("a",))] == ["eager", "capture"]
    step._graph = types.SimpleNamespace(key=("a",))
    assert [step.path(("a",)), step.path(("a",))] == ["replay", "replay"]
    assert step.path(("b",)) == "eager" and step._graph is None
    assert [step.path(("a",)), step.path(("a",))] == ["eager", "capture"]


def test_graph_key_follows_what_the_graph_reads(sphere):
    """The key changes with the parameters' storage, a parameter's
    requires_grad, the rays' shape and the sweep's mode; equal calls give
    equal keys."""
    from cbtr_tpu_torch.ops import intersect

    _, (patches, start, direction, _) = sphere
    params = lens_model.LensParams(patches, 1.3)
    opt = torch.optim.Adam(params.parameters(), lr=1e-3)
    key = lens_model.graph_key(params, opt, start, direction)
    assert lens_model.graph_key(params, opt, start, direction) == key
    params.refractive_index.requires_grad_(False)
    assert lens_model.graph_key(params, opt, start, direction) != key
    params.refractive_index.requires_grad_(True)
    assert lens_model.graph_key(params, opt, start[:-1], direction[:-1]) != key
    with intersect.using_mode(intersect.MODES["fast"]):
        assert lens_model.graph_key(params, opt, start, direction) != key
    other = lens_model.LensParams(patches, 1.3)
    assert lens_model.graph_key(other, opt, start, direction) != key
    assert lens_model.graph_key(params, opt, start, direction) == key


@pytest.mark.parametrize("expected", [lens.REFRACT_INSIDE, lens.REFRACT_OUTSIDE])
def test_refract_rays_takes_python_and_tensor_inputs_alike(sphere, expected):
    """An int `expected` and a float index give outputs torch.equal to
    those of an i32 tensor and an f32 tensor."""
    _, (patches, start, direction, _) = sphere
    if expected == lens.REFRACT_OUTSIDE:
        start = start + torch.tensor([5.0, 0.0, 0.0]) - start.mean(dim=0)
    plain = lens.refract_rays(patches, 1.3, start, direction, expected)
    tensors = lens.refract_rays(patches, torch.tensor(1.3), start, direction,
                                torch.tensor(expected, dtype=torch.int32))
    assert int((plain[2] == expected).sum()) >= 16
    for a, b in zip(plain, tensors):
        assert torch.equal(a, b)


def test_index_pair_rounds_as_the_tensor_path():
    """The host's f32 pair (1 / n, n) of a Python float equals the f32
    tensor path's bit for bit, over many indices."""
    for n in np.linspace(1.0, 2.5, 997).tolist() + [1.3, 1.5, 4.0 / 3.0]:
        inv, ri = lens._index_pair(n, torch.device("cpu"))
        t_inv, t_ri = lens._index_pair(torch.tensor(n), torch.device("cpu"))
        assert torch.equal(torch.tensor(inv, dtype=torch.float32), t_inv), n
        assert torch.equal(torch.tensor(ri, dtype=torch.float32), t_ri), n


def test_eager_adam_step_is_its_old_body_over_three_steps(sphere):
    """On the CPU the step runs eagerly (counted `cbtr.step.eager` under
    timing()): its losses, gradients and parameters over 3 Adam steps are
    torch.equal to the body it had before it had a graph."""
    from cbtr_tpu_torch.harness import step_graph
    from cbtr_tpu_torch.utils import profiling

    _, (patches, start, direction, screen) = sphere
    target = torch.linspace(0.0, 2.0, 32 * 32).reshape(32, 32)
    runs = []
    for make in (lens_model.make_opt_train_step, step_graph.eager_twin):
        params = lens_model.LensParams(patches, 1.3)
        opt = torch.optim.Adam([params.control_points, params.refractive_index], lr=1e-3)
        step, out = make(screen, target, resolution=32), []
        with profiling.timing() as times:
            for _ in range(3):
                _, _, loss = step(params, opt, start, direction)
                out += [loss, params.control_points.grad.clone(),
                        params.refractive_index.grad.clone(),
                        params.control_points.detach().clone(),
                        params.refractive_index.detach().clone()]
        runs.append((out, {k: v[1] for k, v in times.items() if k.startswith("cbtr.step.")
                           and k.split(".")[-1] in ("eager", "capture", "replay")}))
    (new, new_counts), (old, _) = runs
    assert new_counts == {"cbtr.step.eager": 3}
    assert float(new[0]) > 0
    for a, b in zip(new, old):
        assert torch.equal(a, b)
    # the lens moved: step 3's control points are not step 1's
    assert not torch.equal(new[3], new[3 + 5 * 2])
