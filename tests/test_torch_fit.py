"""The fit loop, its checkpoints and the optimizer step against the JAX
package.

Counterpart of tests/test_fit_resume.py:22-58, 110-162 on the small sphere
(12^2 rays, 9 sectors x 4 belts).  Both packages fit the same lens: the
JAX scene's patches and rays are handed over as NumPy.  On the CPU the
port's step is bit-reproducible, so a killed and resumed SGD fit equals the
uninterrupted one bit for bit.  Against the JAX package the SGD fit is held
allclose (jitted XLA rounds the four fixed Newton iterations on unconverged
rays otherwise than torch, ROADMAP queue C); one Adam update on the same
gradient is held to optax.adam at rtol 1e-6, and a ten-step Adam fit
loosely.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cbtr_tpu.models import lens_model as jax_lm
from cbtr_tpu.models import scenes as jax_scenes
from cbtr_tpu.models.fit import fit_lens as jax_fit_lens

from cbtr_tpu_torch.convert import params_from_numpy, patches_from_numpy
from cbtr_tpu_torch.models import fit, lens_model, scenes
from cbtr_tpu_torch.models.fit import emitter_rays, fit_emitter_lens, fit_lens
from cbtr_tpu_torch.utils import checkpoint, prng

torch.set_num_threads(2)
RES = 12


@pytest.fixture(scope="module")
def jax_scene():
    return jax_scenes.sphere_lens_scene(res=RES, sectors=9, belts=4)


@pytest.fixture(scope="module")
def scene(jax_scene):
    """The JAX scene's lens and rays as a port LensScene on the CPU."""
    patches = patches_from_numpy(
        {k: np.asarray(v) for k, v in jax_scene.patches._asdict().items()}, device="cpu")
    return scenes.LensScene(
        patches=patches, start=torch.tensor(np.asarray(jax_scene.start)),
        direction=torch.tensor(np.asarray(jax_scene.direction)),
        screen_plane=torch.tensor(np.asarray(jax_scene.screen_plane)),
        refractive_index=jax_scene.refractive_index, fellow=jax_scene.fellow,
        fellow_starts=jax_scene.fellow_starts)


def _zeros():
    return torch.zeros((RES, RES), dtype=torch.float32)


def test_fit_descends_and_checkpoints(scene, tmp_path):
    calls = []
    params, losses = fit_lens(scene, _zeros(), steps=4, checkpoint_dir=str(tmp_path),
                              checkpoint_every=2, learning_rate=1e-4,
                              on_step=lambda s, l: calls.append((s, l)), device="cpu")
    assert len(losses) == 4 and losses[-1] < losses[0]
    assert calls == list(enumerate(losses))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["ckpt_2.npz", "ckpt_4.npz"]
    loaded, step = checkpoint.load_params(str(tmp_path / "ckpt_4.npz"), scene.patches,
                                          device="cpu")
    assert step == 4
    assert torch.equal(loaded.control_points, params.control_points)
    assert torch.equal(loaded.refractive_index, params.refractive_index)


def test_fit_resume_matches_uninterrupted_run(scene, tmp_path):
    """Kill-and-resume lands on bit-identical parameters: 3 steps + resume
    to 6 == 6 straight (the CPU step is deterministic)."""
    p_straight, l_straight = fit_lens(scene, _zeros(), steps=6, learning_rate=1e-4,
                                      device="cpu")
    ckpt = str(tmp_path / "ckpts")
    fit_lens(scene, _zeros(), steps=3, checkpoint_dir=ckpt, checkpoint_every=1,
             learning_rate=1e-4, device="cpu")
    p_resumed, l_resumed = fit_lens(scene, _zeros(), steps=6, checkpoint_dir=ckpt,
                                    checkpoint_every=1, learning_rate=1e-4,
                                    device="cpu")
    assert len(l_resumed) == 3
    assert torch.equal(p_straight.control_points, p_resumed.control_points)
    assert torch.equal(p_straight.refractive_index, p_resumed.refractive_index)
    assert l_resumed == l_straight[3:]


def test_nan_target_raises(scene):
    target = torch.full((RES, RES), float("nan"))
    with pytest.raises(FloatingPointError, match="step 0"):
        fit_lens(scene, target, steps=2, device="cpu")


def test_sgd_fit_matches_jax(jax_scene, scene):
    """4 SGD steps of each package's fit_lens from the same control points:
    losses rtol 1e-4, parameters within 1e-5 (measured against jitted XLA:
    losses 1.8e-6 relative, control points 2.9e-6 on 6 of 6480 entries,
    refractive index 2.4e-7)."""
    target = np.zeros((RES, RES), np.float32)
    p_j, l_j = jax_fit_lens(jax_scene, jnp.asarray(target), steps=4, learning_rate=1e-4)
    p, losses = fit_lens(scene, target, steps=4, learning_rate=1e-4, device="cpu")
    np.testing.assert_allclose(losses, l_j, rtol=1e-4)
    np.testing.assert_allclose(p.control_points.detach().numpy(),
                               np.asarray(p_j.control_points), rtol=0, atol=1e-5)
    np.testing.assert_allclose(p.refractive_index.item(), float(p_j.refractive_index),
                               rtol=0, atol=1e-5)


def test_adam_step_matches_optax(scene):
    """One `make_opt_train_step` with torch.optim.Adam against optax.adam's
    update on the same gradient: parameters rtol 1e-6 (torch and optax
    order the bias corrections differently)."""
    lr = 1e-3
    params = lens_model.params_from_scene(scene)
    params.zero_grad(set_to_none=True)
    lens_model.lens_loss(params, scene.start, scene.direction, scene.screen_plane,
                         _zeros(), resolution=RES).backward()
    grads = jax_lm.LensParams(params.control_points.grad.numpy().copy(),
                              params.refractive_index.grad.numpy().copy())
    start = jax_lm.LensParams(params.control_points.detach().numpy().copy(),
                              params.refractive_index.detach().numpy().copy())
    opt_j = optax.adam(lr)
    updates, _ = opt_j.update(grads, opt_j.init(start), start)
    want = optax.apply_updates(start, updates)

    opt = torch.optim.Adam([params.control_points, params.refractive_index], lr=lr)
    step = lens_model.make_opt_train_step(scene.screen_plane, _zeros(), resolution=RES)
    params, opt, loss = step(params, opt, scene.start, scene.direction)
    assert np.abs(grads.control_points).max() > 0
    np.testing.assert_allclose(params.control_points.detach().numpy(),
                               np.asarray(want.control_points), rtol=1e-6, atol=0)
    np.testing.assert_allclose(params.refractive_index.item(),
                               float(want.refractive_index), rtol=1e-6)


def test_adam_fit_trajectory_matches_jax(jax_scene, scene):
    """Ten Adam steps of each package's fit_lens(optimizer="adam") at lr
    1e-3: losses rtol 2e-3, parameters within 1e-3, one step's size
    (measured: 5.7e-4 and 1.6e-4).  The two packages' gradients differ in
    their last bits, and Adam's normalized step turns that into up to a
    whole step where a gradient is near zero."""
    target = np.zeros((RES, RES), np.float32)
    p_j, l_j = jax_fit_lens(jax_scene, jnp.asarray(target), steps=10,
                            learning_rate=1e-3, optimizer="adam")
    p, losses = fit_lens(scene, target, steps=10, learning_rate=1e-3, optimizer="adam",
                         device="cpu")
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, l_j, rtol=2e-3)
    np.testing.assert_allclose(p.control_points.detach().numpy(),
                               np.asarray(p_j.control_points), rtol=0, atol=1e-3)


def test_custom_optimizer_and_init_params(scene):
    """A callable optimizer gets the parameter list; init_params is read,
    not modified; the tables are the scene's."""
    init = lens_model.params_from_scene(scene)
    with torch.no_grad():
        init.control_points += 1e-3
    before = init.control_points.detach().clone()
    seen = []

    def make(parameters):
        seen.append(parameters)
        return torch.optim.SGD(parameters, lr=1e-4)

    p_custom, l_custom = fit_lens(scene, _zeros(), steps=2, optimizer=make,
                                  init_params=init, device="cpu")
    p_sgd, l_sgd = fit_lens(scene, _zeros(), steps=2, learning_rate=1e-4,
                            init_params=init, device="cpu")
    assert len(seen) == 1 and seen[0][0] is p_custom.control_points
    assert torch.equal(init.control_points, before)
    assert p_custom.control_points is not init.control_points
    torch.testing.assert_close(p_custom.control_points, p_sgd.control_points,
                               rtol=0, atol=1e-7)
    assert torch.equal(p_sgd.underlying, scene.patches.underlying)


def test_emitter_fit_descends_to_self_consistent_target(scene):
    """fit_emitter_lens on point-source hemisphere rays (the car-lamp use
    case): target = the true lens's image; from perturbed control points the
    loss falls by 10 % in 6 steps and stays finite."""
    n_rays, belts, seed = 2048, 8, 3
    s, d = emitter_rays(n_rays, belts=belts, seed=seed, device="cpu")
    true_params = lens_model.params_from_scene(scene)
    with torch.no_grad():
        target = lens_model.lens_forward(true_params, s, d, scene.screen_plane,
                                         resolution=24)
    assert float(target.sum()) > 0
    rng = np.random.default_rng(0)
    pert = params_from_numpy(
        true_params.control_points.detach().numpy()
        + rng.normal(scale=2e-3, size=true_params.control_points.shape).astype(np.float32),
        np.float32(scene.refractive_index) + np.float32(0.01), scene.patches)
    params, losses = fit_emitter_lens(scene, target, steps=6, n_rays=n_rays, belts=belts,
                                      seed=seed, learning_rate=5e-4, resolution=24,
                                      init_params=pert, device="cpu")
    assert len(losses) == 6 and all(np.isfinite(losses))
    assert losses[-1] < losses[0] * 0.9, losses
    assert torch.isfinite(params.control_points).all()


@pytest.mark.parametrize("fn", [fit.fit_lens, fit.fit_emitter_lens, checkpoint.load_params,
                                checkpoint.load_patches, prng.prng_key])
def test_new_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_fit_without_a_card_raises(scene):
    """The default device is the card; without one the fit fails instead of
    running on the CPU (decided here, not at import)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    with pytest.raises((RuntimeError, AssertionError)):
        fit_lens(scene, _zeros(), steps=1)
