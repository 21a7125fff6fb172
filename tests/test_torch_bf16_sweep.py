"""config.bf16_sweep in the port: the Bernstein and normal sums of the winner
search in bfloat16 (`bezier/patches.py` interpolate and patch_normal with
acc_dtype, the twins of K1-K3 in the bf16 mode), against the JAX package.

The JAX side runs in a fresh process with
XLA_FLAGS=--xla_allow_excess_precision=false (`torch_sweep_modes.run_jax`),
where XLA rounds every bf16 operation to bf16 as torch and the kernels do;
with excess precision allowed (XLA's default) the JAX package's own bf16
sweep gives other results on 10 of these 512 rays' any_hit.  Fixture:
tests/test_bf16_sweep.py's (the sphere lens at res 8, 9 sectors, 4 belts,
512 rays from seed 7).  Bars, each measured on this fixture:

* torch's bf16 product and sum of two bf16 values (in f32, then rounded to
  bf16) are the correctly rounded ones, as the kernels' __hmul_rn and
  __hadd_rn give them, and `interpolate` in bf16 rounds each of them;
* the twins against the JAX package's Pallas kernels (interpret mode) in
  the bf16 mode are NOT equal: K1 and K2 differ on 1 of 512 rays' any_hit
  and 2 of 176 common hits' winners, with 3 winning distances beyond rtol =
  atol = 1e-4 (those 2 and one more), and K3 on 45 of 110,592 codes, 7 of
  the common cIntersect pairs' distances beyond rtol 1e-4 and 3 beyond 1e-3
  (the exact mode: 0, 0, 0 and 2, 1, 0).  The cause is the f32 arithmetic
  around the bf16 sums: the port follows the XLA path (1/sqrt, the ray
  distance against the bar, csrc/candidate.cuh) where the Pallas body takes
  an approximate rsqrt, the squared distance and other associations; an
  operand an ulp apart rounds to bf16 the other way on some pairs (2^-8
  relative), which moves a Newton search near a patch border.  The counts
  are held at what was measured;
* `intersect_rays` in the bf16 mode against the exact mode: hit agreement
  0.98046875 and winner agreement 0.8920 on common hits (measured), held to
  the JAX package's own bf16 sweep without excess precision against its
  exact XLA path on the same fixture, 0.978515625 and 0.880 (with excess
  precision allowed: 0.986328125 and 0.904, the band tests/test_bf16_sweep.py
  was set under); the both mode (fast and bf16) measures 0.98046875 and
  0.8807, held to the same band;
* the recompute ignores the flag and stays exact; the lens gradient with it
  on is finite.
"""
import numpy as np
import pytest
import torch

from cbtr_tpu_torch.bezier.patches import _bernstein, interpolate
from cbtr_tpu_torch.config import DEFAULT as CFG
from cbtr_tpu_torch.models import lens_model, sphere_lens_scene
from cbtr_tpu_torch.ops import cuda_sweep as cs
from cbtr_tpu_torch.ops import intersect as ix

import torch_sweep_modes as tm

torch.set_num_threads(2)

BF16 = ix.MODES["bf16"]
# the JAX package's bf16 sweep against its exact XLA path on this fixture,
# without excess precision: hit agreement, winner agreement on common hits
JAX_BAND = (0.978515625, 0.880)


@pytest.fixture(autouse=True)
def _restore_flags():
    """Every test leaves both flags as it found them."""
    saved = CFG.fast_newton, CFG.bf16_sweep
    yield
    object.__setattr__(CFG, "fast_newton", saved[0])
    object.__setattr__(CFG, "bf16_sweep", saved[1])


@pytest.fixture(scope="module")
def jax_bf16(tmp_path_factory):
    return tm.run_jax(tmp_path_factory.mktemp("bf16") / "bf16.npz", "bf16_sweep",
                      xla_flags="--xla_allow_excess_precision=false")


@pytest.fixture(scope="module")
def inputs(jax_bf16):
    return tm.port_inputs(jax_bf16)


@pytest.fixture(scope="module")
def port_bf16(inputs):
    return tm.port_twins(*inputs, BF16)


def _round_bf16(x):
    """float64 -> the nearest bf16 value (ties to even), as float64; normal
    numbers only."""
    m, e = np.frexp(x)
    return np.ldexp(np.round(m * 256.0) / 256.0, e)


def test_default_off():
    assert CFG.bf16_sweep is False and ix.sweep_mode() == ix.EXACT


def test_torch_bf16_ops_round_once():
    """A bf16 product and sum in torch equal the exact result rounded to bf16
    once: what __hmul_rn and __hadd_rn give on the card."""
    rng = np.random.default_rng(0)
    a = torch.tensor(rng.normal(size=100000) * 10.0 ** rng.integers(-6, 6, 100000),
                     dtype=torch.float32).to(torch.bfloat16)
    b = torch.tensor(rng.normal(size=100000) * 10.0 ** rng.integers(-6, 6, 100000),
                     dtype=torch.float32).to(torch.bfloat16)
    a64, b64 = a.double().numpy(), b.double().numpy()
    np.testing.assert_array_equal((a * b).double().numpy(), _round_bf16(a64 * b64))
    np.testing.assert_array_equal((a + b).double().numpy(), _round_bf16(a64 + b64))


def test_interpolate_rounds_every_operation():
    """`interpolate(..., torch.bfloat16)`: the f32 weights and the control
    points rounded to bf16, each product and each running sum rounded."""
    rng = np.random.default_rng(1)
    cp = torch.tensor(rng.normal(size=(64, 10, 3)), dtype=torch.float32)
    bary = torch.tensor(rng.uniform(-2.0, 2.0, size=(64, 3)), dtype=torch.float32)
    got = interpolate(cp, bary, torch.bfloat16)
    assert got.dtype == torch.float32
    w = [_round_bf16(x.double().numpy()) for x in _bernstein(bary[:, 0], bary[:, 1],
                                                             bary[:, 2])]
    c = _round_bf16(cp.double().numpy())
    out = _round_bf16(w[0][:, None] * c[:, 0, :])
    for k in range(1, 10):
        out = _round_bf16(out + _round_bf16(w[k][:, None] * c[:, k, :]))
    np.testing.assert_array_equal(got.double().numpy(), out)
    assert not torch.equal(got, interpolate(cp, bary))


@pytest.mark.parametrize("kernel", ["k1", "k2"])
def test_winner_twins_against_pallas(jax_bf16, port_bf16, kernel):
    """Not equal: the counts and their cause are in the module docstring."""
    hit_differ, win_differ, far, hits = tm.winner_counts(port_bf16, jax_bf16, kernel)
    print(f"{kernel} bf16: {hit_differ} any_hit, {win_differ} winners, {far} distances "
          f"beyond 1e-4 of {hits} common hits")
    assert hits >= 150, "fixture too weak"
    assert hit_differ <= 1 and win_differ <= 2 and far <= 3


def test_codes_twin_against_pallas(jax_bf16, port_bf16):
    codes, beyond_4, beyond_3, inter = tm.code_counts(port_bf16, jax_bf16)
    print(f"k3 bf16: {codes} codes differ; of {inter} cIntersect pairs {beyond_4} beyond "
          f"rtol 1e-4, {beyond_3} beyond 1e-3")
    assert inter >= 450
    assert codes <= 45 and beyond_4 <= 7 and beyond_3 <= 3


@pytest.mark.parametrize("mode", ["bf16", "both"])
def test_intersect_band_against_the_exact_mode(inputs, mode):
    hits, winners, d_mode, d_exact, same = tm.intersect_agreement(*inputs, ix.MODES[mode])
    print(f"intersect_rays {mode} vs exact: hit agreement {hits}, winners {winners}")
    assert hits >= JAX_BAND[0] and winners >= JAX_BAND[1]
    # where the winner is the same, the exact recompute gives the same point
    np.testing.assert_array_equal(d_mode[same], d_exact[same])


def test_recompute_stays_exact(inputs):
    """The bf16 twin's winners through `recompute_winner`, with the flag on
    and off: the same fields bit for bit, rejects counted."""
    patches, start, direction = inputs
    object.__setattr__(CFG, "bf16_sweep", True)
    any_hit, win, _ = cs.sweep_select_reference(patches, start, direction)
    on, rejects_on = ix.recompute_winner(patches, start, direction, any_hit, win,
                                         with_check=True)
    object.__setattr__(CFG, "bf16_sweep", False)
    off, rejects_off = ix.recompute_winner(patches, start, direction, any_hit, win,
                                           with_check=True)
    print(f"bf16 winners rejected by the exact recompute: {rejects_on}")
    assert rejects_on == rejects_off
    assert all(torch.equal(a, b) for a, b in zip(on, off))


def test_unculled_twin_ignores_the_flag(inputs):
    want = cs.sweep_select_reference(*inputs, cull=False)
    object.__setattr__(CFG, "bf16_sweep", True)
    got = cs.sweep_select_reference(*inputs, cull=False)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_gradient_finite_with_the_flag(inputs):
    _, start, direction = inputs
    scene = sphere_lens_scene(res=8, sectors=9, belts=4, device="cpu")
    params = lens_model.params_from_scene(scene)
    object.__setattr__(CFG, "bf16_sweep", True)
    loss = lens_model.lens_loss(params, start, direction, scene.screen_plane,
                                torch.zeros((16, 16)), resolution=16)
    loss.backward()
    assert torch.isfinite(params.control_points.grad).all()
    assert float(params.control_points.grad.abs().max()) > 0
