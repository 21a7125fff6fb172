"""config.fast_newton in the port: `intersect.fast_recip`, `fast_safe_div` and
the twins of K1-K3 in the fast mode, against the JAX package.

The JAX side runs in a fresh process (`torch_sweep_modes.run_jax`: the JAX
package reads its flags while it traces) on tests/test_fast_newton.py's
fixture: the sphere lens at res 8, 9 sectors, 4 belts and 512 rays from
seed 7.  Bars, each measured on this fixture:

* `fast_recip` is the JAX `_fast_recip` run op by op, bit for bit, on
  tests/test_fast_newton.py's 40,002 inputs, relative error under 1e-5;
* the twins of K1 and K2 against `sweep_select_pallas` and
  `sweep_winner_pallas` (interpret mode) in the fast mode: any_hit and the
  winners equal on every ray, the winning distances within rtol = atol =
  1e-4 (the exact mode's bar, tests/test_torch_sweep.py: the Pallas body
  associates a few f32 sums differently and takes an approximate rsqrt);
* the twin of K3 against `sweep_codes_pallas`: every code equal (110,592
  pairs; the exact mode differs on 2 here), the cIntersect distances of
  both within rtol 1e-3, 1 of 642 beyond 1e-4 (5.1e-4; the exact mode has
  the same pair at 5.2e-4);
* `intersect_rays` in the fast mode against the exact mode, the JAX test's
  bar: hit agreement >= 0.998 (measured 1.0; the JAX package's own fast
  sweep against its exact XLA path: 1.0 and 1.0), common-hit distances
  within rtol = atol = 1e-3 (measured: equal);
* the recompute, `patch_candidates` and the unculled twin (the JAX
  package's XLA path) ignore the flag: `torch.equal` with it off; the lens
  gradient with it on is finite.
"""
import numpy as np
import pytest
import torch

from cbtr_tpu_torch.config import DEFAULT as CFG
from cbtr_tpu_torch.models import lens_model, sphere_lens_scene
from cbtr_tpu_torch.ops import cuda_sweep as cs
from cbtr_tpu_torch.ops import intersect as ix

import torch_sweep_modes as tm

torch.set_num_threads(2)

FAST = ix.MODES["fast"]


@pytest.fixture(autouse=True)
def _restore_flags():
    """Every test leaves both flags as it found them."""
    saved = CFG.fast_newton, CFG.bf16_sweep
    yield
    object.__setattr__(CFG, "fast_newton", saved[0])
    object.__setattr__(CFG, "bf16_sweep", saved[1])


@pytest.fixture(scope="module")
def jax_fast(tmp_path_factory):
    return tm.run_jax(tmp_path_factory.mktemp("fast") / "fast.npz", "fast_newton")


@pytest.fixture(scope="module")
def inputs(jax_fast):
    return tm.port_inputs(jax_fast)


@pytest.fixture(scope="module")
def port_fast(inputs):
    return tm.port_twins(*inputs, FAST)


def test_default_off():
    assert CFG.fast_newton is False and CFG.bf16_sweep is False
    assert ix.sweep_mode() == ix.EXACT and ix.EXACT.code == 0


def test_mode_codes_and_config():
    """The kernels' template modes: bit 0 fast_newton, bit 1 bf16_sweep."""
    assert [m.code for m in ix.MODES.values()] == [0, 1, 2, 3]
    object.__setattr__(CFG, "fast_newton", True)
    assert ix.sweep_mode() == FAST and ix.sweep_mode().code == 1
    with ix.using_mode(ix.MODES["both"]):
        assert ix.sweep_mode().code == 3
    assert ix.sweep_mode() == FAST


def test_using_mode_restores_after_a_raise():
    with pytest.raises(RuntimeError):
        with ix.using_mode(ix.MODES["both"]):
            raise RuntimeError("inside")
    assert ix.sweep_mode() == ix.EXACT


def test_fast_recip_matches_jax_op_by_op():
    """tests/test_fast_newton.py's inputs: the port's bits equal the JAX
    `_fast_recip`'s, and the relative error stays under 1e-5."""
    import jax.numpy as jnp

    from cbtr_tpu.ops.pallas_sweep import _fast_recip

    x = np.concatenate([np.logspace(-12, 12, 20001, dtype=np.float32),
                        -np.logspace(-12, 12, 20001, dtype=np.float32)])
    ref = np.asarray(_fast_recip(jnp.asarray(x)))
    got = ix.fast_recip(torch.tensor(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    assert np.abs(got * x - 1.0).max() < 1e-5


def test_fast_safe_div_keeps_the_clamp():
    """`geom.safe_div`'s clamp of |den| < 1e-12 to +-1e-12 holds, the
    division is by `fast_recip` for f32 and a true division otherwise."""
    num = torch.tensor([1.0, -2.0, 3.0, 0.5])
    den = torch.tensor([0.0, -1e-20, 1e-20, 4.0])
    got = ix.fast_safe_div(num, den)
    eps = torch.tensor([1e-12, -1e-12, 1e-12, 4.0])
    assert torch.equal(got, num * ix.fast_recip(eps))
    assert torch.isfinite(got).all()
    d64 = ix.fast_safe_div(num.double(), den.double())
    assert torch.equal(d64, num.double() / eps.double())


@pytest.mark.parametrize("kernel", ["k1", "k2"])
def test_winner_twins_match_pallas(jax_fast, port_fast, kernel):
    hit_differ, win_differ, far, hits = tm.winner_counts(port_fast, jax_fast, kernel)
    print(f"{kernel} fast: {hit_differ} any_hit, {win_differ} winners, {far} distances "
          f"beyond 1e-4 of {hits} common hits")
    assert hits >= 150, "fixture too weak"
    assert (hit_differ, win_differ, far) == (0, 0, 0)


def test_codes_twin_matches_pallas(jax_fast, port_fast):
    codes, beyond_4, beyond_3, inter = tm.code_counts(port_fast, jax_fast)
    print(f"k3 fast: {codes} codes differ; of {inter} cIntersect pairs {beyond_4} beyond "
          f"rtol 1e-4, {beyond_3} beyond 1e-3")
    assert inter >= 600
    assert codes == 0 and beyond_3 == 0 and beyond_4 <= 1


def test_fast_mode_moves_only_the_divisions(inputs, port_fast):
    """The fast twin is not the exact one (some distances move by an ulp or
    more), and its winners are the exact twin's on this fixture."""
    exact = tm.port_twins(*inputs, ix.EXACT)
    assert not np.array_equal(port_fast["k3_1"], exact["k3_1"])
    for k in ("k1", "k2"):
        np.testing.assert_array_equal(port_fast[f"{k}_0"], exact[f"{k}_0"])
        np.testing.assert_array_equal(port_fast[f"{k}_1"], exact[f"{k}_1"])


def test_intersect_against_the_exact_mode(inputs):
    """tests/test_fast_newton.py's bar on the port's `intersect_rays`."""
    hits, winners, d_mode, d_exact, _ = tm.intersect_agreement(*inputs, FAST)
    print(f"intersect_rays fast vs exact: hit agreement {hits}, winners {winners}")
    assert hits >= 0.998
    np.testing.assert_allclose(d_mode, d_exact, rtol=1e-3, atol=1e-3)


def test_exact_paths_ignore_the_flag(inputs):
    """The recompute (on given winners), `patch_candidates` and the unculled
    twin are the same with the flag on."""
    patches, start, direction = inputs
    any_hit, win, _ = cs.sweep_select_reference(patches, start, direction)
    s, d = start[:64, None, :], direction[:64, None, :]
    want = (ix.recompute_winner(patches, start, direction, any_hit, win, with_check=True),
            ix.patch_candidates(patches, s, d, True),
            cs.sweep_select_reference(patches, start, direction, cull=False))
    object.__setattr__(CFG, "fast_newton", True)
    got = (ix.recompute_winner(patches, start, direction, any_hit, win, with_check=True),
           ix.patch_candidates(patches, s, d, True),
           cs.sweep_select_reference(patches, start, direction, cull=False))
    (hit_w, rej_w), (hit_g, rej_g) = want[0], got[0]
    assert rej_g == rej_w
    for a, b in zip((*hit_g, *got[1], *got[2]), (*hit_w, *want[1], *want[2])):
        assert torch.equal(a, b)


def test_recompute_rejects_of_the_fast_winners(inputs):
    """The fast twin's winners through the exact recompute: rejects counted."""
    patches, start, direction = inputs
    with ix.using_mode(FAST):
        any_hit, win, _ = cs.sweep_select_reference(patches, start, direction)
    _, rejects = ix.recompute_winner(patches, start, direction, any_hit, win,
                                     with_check=True)
    print(f"fast winners rejected by the exact recompute: {rejects}")
    assert rejects == 0


def test_gradient_finite_with_the_flag(inputs):
    _, start, direction = inputs
    scene = sphere_lens_scene(res=8, sectors=9, belts=4, device="cpu")
    params = lens_model.params_from_scene(scene)
    object.__setattr__(CFG, "fast_newton", True)
    loss = lens_model.lens_loss(params, start, direction, scene.screen_plane,
                                torch.zeros((16, 16)), resolution=16)
    loss.backward()
    assert torch.isfinite(params.control_points.grad).all()
    assert float(params.control_points.grad.abs().max()) > 0
