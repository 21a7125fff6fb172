"""The recompute kernels (csrc/recompute.cu) against their plain versions on
the card: each forward field `torch.equal` to the twin's, the backward's row,
start and direction gradients `torch.equal` to
`cuda_recompute.recompute_adjoint_reference`, two backward runs bit-equal,
and the train step through `_Recompute` bit-equal to the one through the
twin.
On the CPU the wrapper runs the plain version (tests/test_torch_recompute.py),
so these hold only where the kernels run.

Every test here is marked `cuda` and skips without a card.  This file
imports no JAX, so it runs on a machine with the card and no JAX:
`python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_recompute_card.py` from the repository root.
"""
import pytest
import torch

from cbtr_tpu_torch.models import lens_model, scenes
from cbtr_tpu_torch.ops import cuda_lib
from cbtr_tpu_torch.ops import cuda_recompute as cr
from cbtr_tpu_torch.ops import cuda_sweep as cs
from cbtr_tpu_torch.ops import intersect as ix

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def robot():
    """The robot lens (450 patches) at 64^2 rays on the card, K1's winners."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the recompute kernels have no CPU mode")
    sc = scenes.robot_lens_scene(res=64, device="cuda")
    any_hit, win, _ = cs.sweep_select(sc.patches, sc.start, sc.direction)
    return sc, any_hit, win


def _args(robot):
    sc, any_hit, win = robot
    return (sc.patches.packed_f32().detach().contiguous(), win.clamp_min(0).to(torch.int64),
            sc.start, sc.direction, any_hit, win)


def _cotangents(R, any_hit, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cot = [torch.randn(shape, generator=gen, device="cuda")
           for shape in ((R,), (R, 3), (R, 3), (R, 3), (R,))]
    return cot, [torch.where(any_hit if c.dim() == 1 else any_hit[:, None], c, 0.0) for c in cot]


def test_forward_kernel_is_the_twin(robot):
    args = _args(robot)
    before = cuda_lib.launch_counts()["recompute_forward"]
    got = cr.launch_forward(*args)
    want = cr.recompute_forward_reference(*args)
    torch.cuda.synchronize()
    assert cuda_lib.launch_counts()["recompute_forward"] == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int((got[0] == ix.WHAT_INTERSECT).sum()) > 500


@pytest.mark.parametrize("misses", ["zero", "random"])
def test_backward_kernel_is_the_adjoint(robot, misses):
    """Random cotangents on the hits, and on the misses zero (as the path
    gives them) or random; two runs bit-equal, every value finite."""
    args = _args(robot)
    every, hits = _cotangents(args[2].shape[0], args[4], seed=1)
    cot = hits if misses == "zero" else every
    got = cr.launch_backward(*args[:5], *cot)
    again = cr.launch_backward(*args[:5], *cot)
    want = cr.recompute_adjoint_reference(*args[:5], *cot)
    torch.cuda.synchronize()
    for g, a, w in zip(got, again, want):
        assert torch.isfinite(g).all()
        assert torch.equal(g, w) and torch.equal(g, a)
    assert not got[0][:, 48:].any()


def test_train_step_on_the_kernels_is_the_twins(robot, monkeypatch):
    """The headline loss and gradients through `_Recompute` against the same
    step with the recompute's plain version, bit for bit: the forward kernel
    is the twin, the backward kernel is autograd of the twin on the card
    (it sums a broadcast's three terms in the card's order), and both add
    the rows into the table with the same segment sum."""
    sc = robot[0]
    target = torch.zeros((32, 32), device="cuda")

    def grads():
        params = lens_model.params_from_scene(sc)
        loss = lens_model.lens_loss(params, sc.start, sc.direction, sc.screen_plane, target,
                                    resolution=32)
        loss.backward()
        return loss.detach(), params.control_points.grad, params.refractive_index.grad

    before = cuda_lib.launch_counts()["recompute_backward"]
    kernels = grads()
    assert cuda_lib.launch_counts()["recompute_backward"] == before + 2
    monkeypatch.setattr(cr, "on_kernels", lambda table, backend="auto": False)
    plain = grads()
    assert float(kernels[1].abs().max()) > 0
    for got, want in zip(kernels, plain):
        assert torch.equal(got, want)
