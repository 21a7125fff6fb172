"""K1's per-pair cull in its first pass, on the CPU.

K1 evaluates in its first pass only the pairs of the gated blocks whose ray
meets the patch's own inflated sphere and slack-widened box
(`cuda_sweep.evaluated_pairs`); the unit gate (`gated_pairs`) stays, since
it defines the retries.  The cull is lossless because a first-pass pair
contributes, as a direct hit or a vote, only where its gate-ON code holds,
and that code needs the ray to cross the flat triangle of the patch's
corners, which lies inside both.  Here:

* on every pair of the fixtures (both passes of the robot beam, the car-lamp
  fan, the sphere lens, the refined robot), in each sweep mode: every pair
  whose gate-ON code is an intersection or a vote passes the sphere and the
  box test;
* the table kernel's plain build gives the per-patch boxes of
  `_patch_boxes`, bit for bit (the card build: tests/test_torch_tables_card.py);
* the twin's counted pairs are listed AND gated AND sphere AND box, and its
  winners are those of the unit-gated set;
* `fold_key`'s order is `fold`'s: the key the kernel folds by atomicMin.
"""
import numpy as np
import pytest
import torch

from cbtr_tpu_torch.models import scenes
from cbtr_tpu_torch.ops import cuda_sweep as cs
from cbtr_tpu_torch.ops import cuda_tables as ct
from cbtr_tpu_torch.ops import intersect as ix
from cbtr_tpu_torch.optics import lens
from cbtr_tpu_torch.render.emitters import DeviceEmitter
from cbtr_tpu_torch.utils import profiling

torch.set_num_threads(2)

# the car-lamp cell's source (portbench/configs/carlamp450.json): 3 units
# before the lens centre, 64 belts, 16,777,216 rays; 4,096 of them, strided
_FAN = {"belts": 64, "n_rays": 1 << 24}
_FAN_RAYS = 4096


def _fan(device="cpu"):
    origin = tuple(float(x) for x in np.asarray(scenes.LENS_CENTER) - (3.0, 0.0, 0.0))
    em = DeviceEmitter(origin=origin, seed=3900000001, **_FAN)
    start, direction, _ = em.rays_at(torch.arange(0, _FAN["n_rays"],
                                                  _FAN["n_rays"] // _FAN_RAYS))
    return start, direction


@pytest.fixture(scope="module")
def fixtures():
    """name -> (patches, start [R,3], direction [R,3]), at most 4,096 rays:
    the robot's tiled 64^2 beam and its second pass (the rays refract_rays
    hands on), the car-lamp fan through the robot, the sphere lens at 32^2,
    the refined robot (1800 patches) at 32^2."""
    robot = scenes.robot_lens_scene(res=64, device="cpu")
    s, d = robot.start.reshape(-1, 3), robot.direction.reshape(-1, 3)
    with torch.no_grad():
        s1, d1, _ = lens.refract_rays(robot.patches, robot.refractive_index, s, d,
                                      lens.REFRACT_INSIDE)
    sphere = scenes.sphere_lens_scene(res=32, device="cpu")
    refined = scenes.robot_lens_scene(res=32, refine=True, device="cpu")
    return {
        "robot_beam": (robot.patches, s, d),
        "robot_beam_pass2": (robot.patches, s1, d1),
        "carlamp_fan": (robot.patches, *_fan()),
        "sphere": (sphere.patches, sphere.start.reshape(-1, 3),
                   sphere.direction.reshape(-1, 3)),
        "refined": (refined.patches, refined.start.reshape(-1, 3),
                    refined.direction.reshape(-1, 3)),
    }


def _pair_tests(patches, start, direction):
    """(sphere [R, P], box [R, P]): the per-pair tests K1 evaluates."""
    rays_t = cs.pad_rays(start, direction)
    tables = ct.build_tables(patches)
    R, P = start.shape[0], patches.num_patches
    return (cs.sphere_hit_pairs(tables.patch_t, rays_t)[:R, :P],
            cs.box_hit_pairs(tables.boxes, rays_t)[:R, :P])


@pytest.mark.parametrize("mode", ["exact", "fast", "bf16"])
@pytest.mark.parametrize("case", ["robot_beam", "robot_beam_pass2", "carlamp_fan",
                                  "sphere", "refined"])
def test_pass1_contributors_pass_the_pair_test(fixtures, case, mode):
    """Every pair whose gate-ON code is an intersection or a vote (in the
    domain, a result other than WHAT_NONE) passes the sphere and the box
    test, so K1's first pass drops no candidate."""
    patches, start, direction = fixtures[case]
    code, _ = ix.sweep_codes(patches, start, direction, ix.MODES[mode])
    contributes = ((code >> 3) > 0) & ((code & 7) != ix.WHAT_NONE)
    sphere, box = _pair_tests(patches, start, direction)
    assert int(contributes.sum()) >= 16, "fixture too weak"
    assert not bool((contributes & ~(sphere & box)).any()), (
        case, mode, int((contributes & ~sphere).sum()), int((contributes & ~box).sum()))
    # the test culls: most pairs fail it
    assert int((sphere & box).sum()) < 0.5 * sphere.numel()


@pytest.mark.parametrize("case", ["robot", "sphere", "refined"])
def test_table_boxes_are_the_patch_boxes(case):
    """The plain build's [P_pad, 8] boxes: `_patch_boxes` of the patches'
    own spheres in columns 0-5, zeros in 6-7 and on the padding rows, bit
    for bit; the workspace view has the same shape."""
    kw = {"refine": True} if case == "refined" else {}
    sc = (scenes.sphere_lens_scene(res=1, device="cpu") if case == "sphere"
          else scenes.robot_lens_scene(res=1, device="cpu", **kw))
    p = sc.patches
    P = p.num_patches
    boxes = ct.build_tables(p).boxes
    center, radius = cs.patch_spheres(p)
    lo, hi = cs._patch_boxes(p.control_points, center, radius)
    P_pad = P + (-P) % 128
    assert boxes.dtype == torch.float32 and boxes.shape == (P_pad, 8)
    assert boxes.is_contiguous()
    assert torch.equal(boxes[:P, 0:3], lo.to(torch.float32))
    assert torch.equal(boxes[:P, 3:6], hi.to(torch.float32))
    assert not bool(boxes[:P, 6:].any()) and not bool(boxes[P:].any())
    assert torch.equal(boxes, cs.patch_box_table(p))
    plan = ct._workspace_plan(P)
    assert ct._views(torch.empty(plan.nbytes, dtype=torch.uint8), plan)[3].shape == boxes.shape


@pytest.mark.parametrize("case, half_gate", [("robot_beam", False), ("robot_beam", True),
                                             ("carlamp_fan", False), ("sphere", True)])
def test_twin_counts_listed_gated_sphere_and_box(fixtures, case, half_gate):
    """The twin's counted first-pass pairs are the listed AND gated AND
    sphere AND box pairs (the half gate changes the gated units, not this
    set), fewer than the gated pairs; counting leaves its winners, those of
    the unit-gated set, as they are."""
    patches, start, direction = fixtures[case]
    P = patches.num_patches
    rays_t = cs.pad_rays(start, direction)
    tables = ct.build_tables(patches)
    listed = cs.listed_blocks(*cs.tile_block_lists(patches, rays_t), tables.patch_t.shape[0])
    sphere = cs.sphere_hit_pairs(tables.patch_t, rays_t)
    box = cs.box_hit_pairs(tables.boxes, rays_t)
    gated = cs.gated_pairs(listed, sphere, half_gate=half_gate)
    want = gated & sphere & box
    assert torch.equal(cs.evaluated_pairs(listed, sphere, box), want)
    cs.reset_pair_counts()
    with profiling.counting():
        got = cs.sweep_select(patches, start, direction, half_gate=half_gate)
    counted = cs.pair_counts()["sweep_select"]
    cs.reset_pair_counts()
    assert counted == (int(want[:, :P].sum()), 0)
    assert 0 < counted[0] < int(gated[:, :P].sum())
    plain = cs.sweep_select_reference(patches, start[:256], direction[:256],
                                      half_gate=half_gate)
    for a, b in zip(got, plain):
        assert torch.equal(a[:256], b)


def _fold_key(d, q):
    """csrc/sweep_select.cu fold_key in NumPy: the distance's bits made
    monotone (-0 as +0, flagged in bit 0), then the id."""
    u = np.float32(d).view(np.uint32)
    neg_zero = np.uint32(u == np.uint32(0x80000000))
    u = np.where(neg_zero, np.uint32(0), u).astype(np.uint32)
    ordered = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))
    return (int(ordered) << 32) | (int(q) << 1) | int(neg_zero)


def _unfold_key(key):
    ordered, low = np.uint32(key >> 32), key & 0xFFFFFFFF
    u = ordered & np.uint32(0x7FFFFFFF) if ordered & np.uint32(0x80000000) else ~ordered
    d = np.float32(-0.0) if low & 1 else np.uint32(u).view(np.float32)
    return d, low >> 1


def _fold(candidates):
    """block_walk/candidate.cuh `fold` from (BIG_F, 0), in order."""
    best, best_id = np.float32(3.4e38), 0
    for d, q in candidates:
        if d < best or (d == best and q < best_id):
            best, best_id = d, q
    return best, best_id


def test_fold_key_orders_as_fold():
    """The minimum key over any candidates, in any order, unfolds to the
    (distance, id) `fold` picks, its bits included (a -0 and +0 tie goes to
    the lower id and keeps that candidate's sign)."""
    rng = np.random.default_rng(23)
    values = np.float32([0.0, -0.0, 1.0, 1.0, -2.5, 3.4e38, 7e-45, -7e-45, 1e7, -1e7])
    for _ in range(300):
        # a ray meets each patch once in the first pass: ids are distinct
        ids = rng.choice(1024, size=int(rng.integers(1, 9)), replace=False)
        cand = [(np.float32(rng.choice(values) if rng.random() < 0.5
                            else rng.normal() * 10.0), int(q)) for q in ids]
        want_d, want_q = _fold(cand)
        key = min([_fold_key(np.float32(3.4e38), 0)] + [_fold_key(d, q) for d, q in cand])
        d, q = _unfold_key(key)
        assert q == want_q and np.float32(d).view(np.uint32) == np.float32(want_d).view(
            np.uint32), (cand, d, q, want_d, want_q)
