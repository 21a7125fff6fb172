"""The tables built once a lens a trace, on the card: the kernels read the
tables they are handed, the hoist leaves images and gradients bit-equal,
and the table kernel's per-patch boxes (K1's) equal the plain build's.  On the CPU the winner wrappers check the tables and run their
twins, which build their own (tests/test_torch_tables_hoist.py), so these
hold only where the kernels run.

Every test here is marked `cuda` and skips without a card.  This file
imports no JAX, so it runs on a machine with the card and no JAX:
`python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_tables_card.py` from the repository root.
"""
import dataclasses

import pytest
import torch

from cbtr_tpu_torch.models import lens_model, scenes
from cbtr_tpu_torch.ops import cuda_lib
from cbtr_tpu_torch.ops import cuda_tables as ct
from cbtr_tpu_torch.ops import cuda_winner as cw
from cbtr_tpu_torch.ops import intersect as ix
from cbtr_tpu_torch.optics import lens

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def robot():
    """The robot lens (450 patches) at 32^2 rays, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the table, ray-pack and winner kernels "
                    "have no CPU mode")
    return scenes.robot_lens_scene(res=32, device="cuda")


def _no_blocks(tables):
    """The same tables with every block's radius -1: no block is listed."""
    return dataclasses.replace(tables, bounds=tables.bounds.clone().index_fill_(
        1, torch.tensor([3], device=tables.bounds.device), -1.0))


def test_given_tables_are_the_ones_read(robot):
    """The winner search reads the tables it is handed: bounds that list no
    block (every radius -1) leave no hit, on K1 and on K2."""
    sc = robot
    tables = ix.winner_tables(sc.patches)
    assert not tables.clamped and tables.patch_t.is_cuda
    with torch.no_grad():
        hit = ix.intersect_rays(sc.patches, sc.start, sc.direction, tables=tables)
        none = ix.intersect_rays(sc.patches, sc.start, sc.direction,
                                 tables=_no_blocks(tables))
    assert int((hit.what == ix.WHAT_INTERSECT).sum()) > 50
    assert not (none.what == ix.WHAT_INTERSECT).any()
    clamped = ct.build_tables(sc.patches, 16, clamp=True)
    k2 = cw.sweep_winner(sc.patches, sc.start, sc.direction, tables=clamped)
    k2_none = cw.sweep_winner(sc.patches, sc.start, sc.direction, tables=_no_blocks(clamped))
    assert torch.equal(k2[0], cw.sweep_winner_reference(sc.patches, sc.start,
                                                         sc.direction)[0])
    assert int(k2[0].sum()) > 50 and not k2_none[0].any()


def _loss_and_grads(sc, chunk):
    params = lens_model.params_from_scene(sc)
    target = torch.zeros((16, 16), dtype=torch.float32, device=sc.start.device)
    loss = lens_model.lens_loss(params, sc.start, sc.direction, sc.screen_plane, target,
                                resolution=16, chunk_size=chunk)
    loss.backward()
    return loss.detach(), params.control_points.grad, params.refractive_index.grad


@pytest.mark.parametrize("chunk", [0, 256])
def test_hoist_leaves_images_and_gradients_bit_equal_on_the_card(robot, monkeypatch,
                                                                 chunk):
    """On the kernels, the image, loss and gradients with the tables built
    once a trace are bit-equal to those with the tables built at every
    chunk (`winner_tables` giving none), and the builds fall from one a
    trace to one a chunk and pass."""
    sc = robot

    def run():
        before = cuda_lib.launch_counts()["tables"]
        with torch.no_grad():
            img = lens_model.lens_forward(lens_model.params_from_scene(sc), sc.start,
                                          sc.direction, sc.screen_plane, resolution=16,
                                          chunk_size=chunk)
        out = _loss_and_grads(sc, chunk)
        torch.cuda.synchronize()
        return img, out, cuda_lib.launch_counts()["tables"] - before

    img, hoisted, hoisted_builds = run()
    monkeypatch.setattr(ix, "winner_tables", lambda patches, backend="auto": None)
    monkeypatch.setattr(lens, "winner_tables", lambda patches, backend="auto": None)
    img_per_chunk, per_chunk, per_chunk_builds = run()
    n_chunks = 1024 // chunk if chunk else 1
    assert hoisted_builds == 2 and per_chunk_builds == 2 * 2 * n_chunks
    assert float(img.sum()) > 0 and torch.equal(img, img_per_chunk)
    for a, b in zip(hoisted, per_chunk):
        assert torch.equal(a, b)
    assert float(hoisted[1].abs().max()) > 0


@pytest.mark.parametrize("refine", [False, True])
def test_table_kernel_boxes_are_the_patch_boxes(robot, refine):
    """The table kernel's [P_pad, 8] per-patch boxes, which K1's first pass
    culls each pair by, bit-equal to the plain build (`_patch_boxes` of the
    patches' spheres, zero columns 6-7 and padding rows), a view of the
    build's one workspace."""
    patches = (scenes.robot_lens_scene(res=1, refine=True, device="cuda").patches
               if refine else robot.patches)
    got = ct.build_tables(patches)
    want = ct.build_tables_reference(patches)
    torch.cuda.synchronize()
    assert got.boxes.shape == (got.patch_t.shape[0], 8) and got.boxes.is_contiguous()
    assert got.boxes.untyped_storage().data_ptr() == got.patch_t.untyped_storage().data_ptr()
    assert torch.equal(got.boxes, want.boxes)
