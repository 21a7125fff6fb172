"""The A/B harness of the winner kernels (harness/kernel_ab.py), on the CPU.

Its timings need the card; what it does around them runs here: the capture
of the second refraction's rays, the digest of a result, the merge of the
two checkouts' runs, and the probe process, which imports the package of
the checkout it is started in and refuses to run without a CUDA device.
"""
import os

import pytest
import torch

import cbtr_tpu_torch
from cbtr_tpu_torch.harness import kernel_ab
from cbtr_tpu_torch.models import robot_lens_scene
from cbtr_tpu_torch.ops import intersect as ix

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene():
    return robot_lens_scene(res=32, device="cpu")


def test_second_pass_rays_are_the_second_search(scene):
    """The rays of the second refraction: every ray of the beam, those that
    entered the lens moved to their entry point."""
    s2, d2 = kernel_ab.second_pass_rays(scene)
    assert s2.shape == scene.start.shape and d2.shape == scene.direction.shape
    moved = (s2 != scene.start).any(dim=1)
    assert 0 < int(moved.sum()) < s2.shape[0]
    assert ix._winner_chunk.__name__ == "_winner_chunk"


def test_digest_tells_results_apart():
    """Equal values give one digest; one changed bit or another dtype give
    another; a non-contiguous view digests as its values."""
    hit = torch.tensor([True, False])
    win = torch.tensor([3, 0], dtype=torch.int32)
    dist = torch.tensor([1.5, 3.4e38])
    base = kernel_ab.digest(hit, win, dist)
    assert kernel_ab.digest(hit.clone(), win.clone(), dist.clone()) == base
    nudged = dist.clone()
    nudged[0] = torch.nextafter(nudged[0], torch.tensor(2.0))
    assert kernel_ab.digest(hit, win, nudged) != base
    assert kernel_ab.digest(hit, win.to(torch.int64), dist) != base
    grid = torch.arange(6.0).reshape(2, 3)
    assert kernel_ab.digest(grid.T) == kernel_ab.digest(grid.T.contiguous())


def test_merge_keeps_turn_order_and_compares_digests():
    runs = [("against", {"k1": {"digest": "a", "alone_ms": 2.0},
                         "step": {"step_ms": 130.0, "device_ops": 9233}}),
            ("this", {"k1": {"digest": "a", "alone_ms": 1.3},
                      "step": {"step_ms": 128.0, "device_ops": 9079}}),
            ("this", {"k1": {"digest": "a", "alone_ms": 1.4},
                      "step": {"step_ms": 127.0, "device_ops": 9079}}),
            ("against", {"k1": {"digest": "b", "alone_ms": 2.1},
                         "step": {"step_ms": 131.0, "device_ops": 9233}})]
    k1, step = kernel_ab.merge(runs)
    assert k1 == {"shape": "k1", "against": {"alone_ms": [2.0, 2.1]},
                  "this": {"alone_ms": [1.3, 1.4]}, "same_winners": False}
    assert step["this"] == {"step_ms": [128.0, 127.0], "device_ops": [9079, 9079]}
    assert "same_winners" not in step
    runs[3][1]["k1"]["digest"] = "a"
    assert kernel_ab.merge(runs)[0]["same_winners"] is True


def test_probe_process_imports_the_named_checkout(tmp_path, monkeypatch):
    """The probe runs in a fresh process on the package of the checkout it
    is started in (here a directory whose package links to this one), and
    raises there without a CUDA device (hidden from it)."""
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    os.symlink(os.path.dirname(os.path.abspath(cbtr_tpu_torch.__file__)),
               tmp_path / "cbtr_tpu_torch")
    with pytest.raises(RuntimeError) as failed:
        kernel_ab.run_checkout(str(tmp_path))
    text = str(failed.value)
    assert f"[probe] {tmp_path / 'cbtr_tpu_torch'}" in text
    assert "kernel_ab needs a CUDA device" in text
