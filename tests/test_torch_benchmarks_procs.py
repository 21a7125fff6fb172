"""The port's multi-process scripts on the CPU: `multiprocess_render` (gloo
ranks, one thread each, started through MASTER_ADDR/MASTER_PORT/
WORLD_SIZE/RANK on the loopback interface) and `scaling_bench`.

One 2-rank render and the 1- and 2-rank scaling run are tier-1 (about 25 s
together); every other multi-rank case (--train, --train-ortho, and the
--procs halves of render4k and train4k) is `slow`, as the JAX package's
tests of benchmarks/multiprocess_render.py are (tests/test_multihost.py):

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_benchmarks_procs.py -m slow
"""
import numpy as np
import pytest
import torch

from cbtr_tpu_torch.benchmarks import multiprocess_render, render4k, scaling_bench, train4k
from cbtr_tpu_torch.models import sphere_lens_scene
from cbtr_tpu_torch.render.render import render_lens_image

torch.set_num_threads(2)


def test_two_rank_render_is_the_one_process_render(tmp_path):
    """Two gloo ranks, the sphere 9 x 4 at 16^2 rays: both ranks hold the same
    image (the launcher asserts it), within 1e-5 of the one-process render
    (two partial images summed: f32 order, tests/test_torch_multihost.py's
    bar)."""
    runs = multiprocess_render.launch(2, str(tmp_path / "mp"), res=16, mode="render",
                                      device="cpu", timeout=120)
    assert [int(r["n_processes"]) for r in runs] == [2, 2]
    np.testing.assert_array_equal(runs[0]["img"], runs[1]["img"])
    sc = sphere_lens_scene(res=16, sectors=9, belts=4, device="cpu")
    with torch.no_grad():
        one = render_lens_image(sc.patches, sc.refractive_index, sc.start, sc.direction,
                                sc.screen_plane, resolution=32).numpy()
    assert one.sum() > 100
    np.testing.assert_allclose(runs[0]["img"], one, rtol=0, atol=1e-5)


def test_scaling_bench_on_cpu_ranks():
    """--device cpu --devices 1,2: a row for each world size with its rate,
    efficiency 1 at one rank; the record says the rates are the host's."""
    rec = scaling_bench.run([1, 2], res=16, iters=1, device="cpu")
    assert [r["devices"] for r in rec["results"]] == [1, 2]
    assert all(r["rays_per_s"] > 0 for r in rec["results"])
    assert rec["results"][0]["efficiency_vs_1dev"] == 1.0
    assert rec["platform"] == "cpu" and "not a card's" in rec["note"]
    assert rec["device"] == "cpu" and rec["card"] is None and rec["rays"] == 256


def test_scaling_bench_marks_what_it_cannot_run():
    """World sizes above the cores (cards) there are: "not measured"."""
    rec = scaling_bench.run([100000], res=16, iters=1, device="cpu")
    assert rec["results"] == [{"devices": 100000, "rays_per_s": "not measured",
                               "efficiency_vs_1dev": "not measured",
                               "why": rec["results"][0]["why"]}]


@pytest.mark.slow
@pytest.mark.parametrize("mode", ["train", "train-ortho"])
def test_two_rank_train_steps_end_bit_identical(tmp_path, mode):
    """Two SGD steps over two ranks: every rank's parameters and losses
    bit-identical (the launcher asserts it); the loss falls."""
    runs = multiprocess_render.launch(2, str(tmp_path / "mp"), res=16, mode=mode,
                                      device="cpu", timeout=300)
    assert float(runs[0]["loss2"]) < float(runs[0]["loss1"])


@pytest.mark.slow
def test_render4k_and_train4k_process_halves():
    """render4k --procs 2 --res 32 and train4k --procs 2 --res 16 on gloo."""
    rec = render4k.run_procs(2, 32, "cpu")
    assert rec["ranks_equal"] and rec["n_devices"] == 2
    rec = train4k.run_procs(2, 16, "cpu")
    assert rec["ranks_equal"] and rec["loss2"] < rec["loss1"]
