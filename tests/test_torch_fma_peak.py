"""The plain twin of the FMA-peak kernel K4 against the JAX package's
microbenchmark kernel, and the rule that turns runs into a peak.

The same input (made with numpy from a seed) goes through the port's
`fma_chains_reference` and through `benchmarks/vpu_peak.py::_make_kernel(n)`
in Pallas's TPU interpret mode (the plain call refuses the CPU).  Bar:
rtol 2e-6 on the summed chains.  Both round a multiply and a subtraction
separately here; on the card K4 fuses them into one FMA, which a NumPy
simulation of the 16 contracting chains puts within 4.5e-7 relative of the
separately rounded sum at every length up to 65,536.
"""
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from cbtr_tpu_torch.benchmarks import fma_peak as fp
from cbtr_tpu_torch.ops import cuda_lib

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks"))
import vpu_peak  # noqa: E402

torch.set_num_threads(2)


@pytest.mark.parametrize("n_iter", fp.CHECK_LENGTHS)
def test_twin_matches_jax_kernel(n_iter):
    rng = np.random.default_rng(n_iter)
    a = (0.5 + 0.2 * rng.random((vpu_peak.ROWS, vpu_peak.LANES))).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(jax.block_until_ready(vpu_peak._make_kernel(n_iter)(a)))
    got = fp.fma_chains_reference(torch.tensor(a.reshape(-1)), n_iter).numpy()
    assert got.dtype == np.float32 and got.shape == (a.size,)
    np.testing.assert_allclose(got, ref.reshape(-1), rtol=2e-6, atol=0)
    assert np.isfinite(got).all() and (np.abs(got) > 1.0).all()


def _fused_chains(a, n_iter, start_scale=1.0, steps_short=0):
    """K4's arithmetic on the CPU: each step a - x*x rounded once, as the
    kernel's FMA rounds it (formed in float64, then rounded to f32); the
    faults a wrong kernel could have: start factors off by `start_scale`,
    `steps_short` steps too few."""
    x = torch.stack([a * float(np.float32((0.1 + 0.05 * k) * start_scale))
                     for k in range(fp.K_CHAINS)])
    for _ in range(max(n_iter - steps_short, 0)):
        x = (a.double() - x.double() * x.double()).float()
    acc = x[0]
    for k in range(1, fp.K_CHAINS):
        acc = acc + x[k]
    return acc


def _max_rel(got, ref):
    return float(((got - ref) / ref).abs().max())


def test_check_lengths_tell_a_wrong_kernel_apart():
    """At rtol 2e-6 the check lengths accept K4's rounding and reject a
    kernel one step short or with its start factors 1e-3 off; at the timing
    length N_SMALL every chain is on its fixed point and both faults pass."""
    a = 0.5 + 0.2 * torch.rand(1024, generator=torch.Generator().manual_seed(3))
    for n_iter in fp.CHECK_LENGTHS:
        ref = fp.fma_chains_reference(a, n_iter)
        assert _max_rel(_fused_chains(a, n_iter), ref) <= 2e-6, n_iter
        assert _max_rel(_fused_chains(a, n_iter, start_scale=1.001), ref) > 2e-6, n_iter
        if n_iter:
            assert _max_rel(_fused_chains(a, n_iter, steps_short=1), ref) > 2e-6, n_iter
    ref = fp.fma_chains_reference(a, fp.N_SMALL)
    for fault in ({"start_scale": 1.001}, {"steps_short": 1}):
        assert _max_rel(_fused_chains(a, fp.N_SMALL, **fault), ref) <= 2e-6, fault


def test_cpu_wrapper_runs_the_twin_and_launch_refuses_cpu():
    a = 0.5 + 0.2 * torch.rand(300, generator=torch.Generator().manual_seed(1))
    before = cuda_lib.launch_counts()["fma_chains"]
    assert torch.equal(fp.fma_chains(a, 16), fp.fma_chains_reference(a, 16))
    assert cuda_lib.launch_counts()["fma_chains"] == before and "fma_peak" not in cuda_lib.loaded()
    with pytest.raises(ValueError, match="CUDA"):
        fp.launch(a, 16)
    with pytest.raises(ValueError):
        fp.fma_ceiling("cpu")
    assert "fma_peak" not in cuda_lib.loaded()


def test_peak_rejects_runs_above_the_ceiling():
    """A run above the physical ceiling is a broken measurement and goes; a
    contended run only under-measures, so the maximum of the rest stays.
    bench.py's anchor (drop runs > 2 x the minimum) would keep only 10.0
    here, the contended minimum dragging the genuine 60.0 out."""
    peak, kept = fp.select_peak([10.0, 60.0, 70.0, 1400.0], ceiling=66.9)
    assert peak == 60.0 and kept == [10.0, 60.0]
    assert fp.select_peak([66.9], ceiling=66.9)[0] == 66.9
    assert fp.select_peak([3.0, 5.0])[0] == 5.0          # no ceiling (CPU)
    with pytest.raises(RuntimeError, match="ceiling"):
        fp.select_peak([80.0, 90.0], ceiling=66.9)
    with pytest.raises(RuntimeError):
        fp.select_peak([0.0, -1.0])


def test_cpu_measurement_and_command_line(capsys):
    assert fp.chains_elements("cpu") == fp._CPU_ELEMENTS
    assert fp.measure_fma_peak(timing_iters=2, device="cpu") > 0
    assert fp.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["unit"] == "TFLOP/s" and out["value"] > 0
    assert len(out["runs_tflops"]) == fp.RUNS and out["ceiling_tflops"] is None
    assert out["device"] == "cpu"


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        fp.main(["--device", "cuda"])
