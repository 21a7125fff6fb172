"""The port's benchmark entry point on the CPU.

`python -m cbtr_tpu_torch.bench --preset smoke --device cpu` runs every row
of the smoke preset through the kernels' plain twins and prints the
headline JSON line last; `--device cuda` without a CUDA device raises.
The CPU times it prints measure torch's CPU operations, no device.
"""
import json

import pytest
import torch

from cbtr_tpu_torch import bench

torch.set_num_threads(2)


def test_smoke_preset_on_cpu_prints_the_headline_last(capsys):
    assert bench.main(["--preset", "smoke", "--res", "32", "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    out = json.loads(lines[-1])
    for key in ("metric", "value", "unit", "vs_baseline", "fma_peak_tflops"):
        assert key in out, key
    assert out["unit"] == "rays/s" and out["value"] > 0 and out["vs_baseline"] > 0
    assert "32x32 rays, 450 patches" in out["metric"] and out["device"] == "cpu"
    assert out["breakdown_ms"]["sweep_staged"] > 0
    assert out["breakdown_ms"]["rays"] == 1024 and out["breakdown_ms"]["patches"] == 450
    assert out["kernel_plain_agreement"] == 1.0 and out["recompute_reject_count"] == 0
    assert 0 < out["sweep_executed_pair_frac"] < 1
    assert out["fma_ceiling_tflops"] is None and len(out["fma_peak_runs_tflops"]) == 2
    for row in (*out["breakdown_stats"].values(), out["value_stats"]):
        assert row["n"] == bench.REPS
    # nothing launched on the CPU: every wrapper ran its twin
    assert set(out["kernel_launches"].values()) == {0}


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["--preset", "smoke", "--device", "cuda"])
