"""The stage profiler of the render and train step, at a tiny size on the CPU.

On the CPU it takes host times only; every stage of the path must be seen
with its number of calls per forward, and the wrappers must come off again.
"""
import torch

from cbtr_tpu_torch.harness import profile_step
from cbtr_tpu_torch.ops import cuda_sweep as cs
from cbtr_tpu_torch.ops import intersect as ix
from cbtr_tpu_torch.render import render as rd

torch.set_num_threads(2)


def test_profile_step_sees_every_stage_on_cpu():
    originals = [getattr(mod, attr) for _, mod, attr in profile_step.STAGES]
    result = profile_step.run_profile(res=16, runs=1, device="cpu")
    assert [getattr(mod, attr) for _, mod, attr in profile_step.STAGES] == originals
    assert (result["rays"], result["patches"]) == (256, 450)
    calls = {label: s["calls"] for label, s in result["stages_forward"].items()}
    # two refractions, each one winner search and one recompute, on one
    # table build (its plain version on the CPU); CPU tensors run the
    # kernel's plain twin, so the ray pack and K1's launch are not reached;
    # the splat is the matrix product at this size: no segment sum; the
    # recompute runs its plain version on CPU tensors, not its kernels
    assert calls == {"trace_through_lens": 1, "recompute_winner": 2,
                     "winner_search": 2, "tables": 1, "k1_rays": 0, "k1_launch": 0,
                     "screen_hits": 1, "splat_bilinear": 1, "segment_sum": 0,
                     "recompute_forward": 0, "recompute_backward": 0}
    assert all(s["device_ms"] is None for s in result["stages_forward"].values())
    assert result["step_peak_gib"] is None
    assert result["forward_profile"]["busy_share"] is None
    for key in ("forward_ms", "step_ms", "forward_with_grad_ms", "backward_ms"):
        assert result[key] > 0.0, key
    assert 0.0 < result["listed_fraction"] <= 1.0
    assert rd.trace_through_lens.__module__ == "cbtr_tpu_torch.optics.lens"
    assert ix.recompute_winner.__name__ == "recompute_winner"
    assert cs.launch.__name__ == "launch"


def test_profile_step_chunks_the_rays_on_cpu():
    """--chunk reaches the forward: each refraction searches and recomputes
    its winners a chunk at a time."""
    result = profile_step.run_profile(res=16, runs=1, device="cpu", chunk=64)
    assert result["chunk"] == 64 and result["rays"] == 256
    calls = {label: s["calls"] for label, s in result["stages_forward"].items()}
    assert calls["winner_search"] == 2 * 4 and calls["recompute_winner"] == 2 * 4, calls
    assert calls["screen_hits"] == 1 and calls["splat_bilinear"] == 1, calls
    # the tables once a trace, whatever the chunk count
    assert calls["tables"] == 1, calls
    assert 0.0 < result["listed_fraction"] <= 1.0


def test_profile_step_times_the_backward_stages_on_cpu():
    """The backward's stages: each chunk's checkpoint re-runs its recompute
    (stopped early by an exception, still timed) and each gather's gradient
    is one segment sum; the forward's calls are not counted again."""
    result = profile_step.run_profile(res=16, runs=1, device="cpu", chunk=64)
    calls = {label: s["calls"] for label, s in result["stages_backward"].items()}
    assert calls["recompute_winner"] == 2 * 4 and calls["segment_sum"] == 2 * 4, calls
    assert calls["winner_search"] == 0 and calls["splat_bilinear"] == 0, calls
    assert result["stages_backward"]["segment_sum"]["host_ms"] > 0.0
    assert ix.recompute_winner.__name__ == "recompute_winner"
