"""The A/B harness of the winner kernels (harness/kernel_ab.py), on the CPU.

Its timings need the card; what it does around them runs here: the capture
of the second refraction's rays, the digest of a result, the merge of the
two checkouts' runs, the probe process, which imports the package of
the checkout it is started in and refuses to run without a CUDA device, and
the rule by which a profiler session of the segment sum counts.
"""
import os
import types

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


class _Session:
    """A stand-in for torch.profiler.profile whose sessions give the canned
    device kernels of `sessions` in turn."""

    def __init__(self, sessions):
        self.sessions, self.opened = iter(sessions), 0

    def __call__(self, activities):
        names = next(self.sessions)
        self.opened += 1
        span = types.SimpleNamespace
        self.ops = [span(name=n, device_type=torch.autograd.DeviceType.CUDA,
                         time_range=span(start=10 * i, end=10 * i + 5))
                    for i, n in enumerate(names)]
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def events(self):
        return self.ops


@pytest.mark.parametrize("sessions, stages, used, opened", [
    # the first session dropped a record: the next two agree
    ([["Memset", "fold_rows"], ["Memset", "tile_histogram", "fold_rows"],
      ["Memset", "tile_histogram", "fold_rows"]], (), 3, 3),
    # another checkout's kernels (a sort and a fold) count without names
    ([["sort", "searchsorted", "fold_level"]] * 2, (), 3, 2),
    # this checkout's: two sessions agree but lack a stage, the next has it
    ([["Memset", "fold_rows"]] * 2 + [["Memset", "scan_nodes", "fold_rows"]] * 2,
     ("scan_nodes", "fold_"), 3, 4),
    # sessions that saw nothing never count; full and short ones alternate
    ([[], [], ["Memset", "scan_nodes", "fold_rows"], ["Memset"],
      ["Memset", "scan_nodes", "fold_rows"]], ("fold_",), 3, 5),
])
def test_device_kernels_counts_a_session_an_earlier_one_agrees_with(monkeypatch, sessions, stages,
                                                                    used, opened):
    """A profiler session counts only when it saw some device op, as many as
    an earlier session did, and each named stage; the ops are filed by the
    segment sum's kernel names and the busy time is their union."""
    fake = _Session(sessions)
    monkeypatch.setattr(torch.profiler, "profile", fake)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    ops, busy, per, taken = kernel_ab.device_kernels(lambda: None, stages)
    assert (ops, taken, fake.opened) == (used, opened, opened)
    assert busy == pytest.approx(used * 5 / 1e3)
    assert sum(per.values()) == pytest.approx(busy)
    assert set(per) <= set(kernel_ab.SEGMENT_KERNELS) | set(sessions[-1])


def test_device_kernels_raises_when_no_two_sessions_agree(monkeypatch):
    monkeypatch.setattr(torch.profiler, "profile",
                        _Session([["a"] * (i + 1) for i in range(8)]))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    with pytest.raises(RuntimeError, match=r"no two sessions .*\[1, 2, 3, 4, 5, 6, 7, 8\]"):
        kernel_ab.device_kernels(lambda: None, tries=8)


def test_stage_names_are_checked_in_this_checkout_only(tmp_path, monkeypatch):
    """The segment sum's stages are this checkout's kernel names: a probe of
    another checkout (run with this file) does not require them."""
    assert kernel_ab._this_package()
    monkeypatch.setattr(cbtr_tpu_torch, "__file__",
                        str(tmp_path / "cbtr_tpu_torch" / "__init__.py"))
    assert not kernel_ab._this_package()


def test_op_name_tells_torch_kernels_apart():
    """Unknown kernels are filed by their name up to the parameters, without
    `void` and `at::native::`: a fill and a copy stay apart (their first 40
    characters did not); the port's kernels by their own names."""
    fill = ("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float>, "
            "std::array<char*, 1ul> >(int, at::native::FillFunctor<float>, std::array<char*, 1ul>)")
    copy = ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<"
            "at::native::direct_copy_kernel_cuda(at::TensorIteratorBase&)::{lambda()#3}")
    assert kernel_ab._op_name(fill).startswith("vectorized_elementwise_kernel<4, FillFunctor")
    assert kernel_ab._op_name(copy).startswith("elementwise_kernel<128, 2, gpu_kernel_impl")
    assert kernel_ab._op_name(fill) != kernel_ab._op_name(copy)
    assert len(kernel_ab._op_name(fill)) <= 72
    assert set(kernel_ab.TABLE_KERNELS) <= set(kernel_ab.KERNEL_NAMES)


def test_op_name_drops_the_anonymous_namespace():
    """The port's kernels live in anonymous namespaces: the profiler's
    `void (anonymous namespace)::emitter_kernel(...)` is `emitter_kernel`."""
    name = "void (anonymous namespace)::emitter_kernel((anonymous namespace)::EmitterArgs)"
    assert kernel_ab._op_name(name) == "emitter_kernel"


def test_per_call_divides_one_session_by_its_calls(monkeypatch):
    """`_per_call` profiles `calls` calls in one session (by
    `device_kernels`' rule) and reports ops, busy and device ms by kernel
    per call, the port's kernels under their own names."""
    name = "(anonymous namespace)::tables_kernel(float const*, float const*, int, int, int)"
    fake = _Session([[name] * 20] * 2)
    monkeypatch.setattr(torch.profiler, "profile", fake)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    calls = []
    row = kernel_ab._per_call(lambda: calls.append(1), 20)
    assert len(calls) == 20 * 3          # the warm-up, then two sessions
    assert row["device_ops"] == 1.0 and row["profiler_sessions"] == 2
    assert row["busy_ms"] == pytest.approx(20 * 5 / 1e3 / 20)
    assert row["kernels_ms"] == {"tables_kernel": pytest.approx(5 / 1e3)}


@pytest.mark.parametrize("flags, want", [({}, []), ({"segment_sum_only": True},
                                                    ["--segment-sum-only"]),
                                         ({"tables_only": True}, ["--tables-only"])])
def test_run_checkout_passes_the_probe_its_rows(monkeypatch, flags, want):
    """The probe process gets --segment-sum-only or --tables-only as asked,
    and its last line is the result."""
    seen = []

    def run(args, **kwargs):
        seen.append(args)
        return types.SimpleNamespace(returncode=0, stdout='[probe] x\n{"row": {}}\n', stderr="")

    monkeypatch.setattr(kernel_ab.subprocess, "run", run)
    assert kernel_ab.run_checkout("/nowhere", **flags) == {"row": {}}
    assert seen[0][4:] == want
