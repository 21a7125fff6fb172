"""The end-to-end arithmetic and the trace's busy-time arithmetic on
synthetic timings."""
from __future__ import annotations

import os

import pytest

from portbench import tracing, window


def test_rate_is_all_work_over_all_time():
    win = window.Window(unit_s=[0.1, 0.3, 0.2], work=[100, 100, 50], ok=[True] * 3,
                        seconds=0.8)
    # not the median of the units' rates (1000, 333, 250 a second)
    assert window.rate(win) == pytest.approx(250 / 0.8)


def test_p95_is_over_every_step():
    steps = [0.010] * 190 + [0.050] * 10
    assert window.percentile(steps, 95.0) == 0.010
    assert window.percentile(steps + [0.060], 95.0) == 0.050
    assert window.percentile(list(range(1, 101)), 95.0) == 95
    assert window.percentile([7.0], 95.0) == 7.0


def test_run_counts_the_unit_under_way_when_the_time_passes():
    calls = []

    def unit():
        calls.append(1)
        return 10, len(calls) != 2

    win = window.run(unit, 0.0)
    assert len(win.work) == 1 and win.ok == [True]
    win = window.run(unit, 0.02)
    assert sum(win.work) == 10 * len(win.work) and win.seconds >= 0.02
    assert win.ok.count(False) == (1 if len(calls) >= 2 else 0)


def test_busy_is_the_union_of_intervals_inside_the_window():
    ops = [("a", 0.0, 10.0), ("b", 5.0, 15.0), ("c", 20.0, 30.0), ("d", 95.0, 120.0)]
    assert tracing.busy_us(ops, (0.0, 100.0)) == 15.0 + 10.0 + 5.0
    gaps = tracing.idle_gaps(ops, (0.0, 100.0))
    assert gaps == [(15.0, 20.0), (30.0, 95.0)]


def test_breakdown_labels_gaps_by_the_innermost_span():
    ops = [("void (anonymous namespace)::k1<0, false>(float const*)", 0.0, 10.0),
           ("k2(int)", 40.0, 50.0)]
    spans = [(tracing.WINDOW_SPAN, 0.0, 50.0), ("portbench.unit", 0.0, 50.0),
             ("portbench.backward", 12.0, 38.0)]
    traced = tracing.Traced(units=1, window=(0.0, 50.0), device_ops=ops, spans=spans,
                            state=None, cell=None)
    b = tracing.breakdown(traced)
    assert b["device_ops"] == [["k1", 1e-5], ["k2", 1e-5]]
    assert b["idle_gaps"] == [["portbench.backward", 3e-5]]
    assert traced.kernel_ms(["k1"]) == pytest.approx(0.01)
    assert traced.busy_s() == pytest.approx(2e-5)



def test_base_names_of_unbalanced_brackets_end():
    assert tracing.base_name("void at::native::vectorized_elementwise_kernel<4, "
                             "at::native::CUDAFunctor_add<float>, std::array<char*, 3ul> >"
                             "(int, at::native::CUDAFunctor_add<float>, std::array<char*, 3ul>)"
                             ) == "vectorized_elementwise_kernel"
    assert tracing.base_name("void k<(anonymous namespace)::op<, 2>(int)").startswith("k")


def test_idle_share_is_busy_time_over_untraced_unit_time():
    from portbench import cell as cells

    reader = cells._load(os.path.join(cells.PACKAGE_DIR, "metrics", "device_idle_share.py"),
                         "portbench.metrics.device_idle_share").read
    ops = [("a", 0.0, 3e5), ("b", 2e5, 4e5)]       # 0.4 s busy of a 1 s traced window
    traced = tracing.Traced(units=2, window=(0.0, 1e6), device_ops=ops, spans=[],
                            state=None, cell=None, untraced_s=0.5)
    # against the untraced units' 0.5 s, not the traced window's 1 s
    assert reader(traced) == pytest.approx(20.0)
    assert reader(traced._replace(device_ops=[])) is None
    assert reader(traced._replace(untraced_s=0.0)) is None


def test_ranges_mirrored_on_the_device_timeline_are_no_device_ops():
    from types import SimpleNamespace

    import torch

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    kernel = SimpleNamespace(device_type=cuda, is_user_annotation=False)
    adam = SimpleNamespace(device_type=cuda, is_user_annotation=True)
    host = SimpleNamespace(device_type=cpu, is_user_annotation=False)
    assert [tracing.is_device_op(e) for e in (kernel, adam, host)] == [True, False, False]
