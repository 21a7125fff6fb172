"""The program's spans and counters as the benchmark reads them: the
counted batch, the readers of `host_issue_ms_per_step` and `cull_excess`
on synthetic batches, and the breakdown labelled by the program's spans
on synthetic timings."""
from __future__ import annotations

import os
from types import SimpleNamespace

import pytest

from portbench import cell as cells
from portbench import counted, program_spans, tracing


def _reader(name):
    return cells._load(os.path.join(cells.PACKAGE_DIR, "metrics", f"{name}.py"),
                       f"portbench.metrics.{name}").read


def _traced(batch, pairs_per_unit=1000.0, units=4):
    state = SimpleNamespace(_counted_batch=batch, _sweep_bound={"pairs": pairs_per_unit})
    return tracing.Traced(units=units, window=(0.0, 1.0), device_ops=[], spans=[],
                          state=state, cell=None)


def test_host_issue_is_the_step_span_a_step():
    read = _reader("host_issue_ms_per_step")
    batch = counted.Counted(units=4, seconds=0.1,
                            spans={"cbtr.step": [52_000_000, 4],
                                   "cbtr.step.backward": [30_000_000, 4]}, pairs={})
    assert read(_traced(batch)) == pytest.approx(13.0)
    assert read(_traced(batch._replace(spans={}))) is None
    # a program without the switches ran no counted batch
    assert read(_traced(None)) is None


def test_cull_excess_is_evaluated_pairs_over_the_bound():
    read = _reader("cull_excess")
    batch = counted.Counted(units=4, seconds=0.1, spans={},
                            pairs={"sweep_select": (30_000, 2_000), "winner": (0, 0)})
    assert read(_traced(batch, pairs_per_unit=1000.0)) == pytest.approx(8.0)
    assert read(_traced(batch._replace(pairs={"sweep_select": (0, 0)}))) is None
    assert read(_traced(None)) is None


def test_counted_batch_runs_once_under_timing_and_counting():
    from cbtr_tpu_torch.ops import cuda_sweep
    from cbtr_tpu_torch.utils import profiling

    calls = []

    def unit():
        assert profiling.counting_enabled()
        with profiling.span("cbtr.step"):
            calls.append(1)
        return 1, True

    state = SimpleNamespace(unit=unit)
    traced = tracing.Traced(units=3, window=(0.0, 1.0), device_ops=[], spans=[], state=state,
                            cell=None, untraced_s=0.3)
    batch = counted.batch(traced)
    assert counted.batch(traced) is batch and len(calls) == 3
    assert batch.spans["cbtr.step"][1] == 3 and batch.units == 3
    assert set(batch.pairs) == set(cuda_sweep._counted)
    assert not profiling.counting_enabled() and not profiling._ON


def test_counted_batch_is_none_without_the_switches(monkeypatch):
    from cbtr_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "timing")
    calls = []
    assert counted.run(lambda: calls.append(1), 3) is None
    assert calls == []


def test_gaps_are_labelled_by_the_innermost_program_span_on_any_thread():
    main, autograd = 11, 12
    ops = [("k1", 0.0, 10.0), ("k2", 40.0, 50.0), ("k3", 70.0, 80.0), ("k4", 95.0, 100.0)]
    harness = [(tracing.WINDOW_SPAN, 0.0, 100.0), ("portbench.unit", 0.0, 100.0),
               ("portbench.backward", 12.0, 90.0)]
    program = [("cbtr.step", 0.0, 100.0, main), ("cbtr.step.backward", 12.0, 90.0, main),
               ("cbtr.backward.refract", 15.0, 38.0, autograd),
               ("cbtr.backward.recompute", 20.0, 22.0, autograd)]
    traced = tracing.Traced(units=1, window=(0.0, 100.0), device_ops=ops, spans=harness,
                            state=None, cell=None)
    b = program_spans.breakdown(traced, program, main_thread=main)
    # the gap 10-40 sits inside the autograd thread's refract backward; the
    # gap 50-70 in the main thread's backward alone; 80-95 likewise
    assert b["idle_gaps"] == [["cbtr.step.backward", pytest.approx(3.5e-5)],
                              ["cbtr.backward.refract", pytest.approx(3e-5)]]
    assert b["idle_gaps_main"] == [["cbtr.step.backward", pytest.approx(6.5e-5)]]
    assert b["device_ops"] == tracing.breakdown(traced)["device_ops"]
    # a gap no program span encloses takes the harness's label
    b = program_spans.breakdown(traced, [], main_thread=main)
    assert b["idle_gaps"] == [["portbench.backward", pytest.approx(6.5e-5)]]
