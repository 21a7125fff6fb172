"""`correct` turns false under the control and under each fault a cell can
have, planted in the port underneath a whole run (`faults.py`), at a size a
CPU holds.  The harness's look for a card is skipped: `run.run_cell` is
driven directly on the CPU, where the port runs its kernels' plain twins.

Each planted run has to fail a number that a sound run at the same size
keeps within its limit, so that the fault, not the small size, fails it.
The limits are the cells' own, set at their full sizes on the card: a sound
run of the robot cells stays correct at these sizes; the refined fit's loss
reads above its limit at CPU sizes (0.0094 at 48^2 rays against 0.00334; at
its 1024^2 rays 0.00098 at most), so its sound run is not asserted correct."""
from __future__ import annotations

import contextlib
import functools
import time

import pytest

from portbench import cell as cells
from portbench import faults, run

TINY = {"robot450-render4k": {"res": 64, "chunk": 1024, "image_res": 32,
                              "reference_chunk": 1024},
        "refined1800-fit1024": {"res": 48},
        "robot450-fit512": {"res": 48}}
PLANTS = {"robot450-render4k": ["control", "control_build", "half_batch", "altered"],
          "refined1800-fit1024": ["control", "control_build", "half_batch", "altered",
                                  "unchanged"],
          "robot450-fit512": ["control", "control_build", "half_batch", "altered",
                              "unchanged"]}


def _run(workload):
    cell = cells.find_cell(cells.load_benchmark(), workload, traffic_override=TINY[workload])
    return run.run_cell(cell, 3700000001, 0.0, False, device="cpu", t0=time.perf_counter())


@functools.lru_cache(maxsize=None)
def _sound(workload):
    return _run(workload)


def _over(result):
    return {k for k, c in result["checks"].items() if c["value"] > c["limit"]}


@pytest.mark.parametrize("workload", ["robot450-render4k", "robot450-fit512"])
def test_a_sound_run_is_correct(workload):
    result = _sound(workload)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("workload,plant",
                         [(w, p) for w in sorted(PLANTS) for p in PLANTS[w]])
def test_a_planted_fault_turns_correct_false(workload, plant):
    with faults.FAULTS[plant]():
        result = _run(workload)
    assert not result["correct"]
    assert _over(result) - _over(_sound(workload)), (result["checks"],
                                                     _sound(workload)["checks"])


class _NoStep:
    """An optimizer that zeroes gradients and never steps."""

    def __init__(self, opt):
        self.opt = opt

    def zero_grad(self, set_to_none=True):
        self.opt.zero_grad(set_to_none=set_to_none)

    def step(self):
        pass


@contextlib.contextmanager
def _still_after_warm_up(warm_up):
    """The fit step is sound for its first `warm_up` calls (set-up's), then
    leaves the parameters where they are: a path that takes over after the
    warm-up, which only a check after the window sees."""
    from cbtr_tpu_torch.models import lens_model

    original = lens_model.make_opt_train_step

    def make(*args, **kwargs):
        step, calls = original(*args, **kwargs), [0]

        def late(params, opt, start, direction):
            calls[0] += 1
            if calls[0] <= warm_up:
                return step(params, opt, start, direction)
            params, _, loss = step(params, _NoStep(opt), start, direction)
            return params, opt, loss

        return late

    lens_model.make_opt_train_step = make
    try:
        yield
    finally:
        lens_model.make_opt_train_step = original


def test_a_step_that_changes_after_the_warm_up_turns_correct_false():
    workload = "robot450-fit512"
    with _still_after_warm_up(_first_steps(workload)):
        result = _run(workload)
    assert not result["correct"]
    assert "change" in _over(result) - _over(_sound(workload)), result["checks"]


def _first_steps(workload):
    return int(cells.find_cell(cells.load_benchmark(), workload).traffic["first_steps"])
