"""The arithmetic of the compared numbers, on synthetic leaves."""
from __future__ import annotations

import pytest
import torch

from portbench import compare
from portbench.set_limits import limit_of


def test_leaf_norms_are_each_patch_then_the_index():
    cp = torch.zeros(3, 10, 3)
    cp[1, 0, 0], cp[2] = 3.0, 1.0
    norms = compare.leaf_norms(cp, torch.tensor(-2.0))
    assert norms.tolist() == pytest.approx([0.0, 3.0, 30 ** 0.5, 2.0])


def test_leaf_gap_reads_the_worst_leaf_or_a_quantile():
    ref = torch.ones(101, dtype=torch.float64)
    got = ref.clone()
    got[7] = 3.0                                   # one leaf off by 2x its norm
    assert compare.leaf_gap(got, ref, ref, 1.0) == pytest.approx(2.0)
    assert compare.leaf_gap(got, ref, ref, 0.95) == 0.0
    got[:10] = 1.5                                 # a tenth of the leaves off by half
    assert compare.leaf_gap(got, ref, ref, 0.95) == pytest.approx(0.5)
    assert compare.leaf_gap(got, ref, ref, 0.5) == 0.0


def test_leaf_gap_leaves_out_leaves_by_the_reference_gradient():
    ref = torch.ones(11, dtype=torch.float64)
    grad = torch.ones(11, dtype=torch.float64)
    got = ref.clone()
    got[3] = 9.0
    grad[3] = 1e-4                                 # no ray reaches leaf 3 in the reference
    assert compare.leaf_gap(got, ref, grad, 1.0) == 0.0
    grad[3] = 1e-2
    assert compare.leaf_gap(got, ref, grad, 1.0) == pytest.approx(8.0)


def test_leaf_gap_is_over_the_larger_of_the_leaf_and_the_median_leaf():
    ref = torch.tensor([1.0, 1.0, 1.0, 1e-3], dtype=torch.float64)
    got = ref.clone()
    got[3] = 2e-3                                  # a small leaf off by its own size
    assert compare.leaf_gap(got, ref, torch.ones(4, dtype=torch.float64), 1.0) == \
        pytest.approx(1e-3)


def test_limits_lie_between_the_sound_readings_and_the_least_separating_plant():
    readings = {"program": [0.01, 0.02], "control": [0.05, 0.5], "control_build": [0.3],
                "altered": [0.1], "unchanged": [0.07]}
    # the control's 0.05 is under 3x the lower, altered's 0.1 under 10x: unchanged's 0.07 (3x)
    fit = limit_of(readings, fit=True)
    assert (fit["upper"], fit["upper_from"]) == (0.07, "unchanged")
    assert fit["limit"] == pytest.approx(0.02 * 3.5 ** 0.6, rel=1e-3)
    # a render cell's faults set no upper reading
    assert limit_of(readings, fit=False)["upper_from"] == "control_build"
    assert limit_of({"program": [0.0], "control": [0.0]}, fit=False)["limit"] == 0.0
    assert limit_of({"program": [0.1], "control": [0.2]}, fit=False)["limit"] is None
