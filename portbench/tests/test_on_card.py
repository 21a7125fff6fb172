"""On the card, at each cell's own size: a sound run is correct and the
control (the port's bfloat16 winner search) is not, on three seeds.  Runs
only where a card is; run it with
`python -m pytest portbench/tests/test_on_card.py -m cuda` on the chip."""
from __future__ import annotations

import contextlib
import time

import pytest

from portbench import cell as cells
from portbench import faults, run


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the port's kernels have no CPU mode")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["robot450-render4k", "refined1800-fit1024",
                                      "robot450-fit512"])
@pytest.mark.parametrize("plant", ["program", "control"])
def test_correct_at_the_cells_size(card, workload, plant):
    cell = cells.find_cell(cells.load_benchmark(), workload)
    run.pin_caches(cell.root)
    for seed in (3800000001, 3800000002, 3800000003):
        ctx = contextlib.nullcontext() if plant == "program" else faults.FAULTS[plant]()
        with ctx:
            result = run.run_cell(cell, seed, 1.0, False, device=card, t0=time.perf_counter())
        assert result["correct"] == (plant == "program"), (seed, result["checks"])
