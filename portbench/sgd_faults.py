"""The faults of the SGD step's path (`drivers/sgd_step.py`), planted as
`faults.py` plants its own, and the calibration run with them beside those:

* `sgd_unchanged`: each step computes its loss and gradients and leaves the
  parameters where they were (`faults.unchanged` swaps the Adam step's
  factory, which this path never calls);
* `sgd_half_grad`: the gradients of every other patch are zeroed before the
  update, as a backward that loses half the patches would leave them (the
  forward untouched).

`faults.half_batch` and the rest of `faults.FAULTS` reach this path as
they are.

    python -m portbench.sgd_faults --workload robot450-train4k --seeds 1,2
        --plant sgd_unchanged,sgd_half_grad,half_batch [calibrate's other options]
"""
from __future__ import annotations

import contextlib
import sys


def _step_fault(update):
    """A swap of the multihost factories' `sgd_step`: the port's step at a
    learning rate of 0 (the loss, the gradients, no move), then
    `update(params, grads, learning_rate)`."""
    from cbtr_tpu_torch.parallel import multihost

    from .faults import _swapped

    def make(original):
        def sgd_step(params, partial_image, target, learning_rate, group):
            loss, grads = original(params, partial_image, target, 0.0, group)
            update(params, grads, learning_rate)
            return loss, grads
        return sgd_step

    return _swapped(multihost, "sgd_step", make)


@contextlib.contextmanager
def sgd_unchanged():
    with _step_fault(lambda params, grads, learning_rate: None):
        yield


@contextlib.contextmanager
def sgd_half_grad():
    import torch

    def update(params, grads, learning_rate):
        with torch.no_grad():
            grads[0][1::2] = 0.0
            for p, g in zip((params.control_points, params.refractive_index), grads):
                p -= learning_rate * g

    with _step_fault(update):
        yield


FAULTS = {"sgd_unchanged": sgd_unchanged, "sgd_half_grad": sgd_half_grad}


def main(argv=None) -> int:
    from . import calibrate, faults

    saved = dict(faults.FAULTS)
    faults.FAULTS.update(FAULTS)
    try:
        return calibrate.main(argv)
    finally:
        faults.FAULTS.clear()
        faults.FAULTS.update(saved)


if __name__ == "__main__":
    sys.exit(main())
