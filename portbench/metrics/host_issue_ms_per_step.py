"""Host ms a fit step spends issuing its work: the program's span
`cbtr.step` (`models/lens_model.py`, the step's loss, backward and update
from entry to return; the fit loop's loss read lies outside it), summed
over the counted batch (`portbench/counted.py`: as many steps as the
traced window, after it, with span timing on and the profiler off) and
divided by its steps.  None where the program has no such span."""
from portbench import counted


def read(traced):
    batch = counted.batch(traced)
    if batch is None or "cbtr.step" not in batch.spans:
        return None
    return batch.spans["cbtr.step"][0] / 1e6 / batch.units
