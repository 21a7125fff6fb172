"""Device ms a render of the port's ray synthesis: the program's span
`cbtr.emitter` (`render/emitters.py::synthesize`), which under `timing()`
records a CUDA event pair at its open and close (`cbtr.emitter.device`),
summed over the counted batch (`portbench/counted.py`: as many renders as
the traced window, after it, span timing on and the profiler off) and
divided by its renders.  None where the program has no such span."""
from portbench import counted


def read(traced):
    batch = counted.batch(traced)
    if batch is None or "cbtr.emitter.device" not in batch.spans:
        return None
    return batch.spans["cbtr.emitter.device"][0] / 1e6 / batch.units
