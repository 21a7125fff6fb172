"""The work the winner kernel's cull leaves, x: the pairs K1 or K2
evaluated a unit by its own counter (pass-1 pairs and retries,
`ops/cuda_sweep.py::pair_counts` over the counted batch,
`portbench/counted.py`) over the pairs of a unit's rays that pass the
per-pair test in both passes (`work/sweep.py::unit_bound`, counted from
the inputs).  1.0 means the cull leaves nothing extra.  None where the
program has no counter or counted nothing."""
from portbench import counted
from portbench.work.sweep import unit_bound


def read(traced):
    batch = counted.batch(traced)
    if batch is None:
        return None
    evaluated = sum(pass1 + retries for pass1, retries in batch.pairs.values())
    if not evaluated:
        return None
    return evaluated / batch.units / unit_bound(traced)["pairs"]
