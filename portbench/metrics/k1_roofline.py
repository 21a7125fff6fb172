"""K1's share of its roofline, in %: the least time the H100 could take for
the winner search of a unit (`work.sweep`: the pairs that pass the per-pair
candidate test in both passes, counted from the inputs) over K1's device
time a unit in the traced window."""
from portbench.kernels import K1
from portbench.work.sweep import roofline_percent


def read(traced):
    return roofline_percent(traced, K1)
