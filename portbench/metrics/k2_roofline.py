"""K2's share of its roofline, in %: as `k1_roofline`, over K2's device
time a unit."""
from portbench.kernels import K2
from portbench.work.sweep import roofline_percent


def read(traced):
    return roofline_percent(traced, K2)
