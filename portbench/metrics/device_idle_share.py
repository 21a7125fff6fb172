"""The device's idle share, in %: 100 x (1 - the device's busy time a unit
over the host's time a unit).  The busy time is the union of the device
ops' intervals in the traced window; the host's time is that of the same
number of units run untraced just before it, since the profiler's own cost
a launch would lengthen a traced unit that the host's launches bound."""


def read(traced):
    if not traced.device_ops or not traced.untraced_s:
        return None
    return 100.0 * (1.0 - traced.busy_s() / traced.untraced_s)
