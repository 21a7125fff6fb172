"""Device ops (kernels, copies, fills) of the traced steps, a step."""


def read(traced):
    return len(traced.device_ops) / traced.units if traced.device_ops else None
