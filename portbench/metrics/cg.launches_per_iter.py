"""Device operations (kernels, copies, memsets) an iteration, from the trace."""

from portbench.readers import per_iteration


def read(reading):
    return per_iteration(reading, len(reading.view.device_ops)) if reading.view.device_ops \
        else None
