"""A rank's distributed product against its roofline: the frozen bound of
the rank's share (its entries' values, its x and y once, the halo rows it
receives once) over the union of the device intervals of every kernel,
copy and memset that the window's products launched, per product.  A
union, because the NCCL kernels run beside the interior."""

from portbench.readers import roofline_percent


def read(reading):
    if not reading.calls or not reading.view.device_ops:
        return None
    return roofline_percent(reading, reading.view.busy_us / reading.calls)
