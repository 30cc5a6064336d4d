"""Arithmetic the per-layer readers share (``portbench/metrics/*.py``).

A reader takes a :class:`portbench.entries.Reading` and returns a number,
or None where the trace holds nothing for it to read (the harness then
leaves the metric out); it never returns 0 for a share of a roofline.
"""

from __future__ import annotations

from portbench.yardstick import bound_seconds


def roofline_percent(reading, device_us_per_product: float):
    """The frozen bound of one product over its device time, in %."""
    if not device_us_per_product > 0:
        return None
    return bound_seconds(reading.counts, reading.dtype) * 1e6 / device_us_per_product * 100


def product_ops(reading) -> list:
    """The window's device operations of the product's own kernels: those
    named as the kernels one product launched in the probe range."""
    return [e for e in reading.view.device_ops if e["name"] in reading.view.probe_names]


def idle_percent(reading):
    view = reading.view
    if not view.window_us > 0 or not view.device_ops:
        return None
    return (1 - view.busy_us / view.window_us) * 100


def per_iteration(reading, total: float):
    if not reading.iterations:
        return None
    return total / reading.iterations
