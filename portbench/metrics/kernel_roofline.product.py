"""The product's share of its roofline: the frozen bound of one product (the
caller's entries and the operand and result once, over the card's peak)
over the device time of every kernel, copy and memset that the window's
products launched, per product.  The window issues products and nothing
else, so whatever route implements them is counted whole."""

from portbench.readers import roofline_percent


def read(reading):
    if not reading.calls or not reading.view.device_ops:
        return None
    busy = sum(e["dur"] for e in reading.view.device_ops)
    return roofline_percent(reading, busy / reading.calls)
