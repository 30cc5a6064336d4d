"""Host µs for one ``spmv`` or ``spmm`` call to return, the median of the
calls timed behind a device spacer, so that the launch queue is never full
and the time is the entry's own host cost."""

import statistics


def read(reading):
    return statistics.median(reading.enqueue_us) if reading.enqueue_us else None
