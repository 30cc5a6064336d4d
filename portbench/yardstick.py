"""The benchmark's frozen yardstick: peaks, the roofline bound, the union of
device intervals and the seed's sub-streams.

Copied, not imported, from the port (``bench/roofline.py``'s byte model,
``utils/platform.py``'s bandwidth table, ``chip_smoke.py``'s ``_busy_us``), so
that a later change to the port cannot move what it is measured against.
The byte count here is the caller's: every stored entry once, the operand
read once and the result written once.  No pack's slots, padding or index
bytes are counted, so a change of layout cannot change the denominator.
"""

from __future__ import annotations

# NVIDIA's H100 SXM5 data sheet (80 GB HBM3, 700 W): dense rates without
# sparsity, outside the tensor cores for the float types the kernels use.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
VALUE_BYTES = {"float32": 4, "float64": 8}


def product_counts(entries: int, rows: int, cols: int, dtype: str, k: int) -> dict:
    """Bytes and flops of one ``A @ X`` with ``X`` (cols, k): the entries'
    values once, X read once, Y written once; two flops per entry and column."""
    vb = VALUE_BYTES[dtype]
    return {"entries": entries, "bytes": entries * vb + (rows + cols) * k * vb,
            "flops": 2 * entries * k}


def bound_seconds(counts: dict, dtype: str) -> float:
    """The least time the card can take for the work: the larger of bytes over
    the HBM bandwidth and flops over the peak rate."""
    return max(counts["bytes"] / HBM_BYTES_PER_S, counts["flops"] / PEAK_FLOPS[dtype])


def busy_us(spans, lo: float, hi: float) -> float:
    """Microseconds of [lo, hi] covered by the union of ``(start, end)`` spans."""
    busy, end = 0.0, lo
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in spans):
        a = max(a, end)
        if b > a:
            busy += b - a
            end = b
    return busy


def gaps(spans, lo: float, hi: float):
    """The ``(start, end)`` intervals of [lo, hi] that no span covers."""
    out, end = [], lo
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in spans):
        if a > end:
            out.append((end, a))
        end = max(end, b)
    if hi > end:
        out.append((end, hi))
    return out


def sub_seed(seed: int, stream: int) -> int:
    """A seed for one stream of draws (matrix, operand, sample), from the run's
    ``--seed``: any whole number, also above 32 bits."""
    return (int(seed) * 1_000_003 + 7919 * int(stream)) % (2 ** 63 - 1)
