"""The card's idle time under the port's own spans: the ranges that
``cask_tpu_torch.utils.profiling.annotate`` opens under the profiler, which
the trace holds as ``user_annotation`` events on the host's clock.

An idle gap is a stretch of the window that no kernel, copy or memset
covers (``portbench.yardstick.gaps``); the part of it that lies inside a
span is the idle the host's work in that span leaves on the card.
"""

from __future__ import annotations

from portbench.yardstick import gaps


def union(spans) -> list:
    """The ``(start, end)`` spans merged into disjoint intervals, in order."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def overlap_us(xs, ys) -> float:
    """The length of the intersection of two lists of disjoint, ordered intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if hi > lo:
            total += hi - lo
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_under(view, name: str):
    """Microseconds of the window in which the card is idle and the host is
    inside a span named ``name``; None where the trace holds no such span or
    no device operation."""
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in view.host_ops
             if e.get("cat") == "user_annotation" and e["name"] == name]
    if not spans or not view.device_ops:
        return None
    idle = gaps([(e["ts"], e["ts"] + e["dur"]) for e in view.device_ops], view.lo, view.hi)
    return overlap_us(idle, union(spans))
