"""What the device trace of a distributed product holds of its exchange:
the NCCL kernels beside the rest, and the device operations that the
host launched inside one of the program's spans.

A kernel, copy or memset belongs to a span when the host launched it
inside that span (matched by the launch's correlation id, as
``portbench.tracing`` matches the window's): the card's clock in the trace
is aligned to the host's only to some microseconds.
"""

from __future__ import annotations

from portbench.spans import overlap_us, union
from portbench.tracing import _launched_in
from portbench.yardstick import busy_us


def is_nccl(op: dict) -> bool:
    return "nccl" in op["name"].lower()


def exposed_us(view):
    """Microseconds of the window in which an NCCL kernel runs and no other
    kernel, copy or memset does; None without device operations."""
    if not view.device_ops:
        return None
    clip = [(max(e["ts"], view.lo), min(e["ts"] + e["dur"], view.hi)) for e in view.device_ops]
    nccl = union(s for s, e in zip(clip, view.device_ops) if is_nccl(e) and s[1] > s[0])
    rest = union(s for s, e in zip(clip, view.device_ops) if not is_nccl(e) and s[1] > s[0])
    return busy_us(nccl, view.lo, view.hi) - overlap_us(nccl, rest)


def launched_under(view, name: str):
    """The device operations the host launched inside spans named ``name``;
    None where the trace holds no such span or no device operation."""
    spans = [e for e in view.host_ops if e.get("cat") == "user_annotation" and e["name"] == name]
    if not spans or not view.device_ops:
        return None
    ids = set()
    for e in spans:
        ids |= _launched_in(view.host_ops, e["ts"], e["ts"] + e["dur"])
    return [e for e in view.device_ops if e.get("args", {}).get("correlation") in ids]
