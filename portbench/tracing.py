"""The traced window: ``torch.profiler`` over the card and the host, read
from its Chrome trace into what the per-layer readers take.

A kernel, copy or memset belongs to a range when the host launched it
inside that range (matched by the launch's correlation id): the card's
clock in the trace is aligned to the host's only to some microseconds.
The profiler's first launch takes milliseconds of its own set-up and was
once missing from a trace, so one launch precedes the ranges read.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json
import os
import tempfile

import torch

from portbench.yardstick import busy_us, gaps

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")
WINDOW, PROBE = "portbench.window", "portbench.probe"


@dataclasses.dataclass
class TraceView:
    lo: float  # the window range on the host's clock, µs
    hi: float
    device_ops: list  # trace events launched inside the window
    host_ops: list  # host events inside the window
    probe_names: set  # kernel names launched by one product in the probe range

    @property
    def window_us(self) -> float:
        return self.hi - self.lo

    @property
    def busy_us(self) -> float:
        return busy_us([(e["ts"], e["ts"] + e["dur"]) for e in self.device_ops],
                       self.lo, self.hi)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps of the
        card summed by what the host was doing in them (the innermost host
        event under each gap's midpoint), in seconds."""
        ops = collections.Counter()
        for e in self.device_ops:
            ops[e["name"]] += e["dur"] * 1e-6
        idle = collections.Counter()
        host = sorted(self.host_ops, key=lambda e: e["ts"])
        starts = [e["ts"] for e in host]
        spans = [(e["ts"], e["ts"] + e["dur"]) for e in self.device_ops]
        for a, b in gaps(spans, self.lo, self.hi):
            mid = (a + b) / 2
            # the latest-started host event that spans the midpoint: the innermost
            j = bisect.bisect_right(starts, mid) - 1
            while j >= 0 and host[j]["ts"] + host[j]["dur"] < mid:
                j -= 1
            idle[host[j]["name"] if j >= 0 else "(no host event)"] += (b - a) * 1e-6
        return {"device_ops": [[n, s] for n, s in ops.most_common(top)],
                "idle_gaps": [[n, s] for n, s in idle.most_common(top)]}


def _launched_in(events, lo, hi):
    return {e["args"]["correlation"] for e in events
            if e.get("cat") in ("cuda_runtime", "cuda_driver") and lo <= e["ts"] <= hi
            and "correlation" in e.get("args", {})}


def read_trace(path: str) -> TraceView:
    """The window and probe ranges of an exported Chrome trace."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    ranges = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e["name"] in (WINDOW, PROBE):
            ranges[e["name"]] = (e["ts"], e["ts"] + e["dur"])
    if WINDOW not in ranges:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    lo, hi = ranges[WINDOW]
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    launched = _launched_in(events, lo, hi)
    ops = [e for e in device if e.get("args", {}).get("correlation") in launched]
    host = [e for e in events if e.get("cat") in HOST_CATS and e["name"] != WINDOW
            and e["ts"] < hi and e["ts"] + e["dur"] > lo]
    probe = set()
    if PROBE in ranges:
        in_probe = _launched_in(events, *ranges[PROBE])
        probe = {e["name"] for e in device if e.get("cat") == "kernel"
                 and e.get("args", {}).get("correlation") in in_probe}
    return TraceView(lo=lo, hi=hi, device_ops=ops, host_ops=host, probe_names=probe)


def traced(window, probe):
    """Run ``probe()`` and then ``window()`` under the profiler, each in its
    named range and synchronised; return ``window()``'s result and the view."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        torch.zeros(1, device="cuda" if torch.cuda.is_available() else "cpu").add_(1)
        sync()
        with torch.profiler.record_function(PROBE):
            probe()
            sync()
        with torch.profiler.record_function(WINDOW):
            result = window()
            sync()
    finally:
        prof.stop()
    fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        view = read_trace(path)
    finally:
        os.unlink(path)
    return result, view
