"""Profiling: ``torch.profiler`` traces and named ranges.

The PyTorch counterpart of :mod:`cask_tpu.utils.profiling`.  :func:`trace`
records the host and, where a CUDA device is present, the card's kernels
and copies, and writes a Chrome trace (``chrome://tracing``, Perfetto) when
the block ends; :func:`annotate` names a range on its timeline.  Wall times
for a kernel come from :mod:`cask_tpu_torch.tune.timing` instead: the
profiler adds its own cost to each launch.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
from typing import Optional

import torch


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """Profile a block and write its Chrome trace into ``logdir``::

        with trace("traces") as d:
            y = op(x)
            torch.cuda.synchronize()

    ``logdir`` defaults to ``$CASK_TPU_TRACE_DIR``, else ``cask_tpu_trace``
    in the temporary directory; it is made if missing and yielded.  The
    file, ``trace-<unique>.json``, is written when the block exits (also
    when it raises).  Sync the device inside the block, or its last
    kernels may fall outside the trace.  On an H100 the first kernel
    launch after the profiler starts takes milliseconds of its set-up, and
    one trace lacked that kernel: launch one warm-up kernel and sync
    before the range you read."""
    logdir = logdir or os.environ.get("CASK_TPU_TRACE_DIR",
                                      os.path.join(tempfile.gettempdir(), "cask_tpu_trace"))
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield logdir
    finally:
        prof.stop()
        fd, path = tempfile.mkstemp(prefix="trace-", suffix=".json", dir=logdir)
        os.close(fd)
        prof.export_chrome_trace(path)


def annotate(name: str):
    """A named range on the profile's timeline (``record_function``); use
    as a context manager or a decorator."""
    return torch.profiler.record_function(name)
