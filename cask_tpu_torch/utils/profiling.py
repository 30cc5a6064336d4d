"""Profiling: ``torch.profiler`` traces and named ranges.

The PyTorch counterpart of :mod:`cask_tpu.utils.profiling`.  :func:`trace`
records the host and, where a CUDA device is present, the card's kernels
and copies, and writes a Chrome trace (``chrome://tracing``, Perfetto) when
the block ends; :func:`annotate` names a range on its timeline, and is the
port's one span: the solvers and the plan cache mark their phases with it.
Wall times for a kernel come from :mod:`cask_tpu_torch.tune.timing`
instead: the profiler adds its own cost to each launch.
"""

from __future__ import annotations

import contextlib
import functools
import os
import tempfile
from typing import Optional

import torch
import torch.autograd.profiler as _autograd_profiler


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


class annotate:
    """A named range on the profile's timeline; use as a context manager or a
    decorator::

        with annotate("cg.product"):
            ap = op(p)

    With no profiler running, entering and leaving reads one flag (torch's
    own record that a profiler is active) and calls nothing else, so a span
    on a hot path costs the untraced run almost nothing.  Under a profiler
    (:func:`trace`, or any ``torch.profiler.profile``) it opens a
    ``record_function`` range, which the Chrome trace holds beside the
    card's kernels, copies and memsets on one clock.  The flag is read on
    entry, so a decorated function opens a range on each call made under a
    profiler.  An instance is entered once at a time; a decorator makes one
    per call."""

    def __init__(self, name: str):
        self.name = name
        self._range = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self._range = _autograd_profiler.record_function(self.name)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        opened, self._range = self._range, None
        if opened is not None:
            opened.__exit__(*exc)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with annotate(self.name):
                return fn(*args, **kwargs)

        return spanned
