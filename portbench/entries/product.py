"""Products back to back: ``spmv(A, x)``, or ``spmm(A, X)`` for a traffic
``k``, as a user's loop issues them.

The window issues calls in chunks of about ``IN_FLIGHT_S`` of device work
and lets at most two chunks wait on the card, so the launch queue never
fills and the card never waits on the host; one synchronize ends it.  The
product time is the window's wall time over every product completed in it.
Two products drawn from the seed and the last are kept and compared with
the plain reference once the window has closed.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Optional

import torch

from portbench.entries import Reading, Window
from portbench.harness import counters, moved
from portbench.precision import control_precision

IN_FLIGHT_S = 0.05
SPACER_S = 0.02  # the device spacer ahead of each stretch of timed enqueues
ENQUEUE_CALLS, ENQUEUE_STRETCHES = 20, 5


@dataclasses.dataclass
class State:
    call: Optional[Callable]
    t_call: float  # seconds a product, from the warm-up
    route: dict  # launch counters one product moved


def _k(run) -> Optional[int]:
    return run.cell.traffic.get("k")


def setup(run) -> State:
    import cask_tpu_torch as ct

    a = run.cell.family.port_matrix(run.cfg, run.make())
    x = run.operand(_k(run))
    op = ct.spmv if _k(run) is None else ct.spmm

    def call():
        return op(a, x)

    before = counters()
    call()  # the first call builds the kernel and any plan the route derives
    run.sync()
    route = moved(before, counters())
    for _ in range(2):
        call()
    run.sync()
    t0 = time.perf_counter()
    for _ in range(3):
        call()
    run.sync()
    return State(call=call, t_call=(time.perf_counter() - t0) / 3, route=route)


def _event(run):
    if run.device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


def window(run, state: State, seconds: float) -> Window:
    chunk = max(1, round(IN_FLIGHT_S / state.t_call))
    keep = run.sample(max(1, int(seconds / state.t_call)))
    samples, pending = {}, collections.deque()
    before = counters()
    n = 0
    t0 = time.perf_counter()
    while True:
        for _ in range(chunk):
            y = state.call()
            if n in keep:
                samples[n] = y
            n += 1
        pending.append(_event(run))
        if len(pending) > 2 and pending[0] is not None:
            pending.popleft().synchronize()
        if time.perf_counter() - t0 >= seconds:
            break
    run.sync()
    elapsed = time.perf_counter() - t0
    samples[n - 1] = y
    return Window(calls=n, elapsed_s=elapsed, samples=samples,
                  launches=moved(before, counters()))


def end_to_end(run, w: Window) -> dict:
    return {"product_us": (w.elapsed_s / w.calls * 1e6, "us")}


def enqueue(run, state: State) -> list:
    """Host µs for one call to return, each stretch of calls behind a device
    spacer long enough that the launch queue holds them all."""
    out = []
    for _ in range(ENQUEUE_STRETCHES):
        run.sync()
        if run.device.type == "cuda":
            torch.cuda._sleep(int(SPACER_S * 1.98e9))  # cycles at the highest SM clock
        for _ in range(ENQUEUE_CALLS):
            t0 = time.perf_counter()
            state.call()
            out.append((time.perf_counter() - t0) * 1e6)
    run.sync()
    return out


def probe(run, state: State) -> None:
    state.call()


def reading(run, state: State, w: Window, view) -> Reading:
    return Reading(view=view, calls=w.calls, dtype=run.cfg["dtype"],
                   counts=run.cell.family.counts(run.cfg, _k(run) or 1),
                   counter_launches=sum(w.launches.values()))


def release(state: State) -> None:
    state.call = None


def _errors(ref, x, outputs: dict, precisions=("exact",)) -> dict:
    """For each output: the largest ``|y − ŷ| / (|A| @ |x|)`` over its rows,
    ŷ the exact reference (non-finite counts as infinite)."""
    errs = {i: 0.0 for i in outputs}
    for r0, r1, ys, scale in ref.blocks(x, precisions):
        exact = ys["exact"]
        scale = scale.clamp_min(torch.finfo(torch.float64).tiny)
        for i, y in outputs.items():
            yb = (ys[y] if isinstance(y, str) else y[r0:r1]).double().reshape(exact.shape)
            e = float(((yb - exact).abs() / scale).amax())
            errs[i] = max(errs[i], e) if e == e else float("inf")
    return errs


def judge(run, w: Window) -> dict:
    """The kept products against the reference, on the inputs made again."""
    inputs = run.make()
    ref = run.cell.family.Reference(run.cfg, inputs)
    return {"y_err": _errors(ref, run.operand(_k(run)), w.samples)}


def control(run) -> dict:
    """The reference in the precision below the configuration's, in the
    program's place, judged as :func:`judge` judges the program."""
    prec = control_precision(run.cfg)
    ref = run.cell.family.Reference(run.cfg, run.make())
    return {"y_err": _errors(ref, run.operand(_k(run)), {0: prec}, ("exact", prec))}
