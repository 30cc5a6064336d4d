"""A closed loop of CG solves: ``cg(A, b, tol=tol, maxiter=maxiter)`` from
``x0 = 0``, one after another, as HPCG runs its CG sets.

``b`` is drawn from the seed, as the operands of the product cells are.
The solve time is the window's wall time over the solves completed in it.
Every solve's iteration count is compared with
``maxiter``; two solves drawn from the seed and the last keep their ``x``,
which is compared with the plain reference's CG, the same recurrence in
f64, once the window has closed.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from portbench.entries import Reading, Window
from portbench.harness import counters, moved
from portbench.precision import as_precision, control_precision


@dataclasses.dataclass
class State:
    solve: Optional[Callable]
    product: Optional[Callable]  # the solve's own product, once, for the trace's probe
    t_solve: float
    route: dict  # launch counters one product of the solve moved


def setup(run) -> State:
    import cask_tpu_torch as ct

    a = run.cell.family.port_matrix(run.cfg, run.make())
    b = run.operand(None)
    tol, maxiter = float(run.cell.traffic["tol"]), int(run.cell.traffic["maxiter"])

    def solve():
        return ct.solvers.cg(a, b, tol=tol, maxiter=maxiter)

    def product():
        return ct.spmv(a, b)

    before = counters()
    product()  # the first call builds the kernel
    run.sync()
    route = moved(before, counters())
    t0 = time.perf_counter()
    solve()
    run.sync()
    return State(solve=solve, product=product, t_solve=time.perf_counter() - t0, route=route)


def window(run, state: State, seconds: float) -> Window:
    keep = run.sample(max(1, int(seconds / state.t_solve)))
    samples, iters, times = {}, [], []
    before = counters()
    t0 = end = time.perf_counter()
    while end - t0 < seconds:
        start = end
        res = state.solve()
        run.sync()
        end = time.perf_counter()
        iters.append(res.iterations)
        times.append(end - start)
        if len(iters) - 1 in keep:
            samples[len(iters) - 1] = res.x
    samples[len(iters) - 1] = res.x
    ms = sorted(t * 1e3 for t in times)
    run.log(f"[window] {len(ms)} solves, ms each: least {ms[0]:.3f}, median "
            f"{ms[len(ms) // 2]:.3f}, most {ms[-1]:.3f}; in order: "
            f"{' '.join(f'{t * 1e3:.1f}' for t in times)}")
    return Window(calls=len(iters), elapsed_s=end - t0, samples=samples,
                  iterations=iters, launches=moved(before, counters()))


def end_to_end(run, w: Window) -> dict:
    return {"solve_ms": (w.elapsed_s / w.calls * 1e3, "ms")}


def enqueue(run, state: State) -> None:
    return None


def probe(run, state: State) -> None:
    state.product()


def reading(run, state: State, w: Window, view) -> Reading:
    return Reading(view=view, calls=w.calls, dtype=run.cfg["dtype"],
                   counts=run.cell.family.counts(run.cfg, 1), iterations=sum(w.iterations),
                   counter_launches=sum(w.launches.get(k, 0) for k in state.route))


def release(state: State) -> None:
    state.solve = state.product = None


def reference_cg(ref, b: torch.Tensor, maxiter: int, precision: str) -> torch.Tensor:
    """Plain CG from ``x0 = 0`` for ``maxiter`` iterations, in ``precision``:
    the port's recurrence with no preconditioner."""
    b, _ = as_precision(b, precision)
    x = torch.zeros_like(b)
    r = b - ref.apply(x, precision)
    p = r
    rz = torch.dot(r, r)
    for _ in range(maxiter):
        ap = ref.apply(p, precision)
        alpha = rz / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rz_new = torch.dot(r, r)
        p = r + (rz_new / rz) * p
        rz = rz_new
    return x


def _judge(run, outputs: dict, iters: dict, precision: Optional[str] = None) -> dict:
    ref = run.cell.family.Reference(run.cfg, run.make())
    b = run.operand(None)
    maxiter = int(run.cell.traffic["maxiter"])
    exact = reference_cg(ref, b, maxiter, "exact")
    if precision is not None:
        outputs = {0: reference_cg(ref, b, maxiter, precision)}
    norm = float(torch.linalg.vector_norm(exact))
    errs = {}
    for i, x in outputs.items():
        e = float(torch.linalg.vector_norm(x.double() - exact)) / norm
        errs[i] = e if e == e else float("inf")
    return {"x_err": errs, "iters_off": {i: abs(n - maxiter) for i, n in iters.items()}}


def judge(run, w: Window) -> dict:
    """Each kept ``x`` against the reference's CG; each solve's iterations
    against ``maxiter``."""
    return _judge(run, w.samples, dict(enumerate(w.iterations)))


def control(run) -> dict:
    """The reference's CG in the precision below the configuration's."""
    return _judge(run, {}, {0: int(run.cell.traffic["maxiter"])}, control_precision(run.cfg))
