"""Products of a row-partitioned matrix across the ranks of a world, as a
user's ``torchrun`` job issues them: each rank joins through the port's
``init_world()`` and ``row_mesh()``, makes its own rows on its card, hands
them to ``interop.bdia_shard_from_arrays``, and applies
``DistSpmv(shard).padded_op`` (its defaults: the overlap on, the interior
``auto``) to its rows of x back to back, through ``spmv``.

The window's call count is the same on every rank, the least of the ranks'
proposals (``run.agree``), since each call exchanges halos with the ring
neighbours.  It issues the calls in chunks, as ``entries/product.py``
does.  The product time is the window's wall time over its calls; the
merge of the ranks' lines takes the slowest.  Two products drawn from the
seed and the last are kept, and each rank compares its rows with the plain
reference once the window has closed.

It needs the rank-local shard of the port: on a port without it, set-up
fails at the import, before anything is made.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import time
from typing import Callable, Optional

from portbench.entries import Reading, Window
from portbench.entries.product import IN_FLIGHT_S, _errors, _event
from portbench.harness import counters, moved
from portbench.precision import control_precision


@dataclasses.dataclass
class State:
    call: Optional[Callable]
    t_call: float  # seconds a product, from the warm-up
    route: dict  # launch counters one product moved
    joined: bool  # the entry made the process group, and ends it


def setup(run) -> State:
    import torch.distributed as dist

    from cask_tpu_torch.interop import bdia_shard_from_arrays  # noqa: F401  (fails first)
    import cask_tpu_torch as ct
    from cask_tpu_torch.parallel import DistSpmv, init_world, row_mesh

    joined = not dist.is_initialized()
    init_world("nccl" if run.device.type == "cuda" else "gloo")
    mesh = row_mesh(device=run.device)
    if (mesh.rank, mesh.size) != (run.rank, run.world):
        raise RuntimeError(f"the program's rank {mesh.rank} of {mesh.size} is the harness's "
                           f"{run.rank} of {run.world}")
    fam = run.cell.family
    inputs = fam.make(run.cfg, run.seed, run.device, run.rank, run.world)
    op = DistSpmv(fam.port_shard(run.cfg, inputs, run.rank, run.world), mesh)
    del inputs
    x = fam.operand(run.cfg, run.seed, run.device, run.rank, run.world)

    def call():
        return ct.spmv(op.padded_op, x)

    before = counters()
    call()  # the first call builds the kernel and joins the ring
    run.sync()
    route = moved(before, counters())
    for _ in range(2):
        call()
    run.sync()
    t0 = time.perf_counter()
    for _ in range(3):
        call()
    run.sync()
    run.log(f"[dist] rank {mesh.rank} of {mesh.size} ({mesh.backend}, {mesh.device}): interior "
            f"{op.interior}, overlap {op.overlap}, {op.calls} calls, {op.halo_bytes} halo bytes "
            f"sent")
    return State(call=call, t_call=(time.perf_counter() - t0) / 3, route=route, joined=joined)


def window(run, state: State, seconds: float) -> Window:
    proposed = run.agree("calls", max(1, int(seconds / state.t_call)))
    calls = min(proposed)
    run.log(f"[window] calls proposed {proposed}, each rank makes {calls}")
    chunk = max(1, round(IN_FLIGHT_S / state.t_call))
    keep = run.sample(calls) | {calls - 1}
    samples, pending = {}, collections.deque()
    before = counters()
    n = 0
    t0 = time.perf_counter()
    while n < calls:
        for _ in range(min(chunk, calls - n)):
            y = state.call()
            if n in keep:
                samples[n] = y
            n += 1
        pending.append(_event(run))
        if len(pending) > 2 and pending[0] is not None:
            pending.popleft().synchronize()
    run.sync()
    return Window(calls=n, elapsed_s=time.perf_counter() - t0, samples=samples,
                  launches=moved(before, counters()))


def end_to_end(run, w: Window) -> dict:
    return {"product_us": (w.elapsed_s / w.calls * 1e6, "us")}


def enqueue(run, state: State) -> list:
    return []  # no metric of this cell reads it


def probe(run, state: State) -> None:
    state.call()


def reading(run, state: State, w: Window, view) -> Reading:
    return Reading(view=view, calls=w.calls, dtype=run.cfg["dtype"],
                   counts=run.cell.family.counts(run.cfg, 1, run.rank, run.world),
                   counter_launches=sum(w.launches.values()))


def release(state: State) -> None:
    import torch.distributed as dist

    state.call = None
    gc.collect()  # the executor and its shard hold each other: free the card's rows now
    if state.joined and dist.is_initialized():
        dist.destroy_process_group()


def _reference(run):
    fam = run.cell.family
    args = (run.cfg, run.seed, run.device, run.rank, run.world)
    left, right = fam.halo(*args)
    return fam.Reference(run.cfg, fam.make(*args), left, right), fam.operand(*args)


def judge(run, w: Window) -> dict:
    """This rank's kept products against the reference over its rows, on
    the inputs made again."""
    ref, x = _reference(run)
    return {"y_err": _errors(ref, x, w.samples)}


def control(run) -> dict:
    """The reference in the precision below the configuration's, in the
    program's place, judged as :func:`judge` judges the program."""
    prec = control_precision(run.cfg)
    ref, x = _reference(run)
    return {"y_err": _errors(ref, x, {0: prec}, ("exact", prec))}
