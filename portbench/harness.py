"""One run of one cell: set-up, the measured (or traced) window, then the
comparison with the plain reference.  :func:`run_cell` returns the result
line; ``portbench/run.py`` is its command line and adds the checks that
need the card.  A cell of more than one chip runs :func:`measure` on each
of its ranks (``portbench/ranks.py``), which merges their lines into one.
"""

from __future__ import annotations

import dataclasses
import importlib
import os
import pkgutil
import random
import sys
import time
from typing import Callable, Optional

import torch

from portbench import spec, tracing
from portbench.yardstick import sub_seed

TRACE_SECONDS = 3.0  # the longest traced window: its trace is read in this process
FORBIDDEN = ("jax", "jaxlib", "flax", "cask_tpu")


class Solo:
    """The coordination of a run on one card: one rank, no one to wait for.
    ``portbench.ranks.StoreGroup`` is its counterpart across ranks."""

    rank, world = 0, 1

    def agree(self, name: str, value) -> list:
        return [value]

    def barrier(self, name: str) -> None:
        pass


@dataclasses.dataclass
class Run:
    cell: spec.Cell
    seed: int
    device: torch.device
    log: Callable[[str], None]
    group: object = dataclasses.field(default_factory=Solo)  # the harness's, not the program's

    @property
    def rank(self) -> int:
        return self.group.rank

    @property
    def world(self) -> int:
        return self.group.world

    def agree(self, name: str, value) -> list:
        """Every rank's ``value`` under ``name``, in rank order.  A collective
        product needs the same number of calls on every rank, so a
        distributed entry fixes its window's call count with this first."""
        return self.group.agree(name, value)

    @property
    def cfg(self) -> dict:
        return self.cell.config

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg["dtype"])

    def make(self) -> dict:
        """The matrix, made from the seed on the device."""
        return self.cell.family.make(self.cfg, self.seed, self.device)

    def operand(self, k: Optional[int]) -> torch.Tensor:
        """Standard normal draws from the seed: x (n,), or X (n, k)."""
        n = self.cell.family.shape(self.cfg)[1]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(sub_seed(self.seed, 2))
        return torch.randn((n,) if k is None else (n, k), generator=gen, device=self.device,
                           dtype=self.dtype)

    def sample(self, expected: int) -> set:
        """Two call indices drawn from the seed among the first half of the
        calls a window is expected to make; the window also keeps its last."""
        rng = random.Random(sub_seed(self.seed, 3))
        return {rng.randrange(max(expected // 2, 1)) for _ in range(2)}

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def counters() -> dict:
    """Every kernel wrapper's launch counter in the port's ``ops.kernels``."""
    pkg = importlib.import_module("cask_tpu_torch.ops.kernels")
    out = {}
    for info in pkgutil.iter_modules(pkg.__path__):
        mod = importlib.import_module(f"{pkg.__name__}.{info.name}")
        for name, fn in vars(mod).items():
            if callable(fn) and isinstance(getattr(fn, "launches", None), int):
                out[name] = fn.launches
    return out


def moved(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}


def built_libraries() -> set:
    """The kernel libraries in the port's build directory (the one the
    command line fixes inside the checkout)."""
    path = os.environ.get("CASK_TPU_TORCH_BUILD_DIR")
    if not path or not os.path.isdir(path):
        return set()
    return {f for f in os.listdir(path) if f.endswith(".so")}


def card_id(device: torch.device, rank: int) -> str:
    """The card a rank ran on: its UUID; on the CPU the rank stands in for it."""
    if device.type == "cuda":
        return str(torch.cuda.get_device_properties(device).uuid)
    return f"{device.type}:{rank}"


def find(ref: str):
    """The function a ``module:function`` reference names."""
    module, _, name = ref.partition(":")
    return getattr(importlib.import_module(module), name)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


@dataclasses.dataclass
class Outcome:
    line: dict  # the result line
    failed_calls: list  # the call indices whose outputs failed a limit
    card: str  # card_id of the card the run used


def run_cell(workload: str, seed: int, seconds: float, trace: bool, **kw) -> dict:
    """Run ``workload`` once on one card; return the result line as a dict
    (its ``checks`` last).  Takes :func:`measure`'s keywords."""
    return measure(workload, seed, seconds, trace, **kw).line


def measure(workload: str, seed: int, seconds: float, trace: bool, *, t_start: float,
            device=None, log=None, bench: Optional[dict] = None,
            marks: Optional[dict] = None, cells: str = "portbench.spec:cell",
            group=None) -> Outcome:
    """Run ``workload`` once on ``device``.  ``t_start`` is the run's start
    on ``time.perf_counter``'s clock (the host's monotonic clock, which every
    process shares); ``marks`` names earlier steps of the set-up by the time
    each ended, on the same clock.  ``cells`` names the function that finds
    the cell's parts; ``group`` is a rank's coordination with the others
    (:class:`Solo` when None).  ``built`` lists the kernel libraries this run
    compiled: a checkout's first run of a cell builds, and its set-up is not
    a warm one."""
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    device = torch.device(device or "cuda")
    cell = find(cells)(workload, bench)
    run = Run(cell=cell, seed=int(seed), device=device, log=log, group=group or Solo())
    entry = cell.entry
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    libraries = built_libraries()
    t_cell = time.perf_counter()
    state = entry.setup(run)
    t_end = time.perf_counter()
    setup_s = t_end - t_start
    built = sorted(built_libraries() - libraries)
    steps, t = [], t_start
    for name, at in list((marks or {}).items()) + [("cell", t_cell), ("setup", t_end)]:
        steps.append(f"{name} {at - t:.3f}")
        t = at
    log(f"[setup] {setup_s:.3f} s: {', '.join(steps)} s (up to each step from the one "
        f"before; setup: inputs, plans, warm-up); built {built or 'nothing'}; "
        f"route: {state.route}")
    result = {"correct": False, "attempted": 0, "failed": 0, "metrics": {}}
    if not trace:
        run.group.barrier("window")
        window = entry.window(run, state, seconds)
        metrics = entry.end_to_end(run, window)
        metrics["setup_s"] = (setup_s, "s")
        wanted = {m["name"]: m["unit"] for m in cell.end_to_end}
    else:
        enqueue_us = entry.enqueue(run, state)
        run.group.barrier("window")
        window, view = tracing.traced(lambda: entry.window(run, state, min(seconds, TRACE_SECONDS)),
                                      lambda: entry.probe(run, state))
        reading = entry.reading(run, state, window, view)
        reading.enqueue_us = enqueue_us
        named = sum(1 for e in view.device_ops if e["name"] in view.probe_names)
        log(f"[trace] one product launches {sorted(view.probe_names)}; the window: "
            f"{len(view.device_ops)} device operations, {named} of those kernels, the route's "
            f"launch counters {reading.counter_launches}; {window.calls} calls")
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(reading)
            if value is not None:
                metrics[m["name"]] = (value, m["unit"])
        wanted = {m["name"]: m["unit"] for m in cell.per_layer if m["name"] in metrics}
        result["breakdown"] = view.breakdown()
    missing = set(wanted) - set(metrics)
    if missing:
        raise RuntimeError(f"{workload}: the {cell.traffic['entry']} entry gives no {missing}")
    result["metrics"] = {n: {"value": float(metrics[n][0]), "unit": u} for n, u in wanted.items()}
    result["attempted"] = window.calls
    card = card_id(device, run.rank)
    result["device"] = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": len({card}),  # the cards read, here the one; ranks.merge counts theirs
        "memory_peak_bytes": torch.cuda.max_memory_allocated(device)
        if device.type == "cuda" else 0,
    }
    if trace:
        result["device"]["busy_s"] = view.busy_us * 1e-6
        result["device"]["window_s"] = view.window_us * 1e-6
    entry.release(state)
    del state
    numbers = entry.judge(run, window)  # {number: {call index: value}}
    limit = {n: float(cell.limits[n]["limit"]) for n in numbers}
    checks = {n: {"value": float(max(v.values())), "limit": limit[n]} for n, v in numbers.items()}
    failed = {i for n, v in numbers.items() for i, x in v.items() if not x <= limit[n]}
    result["correct"] = not failed
    result["failed"] = len(failed)
    if "breakdown" in result:
        result["breakdown"] = result.pop("breakdown")
    result["built"] = built
    result["checks"] = checks
    return Outcome(line=result, failed_calls=sorted(failed), card=card)
