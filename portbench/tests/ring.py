"""A cell of the tests alone, for the launcher of ``portbench/ranks.py``: a
tridiagonal product in plain PyTorch, its rows split over the ranks, each
call exchanging one halo row with the ring neighbours (gloo on the CPU,
NCCL on cards) as a distributed entry of the port does.  It is its own
entry and family; :func:`cell` finds its parts.

    python -m portbench.tests.ring --dir <tmp> --ranks 2 --device cpu [--fault raise|sleep|wrong]

runs it through the launcher and prints what ``portbench/run.py`` prints.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

from portbench import spec
from portbench.entries import Reading, Window
from portbench.yardstick import sub_seed

ROWS = 256  # a rank's rows
LIMIT = 1e-5  # y_err of a float32 product of three terms against float64
WORKLOAD = "ring.dist{ranks}"
CELLS = "portbench.tests.ring:cell"


def bench(directory: Path, ranks: int, fault: str | None = None) -> dict:
    """A benchmark of the one cell ``ring.dist<ranks>``; ``fault`` plants
    ``raise`` (rank 1 raises in its set-up), ``sleep`` (rank 1 sleeps in its
    window) or ``wrong`` (rank 1 alters one answer of each call)."""
    path = Path(directory) / "ring.json"
    path.write_text(json.dumps({"name": "ring", "dtype": "float32", "rows": ROWS,
                                "fault": fault}))
    name = WORKLOAD.format(ranks=ranks)
    return {
        "configs": [{"name": "ring", "file": str(path), "reduced": []}],
        "workloads": [{"name": name, "config": "ring", "traffic": "ring", "chips": ranks}],
        "end_to_end": [
            {"name": "setup_s", "unit": "s", "better": "lower"},
            {"name": "product_us", "unit": "us", "better": "lower"}],
        "per_layer": [{"name": "idle_share.product", "unit": "%", "better": "lower",
                       "moves": "product_us"}],
    }


def cell(workload: str, bench: dict) -> spec.Cell:
    """The cell's parts: this module is its entry."""
    wl = {w["name"]: w for w in bench["workloads"]}[workload]
    cfg_file = {c["name"]: c for c in bench["configs"]}[wl["config"]]["file"]
    return spec.Cell(name=workload, config=json.loads(Path(cfg_file).read_text()),
                     traffic={"entry": "ring"}, family=None,
                     entry=importlib.import_module(CELLS.split(":")[0]),
                     end_to_end=bench["end_to_end"], per_layer=bench["per_layer"],
                     limits={"y_err": {"limit": LIMIT}})


def _inputs(run):
    """The whole matrix's three diagonals and x, from the seed, on the CPU;
    the terms that reach past the first and the last row are zero."""
    n = run.cfg["rows"] * run.world
    gen = torch.Generator().manual_seed(sub_seed(run.seed, 1))
    diags = torch.randn(3, n, generator=gen, dtype=torch.float64)
    diags[0, 0] = diags[2, -1] = 0
    return diags, torch.randn(n, generator=gen, dtype=torch.float64)


def _fault(run, where: str) -> None:
    kind = run.cfg["fault"]
    if run.rank == 1 and kind == "raise" and where == "setup":
        raise RuntimeError("a fault planted in rank 1")
    if run.rank == 1 and kind == "sleep" and where == "window":
        time.sleep(3600)


@dataclasses.dataclass
class State:
    call: object
    t_call: float
    route: dict


def setup(run) -> State:
    dist.init_process_group("nccl" if run.device.type == "cuda" else "gloo",
                            init_method="env://")  # the environment torchrun gives
    assert (dist.get_rank(), dist.get_world_size()) == (run.rank, run.world)
    _fault(run, "setup")
    rows, dtype = run.cfg["rows"], getattr(torch, run.cfg["dtype"])
    diags, x = _inputs(run)
    mine = slice(run.rank * rows, (run.rank + 1) * rows)
    a = diags[:, mine].to(run.device, dtype)
    x = x[mine].to(run.device, dtype)
    left, right = (run.rank - 1) % run.world, (run.rank + 1) % run.world
    wrong = run.rank == 1 and run.cfg["fault"] == "wrong"

    def call():
        lo, hi = torch.empty_like(x[:1]), torch.empty_like(x[:1])
        # NCCL pairs a peer's sends and receives in order, gloo by tag: both agree
        ops = [dist.P2POp(dist.isend, x[:1], left, tag=1),
               dist.P2POp(dist.isend, x[-1:], right, tag=2),
               dist.P2POp(dist.irecv, hi, right, tag=1),
               dist.P2POp(dist.irecv, lo, left, tag=2)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        xp = torch.cat([lo, x, hi])
        y = a[0] * xp[:-2] + a[1] * xp[1:-1] + a[2] * xp[2:]
        if wrong:
            y[rows // 2] += 1
        return y

    call()
    run.sync()
    t0 = time.perf_counter()
    for _ in range(3):
        call()
    run.sync()
    return State(call=call, t_call=(time.perf_counter() - t0) / 3, route={})


def window(run, state: State, seconds: float) -> Window:
    proposed = run.agree("calls", max(1, int(seconds / state.t_call)))
    run.log(f"agree calls {proposed}")
    calls = min(proposed)
    _fault(run, "window")
    t0 = time.perf_counter()
    samples = {}
    for i in range(calls):
        y = state.call()
        if i in (0, calls - 1):
            samples[i] = y
    run.sync()
    return Window(calls=calls, elapsed_s=time.perf_counter() - t0, samples=samples)


def end_to_end(run, w: Window) -> dict:
    return {"product_us": (w.elapsed_s / w.calls * 1e6, "us")}


def enqueue(run, state: State) -> list:
    return []


def probe(run, state: State) -> None:
    state.call()


def reading(run, state: State, w: Window, view) -> Reading:
    return Reading(view=view, calls=w.calls, counts={}, dtype=run.cfg["dtype"])


def release(state: State) -> None:
    state.call = None


def judge(run, w: Window) -> dict:
    """Each kept output's rows against the float64 product of the whole
    matrix: the largest ``|y − ŷ| / (|A| @ |x|)``."""
    diags, x = _inputs(run)
    xp = torch.nn.functional.pad(x, (1, 1))
    exact = diags[0] * xp[:-2] + diags[1] * xp[1:-1] + diags[2] * xp[2:]
    scale = diags[0].abs() * xp[:-2].abs() + diags[1].abs() * xp[1:-1].abs() \
        + diags[2].abs() * xp[2:].abs()
    rows = run.cfg["rows"]
    mine = slice(run.rank * rows, (run.rank + 1) * rows)
    return {"y_err": {i: float(((y.double().cpu() - exact[mine]).abs() / scale[mine]).max())
                      for i, y in w.samples.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", required=True)
    ap.add_argument("--ranks", type=int, required=True)
    ap.add_argument("--device", choices=("cpu", "cuda"), required=True)
    ap.add_argument("--fault", choices=("raise", "sleep", "wrong"))
    ap.add_argument("--seed", type=int, default=2 ** 31 + 17)
    ap.add_argument("--seconds", type=float, default=0.5)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--limit", type=float, help="seconds the ranks are given (CPU only)")
    args = ap.parse_args(argv)
    from portbench import ranks, run

    b = bench(Path(args.dir), args.ranks, args.fault)
    workload = WORKLOAD.format(ranks=args.ranks)
    common = ["--workload", workload, "--seed", str(args.seed), "--seconds", str(args.seconds),
              "--trace", str(args.trace)]
    if args.device == "cuda":  # the command line itself, its refusals with it
        return run.main(common, bench=b, cells=CELLS)
    result = ranks.run(workload, args.seed, args.seconds, bool(args.trace), chips=args.ranks,
                       t_start=time.perf_counter(), bench=b, marks={}, log=run._log,
                       device="cpu", cells=CELLS, limit_s=args.limit)
    return 1 if result is None else run.emit(result)


if __name__ == "__main__":
    sys.exit(main())
