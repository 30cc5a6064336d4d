"""A cell of more than one chip: one process a card, joined as a user's
``torchrun`` job joins them, and one result line for all.

:func:`run` starts ``chips`` rank processes (``python -m portbench.ranks``,
a fresh interpreter each, as the ``spawn`` start method gives; each leads
its own process group, so that whatever it starts is ended with it).  Rank
*r* runs :func:`portbench.harness.measure` on ``cuda:r`` with the
environment ``torchrun`` gives (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``OMP_NUM_THREADS``),
so the program joins its own process group unchanged.  The harness keeps
out of that group: the ranks meet in a ``FileStore`` of their own for the
barrier before each window, :meth:`StoreGroup.agree` and their results.
The parent joins the ranks within the set-up allowance, the window and the
comparison; a rank that fails or outlives that ends every rank, and no
line is printed.  :func:`merge` makes the one line.
"""

from __future__ import annotations

import ctypes
import datetime
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Callable, Optional

SETUP_ALLOWANCE_S = 900.0  # a checkout's first run compiles the port's kernels
COMPARE_ALLOWANCE_S = 240.0  # the comparison with the plain reference
POLL_S = 0.1


class StoreGroup:
    """The harness's coordination of ``world`` ranks through a store that
    the program never sees: what :class:`portbench.harness.Solo` is on one
    card.  Every rank makes the same calls in the same order."""

    def __init__(self, path: str, rank: int, world: int, timeout_s: float):
        import torch.distributed as dist

        self.store = dist.FileStore(path, -1)  # -1: the file outlives the ranks
        self.store.set_timeout(datetime.timedelta(seconds=timeout_s))
        self.rank, self.world = rank, world
        self._calls = 0

    def _key(self, name: str) -> str:
        self._calls += 1
        return f"{self._calls}.{name}"

    def barrier(self, name: str) -> None:
        key = self._key(name)
        if self.store.add(key, 1) == self.world:
            self.store.set(f"{key}.open", "1")
        self.store.wait([f"{key}.open"])

    def agree(self, name: str, value) -> list:
        key = self._key(name)
        self.store.set(f"{key}.{self.rank}", json.dumps(value))
        keys = [f"{key}.{r}" for r in range(self.world)]
        self.store.wait(keys)
        return [json.loads(self.store.get(k)) for k in keys]


# -- the merge ----------------------------------------------------------------


def merge(results: list, chips: int, better: dict) -> dict:
    """One result line from the ranks' ``{"line", "failed_calls", "card"}``,
    in rank order.  ``better`` maps each metric's name to ``lower`` or
    ``higher``.  Raises ValueError where the ranks ran on fewer distinct
    cards than ``chips`` or completed different numbers of calls."""
    lines = [r["line"] for r in results]
    cards = {r["card"] for r in results}
    if len(results) != chips or len(cards) < chips:
        raise ValueError(f"the cell asks for {chips} cards; its {len(results)} ranks ran on "
                         f"{len(cards)} distinct card(s): {sorted(cards)}")
    attempted = [line["attempted"] for line in lines]
    if len(set(attempted)) != 1:
        raise ValueError(f"the ranks completed different numbers of calls: {attempted}")
    failed = set().union(*(r["failed_calls"] for r in results))
    metrics = {}
    for name in dict.fromkeys(n for line in lines for n in line["metrics"]):
        read = [line["metrics"][name] for line in lines if name in line["metrics"]]
        worst = max if better[name] == "lower" else min  # the slowest card sets the pace
        metrics[name] = {"value": worst(m["value"] for m in read), "unit": read[0]["unit"]}
    device = dict(lines[0]["device"], count=len(cards),
                  memory_peak_bytes=max(line["device"]["memory_peak_bytes"] for line in lines))
    out = {"correct": all(line["correct"] for line in lines) and not failed,
           "attempted": attempted[0], "failed": len(failed), "metrics": metrics,
           "device": device}
    if "busy_s" in device:
        idlest = min(lines, key=lambda line: line["device"]["busy_s"] / line["device"]["window_s"])
        device.update(busy_s=idlest["device"]["busy_s"], window_s=idlest["device"]["window_s"])
        if "breakdown" in idlest:
            out["breakdown"] = idlest["breakdown"]
    out["built"] = sorted(set().union(*(line["built"] for line in lines)))
    checks = {}
    for name in dict.fromkeys(n for line in lines for n in line["checks"]):
        read = [line["checks"][name] for line in lines if name in line["checks"]]
        if len({c["limit"] for c in read}) != 1:
            raise ValueError(f"the ranks hold {name} to different limits: {read}")
        checks[name] = {"value": max(c["value"] for c in read), "limit": read[0]["limit"]}
    out["checks"] = checks
    return out


# -- the parent ---------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _join(procs: list, deadline: float, limit_s: float) -> Optional[str]:
    """None once every rank has exited with 0; else what went wrong."""
    while True:
        codes = [p.poll() for p in procs]
        for r, code in enumerate(codes):
            if code not in (None, 0):
                return f"rank {r} exited with code {code}"
        if all(code == 0 for code in codes):
            return None
        if time.monotonic() >= deadline:
            late = [r for r, code in enumerate(codes) if code is None]
            return f"rank(s) {late} still running at the limit of {limit_s:.0f} s"
        time.sleep(POLL_S)


def _end(procs: list) -> None:
    """Kill each rank's process group (the rank and whatever it started) and
    wait for each rank."""
    for p in procs:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            pass
    for p in procs:
        p.wait()


def run(workload: str, seed: int, seconds: float, trace: bool, *, chips: int, t_start: float,
        bench: dict, marks: dict, log: Callable[[str], None], device: str = "cuda",
        cells: str = "portbench.spec:cell", limit_s: Optional[float] = None) -> Optional[dict]:
    """Run ``workload`` on ``chips`` ranks and return the merged line, or
    None (with the cause logged) where a rank failed, outlived ``limit_s``
    (by default the set-up allowance, ``seconds`` and the comparison's), or
    the merge refused the ranks' results."""
    limit_s = limit_s or SETUP_ALLOWANCE_S + seconds + COMPARE_ALLOWANCE_S
    tmp = tempfile.mkdtemp(prefix="portbench-ranks-")
    procs = []
    old_term = signal.signal(signal.SIGTERM, lambda *_: sys.exit(128 + signal.SIGTERM))
    try:
        job = {"workload": workload, "seed": seed, "seconds": seconds, "trace": trace,
               "t_start": t_start, "bench": bench, "marks": marks, "device": device,
               "cells": cells, "store": os.path.join(tmp, "store"), "limit_s": limit_s,
               "parent": os.getpid()}
        with open(os.path.join(tmp, "job.json"), "w") as f:
            json.dump(job, f)
        port = str(_free_port())
        for r in range(chips):
            env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(chips),
                       LOCAL_WORLD_SIZE=str(chips), MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
            env.setdefault("OMP_NUM_THREADS", "1")  # as torchrun sets it for several ranks
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "portbench.ranks", os.path.join(tmp, "job.json"), str(r)],
                env=env, stdout=2, start_new_session=True))  # a rank's prints go to stderr
            log(f"[ranks] rank {r} of {chips} started as pid {procs[-1].pid} on {device}"
                f"{f':{r}' if device == 'cuda' else ''}")
        failure = _join(procs, time.monotonic() + limit_s, limit_s)
        if failure:
            log(f"[ranks] {failure}; every rank is ended and no result is printed")
            return None
        import torch.distributed as dist

        store = dist.FileStore(job["store"], -1)
        results = [json.loads(store.get(f"result.{r}")) for r in range(chips)]
        for r, res in enumerate(results):
            line = res["line"]
            log(f"[rank {r}] card {res['card']} ({line['device']['kind']}): attempted "
                f"{line['attempted']}, failed calls {res['failed_calls']}, correct "
                f"{line['correct']}, memory_peak_bytes {line['device']['memory_peak_bytes']}, "
                f"metrics { {n: m['value'] for n, m in line['metrics'].items()} }, checks "
                f"{ {n: c['value'] for n, c in line['checks'].items()} }")
        try:
            return merge(results, chips, {m["name"]: m["better"]
                                          for m in bench["end_to_end"] + bench["per_layer"]})
        except ValueError as e:
            log(f"[ranks] {e}; no result is printed")
            return None
    finally:
        _end(procs)
        signal.signal(signal.SIGTERM, old_term)
        shutil.rmtree(tmp, ignore_errors=True)


# -- a rank -------------------------------------------------------------------


def _end_with_parent(parent: int) -> None:
    """Have the kernel kill this rank when the parent dies (Linux)."""
    try:
        ctypes.CDLL(None).prctl(1, int(signal.SIGKILL))  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass
    if os.getppid() != parent:
        os._exit(1)


def _rank_main(job_path: str, rank: int) -> int:
    t_rank = time.perf_counter()
    with open(job_path) as f:
        job = json.load(f)
    _end_with_parent(job["parent"])

    def log(line: str) -> None:
        os.write(2, f"[rank {rank}] {line}\n".encode())  # one write: ranks share stderr

    try:
        import torch

        marks = dict(job["marks"], rank=t_rank, **{"rank.torch": time.perf_counter()})
        from portbench import harness

        device = torch.device(job["device"])
        if device.type == "cuda":
            device = torch.device("cuda", rank)
            torch.cuda.set_device(device)
            torch.cuda.init()
            marks["rank.cuda"] = time.perf_counter()
        import cask_tpu_torch  # noqa: F401

        marks["rank.port"] = time.perf_counter()
        world = int(os.environ["WORLD_SIZE"])
        group = StoreGroup(job["store"], rank, world, job["limit_s"])
        out = harness.measure(job["workload"], job["seed"], job["seconds"], job["trace"],
                              t_start=job["t_start"], device=device, log=log,
                              bench=job["bench"], marks=marks, cells=job["cells"], group=group)
        found = harness.forbidden_modules()
        if found:
            raise RuntimeError(f"JAX or the JAX package is loaded in rank {rank}: {found}")
        group.store.set(f"result.{rank}", json.dumps(
            {"line": out.line, "failed_calls": out.failed_calls, "card": out.card}))
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
        return 0
    except Exception:  # the rank's boundary: its traceback, then the parent ends the others
        log(traceback.format_exc())
        return 1


if __name__ == "__main__":
    sys.exit(_rank_main(sys.argv[1], int(sys.argv[2])))
