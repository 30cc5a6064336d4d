"""Helpers of the benchmark's own tests: each configuration at the small
size its file names under ``tiny``, run on the CPU (the port's plain twins)
or on a card."""

from __future__ import annotations

import copy
import json
import time

from portbench import harness, spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def tiny_bench(tmp_path) -> dict:
    """``BENCHMARK.json`` with each configuration file replaced by its ``tiny``
    size, written under ``tmp_path``."""
    bench = copy.deepcopy(BENCH)
    for c in bench["configs"]:
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        cfg.update(cfg["tiny"])
        path = tmp_path / f"{c['name']}.json"
        path.write_text(json.dumps(cfg))
        c["file"] = str(path)
    return bench


def run_tiny(bench, workload, *, trace=False, seed=2 ** 31 + 99, seconds=0.2,
             device="cpu") -> dict:
    return harness.run_cell(workload, seed, seconds, trace, t_start=time.perf_counter(),
                            device=device, bench=bench, log=lambda s: None)
