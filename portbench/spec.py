"""Find a cell's parts by name, from ``BENCHMARK.json``.

Each configuration, traffic mix, per-layer metric and set of limits is a
file of its own, so that a later cell is added by adding files:

- ``BENCHMARK.json``'s ``configs[].file``: the configuration's sizes, with a
  ``family`` that names ``portbench/families/<family>.py`` (how the matrix
  is made from the seed, its frozen counts and its plain reference);
- ``portbench/traffic/<traffic>.json``: the mix's parameters, with an
  ``entry`` that names ``portbench/entries/<entry>.py`` (the loop that drives
  the port's public entry, and its comparison);
- ``portbench/metrics/<metric>.py``: a per-layer metric's reader;
- ``portbench/limits/<workload>.json``: each compared number's limit.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import re
from pathlib import Path
from typing import Optional

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent
_IDENT = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict  # the configuration file's contents
    traffic: dict  # the traffic file's contents
    family: object  # portbench.families.<family>
    entry: object  # portbench.entries.<entry>
    end_to_end: list  # BENCHMARK.json metric entries this cell reports
    per_layer: list
    limits: dict  # {number: {"limit": ...}}


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _module(kind: str, name: str):
    if not _IDENT.fullmatch(name):
        raise ValueError(f"{kind} name {name!r} is not a Python identifier")
    return importlib.import_module(f"portbench.{kind}.{name}")


def metric_reader(name: str):
    """The ``read`` function of ``portbench/metrics/<name>.py``."""
    path = PACKAGE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + re.sub(r"\W", "_", name), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _listed(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def cell(workload: str, bench: Optional[dict] = None, root: Path = ROOT) -> Cell:
    """The parts of ``workload``; raises KeyError for a name the file lacks."""
    bench = bench if bench is not None else load_benchmark(root)
    wl = {w["name"]: w for w in bench["workloads"]}[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    with open(root / cfg_entry["file"]) as f:
        config = json.load(f)
    with open(PACKAGE / "traffic" / f"{wl['traffic']}.json") as f:
        traffic = json.load(f)
    limits_path = PACKAGE / "limits" / f"{workload}.json"
    with open(limits_path) as f:
        limits = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _listed(m, workload)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return Cell(name=workload, config=config, traffic=traffic,
                family=_module("families", config["family"]),
                entry=_module("entries", traffic["entry"]),
                end_to_end=e2e, per_layer=per_layer, limits=limits)
