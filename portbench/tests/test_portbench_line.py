"""The result line's keys, on the CPU at the configurations' small sizes,
and the command line's refusals."""

import json
import os
import subprocess
import sys

import pytest

from portbench import spec
from portbench.tests.tiny import CELLS, run_tiny, tiny_bench

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("workload", CELLS)
def test_line_keys(tmp_path, workload):
    bench = tiny_bench(tmp_path)
    r = run_tiny(bench, workload)
    assert list(r) == KEYS + ["built", "checks"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {m["name"] for m in spec.cell(workload, bench).end_to_end}
    assert all(set(v) == {"value", "unit"} and v["value"] > 0 for v in r["metrics"].values())
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())
    json.dumps(r)


@pytest.mark.parametrize("workload", ["hpcg-512.cg", "fem-dof4-419m.spmv"])
def test_traced_line_keys(tmp_path, workload):
    r = run_tiny(tiny_bench(tmp_path), workload, trace=True)
    assert list(r) == KEYS + ["breakdown", "built", "checks"]
    assert {"busy_s", "window_s"} <= set(r["device"]) and r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in r["breakdown"].values())


def _command(cwd, *args):
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, whatever the machine holds
    return subprocess.run([sys.executable, "-m", "portbench.run", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    out = _command(spec.ROOT, "--workload", CELLS[0], "--seed", str(2 ** 31 + 5),
                   "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_unknown_workload_no_result():
    out = _command(spec.ROOT, "--workload", "no-such.cell", "--seed", "1", "--seconds", "1")
    assert out.returncode != 0 and out.stdout == ""
