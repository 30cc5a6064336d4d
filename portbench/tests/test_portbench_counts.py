"""The frozen byte and flop counts against the numbers the cells were
defined with."""

import json

import pytest

from portbench import spec
from portbench.yardstick import HBM_BYTES_PER_S, bound_seconds


def _config(name):
    entry = {c["name"]: c for c in spec.load_benchmark()["configs"]}[name]
    return json.loads((spec.ROOT / entry["file"]).read_text())


@pytest.mark.parametrize("name, k, entries, mbytes, bound_us", [
    ("hpcg-512", 1, 3_609_741_304, 31025.4, 9261.3),
    ("fem-dof4-419m", 1, 8_387_952_640, 36907.3, 11017.1),
    ("fem-dof4-10m", 128, 204_697_600, 11304.6, 3374.5),
])
def test_frozen_counts(name, k, entries, mbytes, bound_us):
    cfg = _config(name)
    fam = spec._module("families", cfg["family"])
    counts = fam.counts(cfg, k)
    assert counts["entries"] == entries == cfg["entries"]
    assert fam.shape(cfg)[0] == cfg["rows"]
    assert round(counts["bytes"] / 1e6, 1) == mbytes
    assert counts["flops"] == 2 * entries * k
    # bytes bound both: the flops over the peak take less time
    assert bound_seconds(counts, cfg["dtype"]) == counts["bytes"] / HBM_BYTES_PER_S
    assert round(bound_seconds(counts, cfg["dtype"]) * 1e6, 1) == bound_us


def test_hpcg_values_are_the_papers():
    cfg = _config("hpcg-512")
    assert (cfg["nx"], cfg["ny"], cfg["nz"], cfg["center"], cfg["neighbor"]) == \
        (512, 512, 512, 26.0, -1.0)
    # 27 full diagonals of f64, no remainder: 29.0 GB
    assert 27 * cfg["rows"] * 8 == 28_991_029_248
