"""The four-chip cell ``fem-dof4-1677m.dist4`` on the CPU: its frozen
counts, its rank-local matrix and reference against a dense product of
the whole matrix, its readers on a trace laid out by hand, and the cell
itself at its small size on worlds of 2 and 4 gloo ranks through the
launcher (``portbench/ranks.py``), with a planted fault."""

import json
import time

import pytest
import torch

from portbench import ranks, spec
from portbench.entries import Reading
from portbench.families import fem_bdia, fem_bdia_rows
from portbench.tests import dist_fault
from portbench.tests.test_portbench_reference import _dense_fem
from portbench.tests.tiny import tiny_bench
from portbench.tracing import TraceView
from portbench.yardstick import bound_seconds

WORKLOAD = "fem-dof4-1677m.dist4"
NEW = ("kernel_roofline.dist", "dist.exchange_exposed_us_per_call", "dist.fixup_us_per_call",
       "dist.shard_build_s")
DEVICE_TRACE = NEW[:3]


def _config():
    return spec.cell(WORKLOAD).config


def test_frozen_counts():
    cfg = _config()
    world = cfg["ranks"]
    assert fem_bdia_rows.shape(cfg, world)[0] == cfg["rows"] == 1_677_721_600
    per_rank = [fem_bdia_rows.counts(cfg, 1, r, world) for r in range(world)]
    assert sum(c["entries"] for c in per_rank) == cfg["entries"] == 33_552_793_600
    # an inner rank: fem-dof4-419m's share with both ± ny couplings whole, plus the halo
    inner = per_rank[1]
    assert inner["entries"] == 8_388_280_320
    assert inner["bytes"] == inner["entries"] * 4 + (2 * 419_430_400 + 2 * 40_960) * 4
    assert round(bound_seconds(inner, "float32") * 1e6, 1) == 11017.6
    # a world of one is fem_bdia's matrix on an nx_rank x ny grid
    one = dict(cfg, nx=cfg["nx_rank"])
    assert fem_bdia_rows.counts(cfg, 1, 0, 1) == fem_bdia.counts(one, 1)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_ranks_rows_and_reference_against_the_dense_matrix(world):
    cfg = dict(_config(), nx_rank=5, ny=4, ts=8)
    seed = 2 ** 33 + 7
    parts = [fem_bdia_rows.make(cfg, seed, "cpu", r, world) for r in range(world)]
    nbloc = cfg["nx_rank"] * cfg["ny"]
    # the ranks' rows laid end to end are fem_bdia's layout of the whole grid
    whole = torch.cat([p["vals"].permute(1, 3, 4, 0, 2).reshape(-1, 4, 20)[:nbloc]
                       for p in parts])
    tiles = -(-whole.shape[0] // 1024)
    padded = torch.zeros((tiles * 1024, 4, 20))
    padded[:whole.shape[0]] = whole
    vals = padded.reshape(tiles, 8, 128, 4, 20).permute(3, 0, 4, 1, 2)
    dense = _dense_fem({"vals": vals, "ts": 8, "offsets": parts[0]["offsets"]},
                       cfg["nx_rank"] * world, cfg["ny"], 4)
    assert int((dense != 0).sum()) == sum(fem_bdia_rows.counts(cfg, 1, r, world)["entries"]
                                          for r in range(world))
    assert sum(int((p["vals"] != 0).sum()) for p in parts) == int((dense != 0).sum())
    x = torch.cat([fem_bdia_rows.operand(cfg, seed, "cpu", r, world) for r in range(world)])
    want = dense @ x.double()
    for r in range(world):
        left, right = fem_bdia_rows.halo(cfg, seed, "cpu", r, world)
        ref = fem_bdia_rows.Reference(cfg, parts[r], left, right, block_rows=1024)
        mine = slice(r * nbloc * 4, (r + 1) * nbloc * 4)
        got = torch.cat([ys["exact"] for _, _, ys, _ in ref.blocks(x[mine], ("exact",))])
        torch.testing.assert_close(got[:, 0], want[mine], rtol=1e-13, atol=1e-12)


# -- the readers, on a trace laid out by hand -----------------------------------

# the window [0, 100] µs: the interior [10, 60]; NCCL [5, 20] and [55, 70]
# (exposed [5, 10] and [60, 70]); the fix-ups [70, 80] and [80, 82], launched
# inside the dist.fixup span [62, 90]; a copy [85, 95] launched outside it
OPS = [("bdia_spmv_kernel", 10, 60, 1), ("ncclDevKernel_SendRecv", 5, 20, 2),
       ("ncclDevKernel_SendRecv", 55, 70, 3), ("mul", 70, 80, 4), ("add", 80, 82, 5),
       ("Memcpy DtoD", 85, 95, 6)]
DEVICE = [{"name": n, "ts": a, "dur": b - a, "args": {"correlation": c}} for n, a, b, c in OPS]
HOST = [{"name": "dist.fixup", "cat": "user_annotation", "ts": 62, "dur": 28},
        {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 63, "dur": 1,
         "args": {"correlation": 4}},
        {"name": "cudaLaunchKernel", "cat": "cuda_runtime", "ts": 66, "dur": 1,
         "args": {"correlation": 5}},
        {"name": "cudaMemcpyAsync", "cat": "cuda_runtime", "ts": 91, "dur": 1,
         "args": {"correlation": 6}}]
COUNTS = {"entries": 1000, "bytes": 335_000_000, "flops": 2000}  # 100 µs at 3.35 TB/s


def _reading(device=DEVICE, host=HOST, calls=2):
    view = TraceView(lo=0.0, hi=100.0, device_ops=device, host_ops=host, probe_names=set())
    return Reading(view=view, calls=calls, counts=COUNTS, dtype="float32")


def test_readers_give_the_known_numbers():
    read = {n: spec.metric_reader(n) for n in DEVICE_TRACE}
    assert read["dist.exchange_exposed_us_per_call"](_reading()) == pytest.approx(15 / 2)
    assert read["dist.fixup_us_per_call"](_reading()) == pytest.approx(12 / 2)
    busy = 5 + 50 + 10 + 10 + 2 + 10  # [5, 82] and [85, 95]
    assert busy == 87
    assert read["kernel_roofline.dist"](_reading()) == pytest.approx(100 / (busy / 2) * 100)


def test_readers_are_silent_without_what_they_read():
    for name in DEVICE_TRACE:
        assert spec.metric_reader(name)(_reading(device=[])) is None
    assert spec.metric_reader("dist.fixup_us_per_call")(
        _reading(host=[e for e in HOST if e["name"] != "dist.fixup"])) is None
    # no NCCL kernel (a world of one): nothing of the exchange is exposed
    alone = [e for e in DEVICE if "nccl" not in e["name"]]
    assert spec.metric_reader("dist.exchange_exposed_us_per_call")(_reading(device=alone)) == 0


def test_shard_build_reader(monkeypatch):
    from cask_tpu_torch import interop

    read = spec.metric_reader("dist.shard_build_s")
    monkeypatch.setattr(interop.bdia_shard_from_arrays, "builds", 0)
    assert read(_reading()) is None
    monkeypatch.setattr(interop.bdia_shard_from_arrays, "builds", 1)
    monkeypatch.setattr(interop.bdia_shard_from_arrays, "build_s", 0.25)
    assert read(_reading()) == 0.25
    monkeypatch.delattr(interop, "bdia_shard_from_arrays")  # a port without the shard
    assert read(_reading()) is None


# -- the cell on gloo ranks -----------------------------------------------------


def _run(tmp_path, monkeypatch, world, trace, cells="portbench.spec:cell"):
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "")
    monkeypatch.chdir(spec.ROOT)
    bench = tiny_bench(tmp_path)
    logged = []
    line = ranks.run(WORKLOAD, 2 ** 31 + 23, 0.3, trace, chips=world,
                     t_start=time.perf_counter(), bench=bench, marks={}, log=logged.append,
                     device="cpu", cells=cells, limit_s=600)
    return line, bench, logged


@pytest.mark.parametrize("world", [2, 4])
def test_cell_on_gloo_ranks(tmp_path, monkeypatch, world):
    line, bench, logged = _run(tmp_path, monkeypatch, world, trace=True)
    assert line is not None, logged
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert line["device"]["count"] == world
    # a CPU trace holds no device operation: the device-trace readers stay silent,
    # the host's counter is read (on cards: portbench/tests/test_portbench_card_dist.py)
    assert set(line["metrics"]) == {"dist.shard_build_s"}
    assert 0 < line["metrics"]["dist.shard_build_s"]["value"] < 5
    assert line["checks"]["y_err"]["value"] < line["checks"]["y_err"]["limit"]
    json.dumps(line)


def test_skipped_fixups_fail_the_limit(tmp_path, monkeypatch):
    line, bench, logged = _run(tmp_path, monkeypatch, 2, trace=False, cells=dist_fault.CELLS)
    assert line is not None, logged
    assert line["correct"] is False and line["failed"] > 0
    assert line["checks"]["y_err"]["value"] > 100 * line["checks"]["y_err"]["limit"]
    assert set(line["metrics"]) == {"setup_s", "product_us"}
