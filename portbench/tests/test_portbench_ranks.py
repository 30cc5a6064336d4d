"""A cell of more than one chip: the merge of its ranks' lines into one, on
made-up results, and the launcher on the CPU, where gloo joins the ranks
of :mod:`portbench.tests.ring` and a rank stands in for its card."""

import copy
import json
import os
import re
import subprocess
import sys
import time

import pytest

from portbench import spec
from portbench.ranks import merge

BETTER = {"setup_s": "lower", "product_us": "lower", "kernel_roofline.product": "higher"}


def _rank(r, card=None, *, attempted=100, failed=(), product_us=10.0, roofline=90.0,
          peak=1000, y_err=1e-7, busy=0.9, built=()):
    return {"card": card or f"GPU-{r}", "failed_calls": list(failed), "line": {
        "correct": not failed, "attempted": attempted, "failed": len(failed),
        "metrics": {"setup_s": {"value": 5.0 + r, "unit": "s"},
                    "product_us": {"value": product_us, "unit": "us"},
                    "kernel_roofline.product": {"value": roofline, "unit": "%"}},
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1,
                   "memory_peak_bytes": peak, "busy_s": busy, "window_s": 1.0},
        "breakdown": {"device_ops": [[f"kernel{r}", busy]], "idle_gaps": []},
        "built": list(built), "checks": {"y_err": {"value": y_err, "limit": 5e-5}}}}


def test_count_is_the_distinct_cards():
    line = merge([_rank(r) for r in range(4)], 4, BETTER)
    assert line["device"]["count"] == 4
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                          "built", "checks"]
    assert list(line["device"]) == ["platform", "kind", "count", "memory_peak_bytes", "busy_s",
                                    "window_s"]
    assert line["correct"] is True and line["attempted"] == 100 and line["failed"] == 0


@pytest.mark.parametrize("cards", [["GPU-0"] * 4, ["GPU-0", "GPU-1", "GPU-1", "GPU-2"]])
def test_ranks_sharing_a_card_are_refused(cards):
    with pytest.raises(ValueError, match="distinct card"):
        merge([_rank(r, card) for r, card in enumerate(cards)], 4, BETTER)


def test_fewer_ranks_than_chips_are_refused():
    with pytest.raises(ValueError, match="distinct card"):
        merge([_rank(r) for r in range(2)], 4, BETTER)


@pytest.mark.parametrize("name, values, worst", [
    ("product_us", [10.0, 12.5, 11.0, 10.2], 12.5),  # lower is better: the largest
    ("kernel_roofline.product", [90.0, 85.5, 91.0, 88.0], 85.5),  # higher: the smallest
])
def test_worst_rank_by_better(name, values, worst):
    key = "product_us" if name == "product_us" else "roofline"
    line = merge([_rank(r, **{key: v}) for r, v in enumerate(values)], 4, BETTER)
    assert line["metrics"][name] == {"value": worst, "unit": "us" if key == "product_us" else "%"}
    assert line["metrics"]["setup_s"]["value"] == 8.0  # the slowest rank's set-up


def test_checks_max_failed_union_correct_needs_every_rank():
    ranks = [_rank(0, y_err=1e-7), _rank(1, y_err=3e-7, failed=[2, 99]),
             _rank(2, y_err=2e-7, failed=[99]), _rank(3, y_err=1e-7)]
    line = merge(ranks, 4, BETTER)
    assert line["checks"] == {"y_err": {"value": 3e-7, "limit": 5e-5}}
    assert line["failed"] == 2  # calls 2 and 99
    assert line["correct"] is False
    assert merge([_rank(r) for r in range(4)], 4, BETTER)["correct"] is True


def test_memory_peak_is_the_fullest_card():
    line = merge([_rank(r, peak=p) for r, p in enumerate([10, 40, 30, 20])], 4, BETTER)
    assert line["device"]["memory_peak_bytes"] == 40


def test_busy_and_breakdown_of_the_least_busy_rank_built_the_union():
    ranks = [_rank(r, busy=b, built=bl) for r, (b, bl) in
             enumerate([(0.9, ["a.so"]), (0.7, []), (0.8, ["b.so"]), (0.95, ["a.so"])])]
    line = merge(ranks, 4, BETTER)
    assert (line["device"]["busy_s"], line["device"]["window_s"]) == (0.7, 1.0)
    assert line["breakdown"]["device_ops"] == [["kernel1", 0.7]]
    assert line["built"] == ["a.so", "b.so"]


def test_unequal_attempted_is_refused():
    with pytest.raises(ValueError, match="different numbers of calls"):
        merge([_rank(r, attempted=100 + (r == 2)) for r in range(4)], 4, BETTER)


def test_untraced_line_has_no_busy_or_breakdown():
    ranks = [_rank(r) for r in range(2)]
    for r in ranks:
        del r["line"]["device"]["busy_s"], r["line"]["device"]["window_s"]
        del r["line"]["breakdown"]
    line = merge(copy.deepcopy(ranks), 2, BETTER)
    assert "breakdown" not in line and "busy_s" not in line["device"]


# -- the launcher, on the CPU ---------------------------------------------------


def ring(tmp_path, ranks, *args, timeout=240):
    """``python -m portbench.tests.ring`` on ``ranks`` CPU ranks; the
    completed process and its wall seconds."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    t0 = time.monotonic()
    out = subprocess.run([sys.executable, "-m", "portbench.tests.ring", "--dir", str(tmp_path),
                          "--ranks", str(ranks), "--device", "cpu", *args], cwd=spec.ROOT,
                         env=env, capture_output=True, text=True, timeout=timeout)
    return out, time.monotonic() - t0


def _ended(stderr):
    """Every rank the launcher started has ended."""
    pids = [int(p) for p in re.findall(r"started as pid (\d+)", stderr)]
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)
    return pids


@pytest.mark.parametrize("ranks", [2, 4])
def test_ranks_print_one_merged_line(tmp_path, ranks):
    out, _ = ring(tmp_path, ranks)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["correct"] is True and line["device"]["count"] == ranks
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "built",
                          "checks"]
    assert set(line["metrics"]) == {"setup_s", "product_us"}
    # agree gave every rank every rank's proposal, and each ran the least of them
    agreed = re.findall(r"\[rank (\d)\] agree calls (\[.*\])", out.stderr)
    assert sorted(int(r) for r, _ in agreed) == list(range(ranks))
    assert len({a for _, a in agreed}) == 1 and len(json.loads(agreed[0][1])) == ranks
    attempted = re.findall(r"\[rank \d\] card cpu:\d \(cpu\): attempted (\d+)", out.stderr)
    assert attempted == [str(line["attempted"])] * ranks
    assert line["attempted"] == min(json.loads(agreed[0][1]))
    assert len(_ended(out.stderr)) == ranks


def test_a_rank_with_a_wrong_answer_makes_the_line_not_correct(tmp_path):
    out, _ = ring(tmp_path, 2, "--fault", "wrong")
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout)
    assert line["correct"] is False and line["failed"] >= 1  # of the kept calls
    assert line["checks"]["y_err"]["value"] > line["checks"]["y_err"]["limit"]


def test_a_rank_that_raises_ends_the_run(tmp_path):
    out, _ = ring(tmp_path, 2, "--fault", "raise")
    assert out.returncode != 0 and out.stdout == ""
    assert "a fault planted in rank 1" in out.stderr and "rank 1 exited" in out.stderr
    assert len(_ended(out.stderr)) == 2


def test_a_rank_past_the_limit_is_killed(tmp_path):
    limit = 15
    out, seconds = ring(tmp_path, 2, "--fault", "sleep", "--limit", str(limit))
    assert out.returncode != 0 and out.stdout == ""
    assert "still running at the limit" in out.stderr
    assert seconds < limit + 10  # the driver's own start, the kill and the wait
    assert len(_ended(out.stderr)) == 2
