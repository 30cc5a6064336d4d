"""The readers of the port's spans and plan counters, on a trace laid out by
hand: the card's idle gaps and the host's spans placed so that each
reader's microseconds are known."""

import importlib

import pytest

from portbench import spec
from portbench.entries import Reading
from portbench.spans import idle_under, overlap_us, union
from portbench.tracing import TraceView

# the window [0, 100] µs; the card runs [10, 30], [40, 60], [70, 90]: idle
# [0, 10], [30, 40], [60, 70], [90, 100]
DEVICE = [{"name": "k", "ts": a, "dur": b - a} for a, b in ((10, 30), (40, 60), (70, 90))]


def _span(name, a, b, cat="user_annotation"):
    return {"name": name, "cat": cat, "ts": a, "dur": b - a}


HOST = [
    _span("cg.stop_test", 25, 45),  # idle under it: [30, 40]
    _span("cg.product", 55, 65),  # [60, 65]
    _span("cg.update", 0, 5), _span("cg.update", 2, 4),  # [0, 5], nested counted once
    _span("cg.update", 95, 100),  # [95, 100]
    _span("cg.product", 0, 100, cat="cpu_op"),  # an op of that name is no span
]
IDLE_US = {"cg.stop_test": 10.0, "cg.product": 5.0, "cg.update": 10.0}
ITERATIONS = 5


def _reading(device=DEVICE, host=HOST):
    view = TraceView(lo=0.0, hi=100.0, device_ops=device, host_ops=host, probe_names=set())
    return Reading(view=view, calls=1, counts={}, dtype="float64", iterations=ITERATIONS)


@pytest.mark.parametrize("span", sorted(IDLE_US))
def test_idle_reader_gives_the_known_us(span):
    read = spec.metric_reader(f"{span}_idle_us_per_iter")
    assert read(_reading()) == pytest.approx(IDLE_US[span] / ITERATIONS)
    assert idle_under(_reading().view, span) == pytest.approx(IDLE_US[span])


@pytest.mark.parametrize("span", sorted(IDLE_US))
def test_idle_reader_is_silent_without_its_span_or_device_ops(span):
    read = spec.metric_reader(f"{span}_idle_us_per_iter")
    assert read(_reading(host=[e for e in HOST if e["name"] != span])) is None
    assert read(_reading(device=[])) is None


def test_union_and_overlap():
    assert union([(5, 7), (0, 2), (1, 3), (7, 8)]) == [(0, 3), (5, 8)]
    assert overlap_us([(0, 10), (20, 30)], [(5, 25)]) == 10
    assert overlap_us([(0, 1)], []) == 0


def test_plan_build_s(monkeypatch):
    spmv_mod = importlib.import_module("cask_tpu_torch.ops.spmv")
    read = spec.metric_reader("plan.build_s")
    cache = spmv_mod.PlanCache()
    monkeypatch.setattr(spmv_mod, "default_plan_cache", cache)
    assert read(_reading()) is None  # no plan built
    cache.build_s["slab"] += 0.5
    cache.build_s["scalar_dia"] += 64.0
    assert read(_reading()) == pytest.approx(64.5)
    monkeypatch.setattr(spmv_mod, "default_plan_cache", object())  # a cache with no counter
    assert read(_reading()) is None
