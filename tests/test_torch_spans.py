"""The port's spans and the plan cache's counters, on the CPU.

``cg`` marks its phases with :func:`cask_tpu_torch.utils.profiling.annotate`:
with no profiler running it opens no ``record_function`` range at all, and
under ``trace()`` it writes one ``cg.solve`` span a solve and one
``cg.stop_test``, ``cg.product`` and ``cg.update`` span an iteration, with
the same ``x`` to the bit.  :class:`cask_tpu_torch.ops.spmv.PlanCache` counts
its builds, their host seconds and its hits; a scalar-DIA build spans its
three steps inside ``plan.build.scalar_dia``.
"""

import collections
import glob
import importlib
import json
import os

import numpy as np
import pytest
import torch

import cask_tpu_torch as ct
import cask_tpu_torch.formats.convert as tconv
import cask_tpu_torch.formats.generate as tgen
from cask_tpu_torch.ops.spmm import spmm
from cask_tpu_torch.ops.spmv import PlanCache
from cask_tpu_torch.solvers import cg
from cask_tpu_torch.utils.profiling import annotate, trace

spmv_mod = importlib.import_module("cask_tpu_torch.ops.spmv")
CG_SPANS = ("cg.solve", "cg.start", "cg.stop_test", "cg.product", "cg.update")


def _system(side=16):
    a = tgen.stencil_2d(side)
    b = torch.from_numpy(np.random.default_rng(7).standard_normal(a.shape[0]))
    return a, b


def _user_events(logdir) -> list:
    (path,) = glob.glob(os.path.join(logdir, "*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


def _spans(logdir) -> collections.Counter:
    return collections.Counter(e["name"] for e in _user_events(logdir))


def test_cg_opens_no_range_without_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    a, b = _system()
    res = cg(a, b, tol=1e-8, maxiter=500)
    assert res.converged and res.iterations > 0


@pytest.mark.parametrize("tol,maxiter,stopped_by_tol", [(1e-8, 500, True), (0.0, 7, False)])
def test_cg_spans_under_trace(tmp_path, tol, maxiter, stopped_by_tol):
    a, b = _system()
    with trace(str(tmp_path)):
        res = cg(a, b, tol=tol, maxiter=maxiter)
    assert res.converged == stopped_by_tol and (res.iterations < maxiter) == stopped_by_tol
    spans = _spans(tmp_path)
    k = res.iterations
    assert {n: spans[n] for n in CG_SPANS} == {
        "cg.solve": 1, "cg.start": 1, "cg.stop_test": k + int(stopped_by_tol),
        "cg.product": k, "cg.update": k}


def test_cg_x_is_bitwise_the_same_traced(tmp_path):
    a, b = _system()
    off = cg(a, b, tol=1e-10, maxiter=500)
    with trace(str(tmp_path)):
        on = cg(a, b, tol=1e-10, maxiter=500)
    assert torch.equal(on.x, off.x)
    assert (on.iterations, on.residual_norm, on.converged) == \
        (off.iterations, off.residual_norm, off.converged)


def test_annotate_as_a_decorator_reads_the_flag_on_each_call(tmp_path):
    @annotate("decorated")
    def f(v):
        return v + 1

    assert f(1) == 2  # decorated, and called, with no profiler running
    with trace(str(tmp_path)):
        f(2)
        f(3)
    assert _spans(tmp_path)["decorated"] == 2


def test_plan_cache_counts_builds_and_hits(monkeypatch):
    cache = PlanCache()
    monkeypatch.setattr(spmv_mod, "default_plan_cache", cache)
    bsr = tconv.csr_to_bsr(tgen.fem_blocks(8, dof=4), (4, 4))
    p = ct.bdia_plan(bsr, device="cpu")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((bsr.shape[1], 8)))
    y = spmm(p, x)
    assert dict(cache.builds) == {"scalar_dia": 1} and cache.hits == 0
    for _ in range(3):
        torch.testing.assert_close(spmm(p, x), y, rtol=0, atol=0)
    assert dict(cache.builds) == {"scalar_dia": 1} and cache.hits == 3
    p.vals.mul_(2)  # in place: the cached plan is stale
    torch.testing.assert_close(spmm(p, x), 2 * y)
    assert dict(cache.builds) == {"scalar_dia": 2} and cache.hits == 3
    assert set(cache.build_s) == {"scalar_dia"} and cache.build_s["scalar_dia"] > 0


def _intervals(logdir, names) -> dict:
    found = collections.defaultdict(list)
    for e in _user_events(logdir):
        if e["name"] in names:
            found[e["name"]].append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    return found


@pytest.mark.parametrize("blocksize", [(4, 4), (4, 2)])
def test_scalar_dia_build_spans_its_steps(tmp_path, monkeypatch, blocksize):
    # a first spmm on a BDIA plan builds its scalar-DIA plan under one
    # plan.build.scalar_dia span holding one span of each step; the next
    # call hits the cache and opens none
    cache = PlanCache()
    monkeypatch.setattr(spmv_mod, "default_plan_cache", cache)
    bsr = tconv.csr_to_bsr(tgen.fem_blocks(8, dof=4), blocksize)
    p = ct.bdia_plan(bsr, device="cpu")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((bsr.shape[1], 8)))
    steps = ("plan.scalar_dia.count", "plan.scalar_dia.fill", "plan.scalar_dia.remainder")
    with trace(str(tmp_path)):
        spmm(p, x)
        spmm(p, x)
    found = _intervals(tmp_path, ("plan.build.scalar_dia",) + steps)
    assert {k: len(v) for k, v in found.items()} == \
        {k: 1 for k in ("plan.build.scalar_dia",) + steps}
    ((b0, b1),) = found["plan.build.scalar_dia"]
    within = [found[s][0] for s in steps]
    assert all(b0 <= t0 <= t1 <= b1 for t0, t1 in within)
    assert within[0][1] <= within[1][0] and within[1][1] <= within[2][0]  # in order
    assert dict(cache.builds) == {"scalar_dia": 1} and cache.hits == 1
