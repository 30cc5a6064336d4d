"""A run with the timed path broken underneath comes out not correct: each
fault a cell can have, planted in the port's public entry that the window
drives.  (One chip: no exchange between chips to leave out.)"""

import pytest
import torch

import cask_tpu_torch
import cask_tpu_torch.solvers
from portbench.tests.tiny import CELLS, run_tiny, tiny_bench

PRODUCTS = [w for w in CELLS if not w.endswith(".cg")]
SOLVES = [w for w in CELLS if w.endswith(".cg")]


def _altered(y):
    y = y.clone()
    y.view(-1)[y.numel() // 3] += 1e-3 * y.abs().max()
    return y


PRODUCT_FAULTS = {
    "altered": _altered,  # one answer altered where it is produced
    "unchanged": torch.zeros_like,  # the output left as a fresh buffer holds it
    "half_batch": lambda y: torch.cat([y[..., : (y.shape[-1] + 1) // 2],
                                       torch.zeros_like(y[..., (y.shape[-1] + 1) // 2:])], -1)
    if y.ndim == 2 else torch.cat([y[: y.shape[0] // 2], torch.zeros_like(y[y.shape[0] // 2:])]),
}


@pytest.mark.parametrize("fault", sorted(PRODUCT_FAULTS))
@pytest.mark.parametrize("workload", PRODUCTS)
def test_product_fault(tmp_path, monkeypatch, workload, fault):
    broken = PRODUCT_FAULTS[fault]
    for name in ("spmv", "spmm"):
        good = getattr(cask_tpu_torch, name)
        monkeypatch.setattr(cask_tpu_torch, name,
                            lambda a, x, _good=good, **kw: broken(_good(a, x, **kw)))
    r = run_tiny(tiny_bench(tmp_path), workload)
    assert r["correct"] is False and r["failed"] > 0


def _stale_step(a, b, **kw):
    """The last iteration returns its state unchanged: maxiter − 1 steps made,
    maxiter reported."""
    res = _cg(a, b, **{**kw, "maxiter": kw["maxiter"] - 1})
    res.iterations += 1
    return res


def _altered_x(a, b, **kw):
    res = _cg(a, b, **kw)
    res.x = _altered(res.x)
    return res


def _short(a, b, **kw):
    return _cg(a, b, **{**kw, "maxiter": kw["maxiter"] - 1})


_cg = cask_tpu_torch.solvers.cg


@pytest.mark.parametrize("fault", [_stale_step, _altered_x, _short], ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", SOLVES)
def test_solve_fault(tmp_path, monkeypatch, workload, fault):
    monkeypatch.setattr(cask_tpu_torch.solvers, "cg", fault)
    r = run_tiny(tiny_bench(tmp_path), workload)
    assert r["correct"] is False and r["failed"] > 0
