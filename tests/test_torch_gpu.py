"""The port's CUDA kernel on the card, against its plain PyTorch twin.

Every test here needs a CUDA device and skips without one.  This file
imports neither JAX nor the JAX package, so it also runs on a GPU machine
that has no JAX, without the suite's conftest (which configures JAX):

    python -m pytest tests/test_torch_gpu.py --noconftest -q

Tolerances: f64 ≤ 1e-12 normwise (the same products in the same pair
order as the twin), f32 ≤ 1e-5.
"""

import importlib

import numpy as np
import pytest
import torch

import cask_tpu_torch as ct
from cask_tpu_torch.formats.convert import coo_from_arrays, csr_to_bsr, from_scipy, to_scipy
from cask_tpu_torch.formats.generate import _diag_shift, banded, fem_blocks, stencil_2d
from cask_tpu_torch.ops.kernels.bdia_kernels import bdia_spmv, bdia_spmv_reference
from cask_tpu_torch.ops.spmv import PlanCache
from cask_tpu_torch.tune import timing

# the module itself: ``cask_tpu_torch.ops.spmv`` as an attribute is the function
spmv_mod = importlib.import_module("cask_tpu_torch.ops.spmv")
pytestmark = pytest.mark.gpu
TOL = {np.float32: 1e-5, np.float64: 1e-12}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _relerr(y, ref) -> float:
    y, ref = y.double().cpu(), ref.double().cpu()
    return float((y - ref).norm() / ref.norm())


def _remainder_matrix(dtype):
    """fem_blocks(6, dof=4) plus scattered 4×4 blocks that spill to the COO
    remainder."""
    s = to_scipy(fem_blocks(6, dof=4)).tolil()
    rng = np.random.default_rng(16)
    for _ in range(6):
        bi, bj = int(rng.integers(0, 20)), int(rng.integers(0, 20))
        s[bi * 4 : bi * 4 + 4, bj * 4 : bj * 4 + 4] = rng.standard_normal((4, 4))
    return csr_to_bsr(from_scipy(s.tocsr().astype(dtype)), (4, 4))


CASES = {
    "fem2": lambda dt: fem_blocks(7, dof=2, dtype=dt, return_bsr=True),
    "fem4": lambda dt: fem_blocks(7, dof=4, dtype=dt, return_bsr=True),
    "fem8": lambda dt: fem_blocks(7, dof=8, dtype=dt, return_bsr=True),
    "fem3_br3": lambda dt: fem_blocks(9, dof=3, dtype=dt, return_bsr=True),  # ragged rows
    "fem16": lambda dt: fem_blocks(4, dof=16, dtype=dt, return_bsr=True),  # br > 8
    "remainder": _remainder_matrix,
    "rect4x2": lambda dt: csr_to_bsr(fem_blocks(6, dof=4, dtype=dt), (4, 2)),
    "band_as_blocks": lambda dt: csr_to_bsr(banded(257, 3, seed=5, dtype=dt), (4, 4)),
    "ragged": lambda dt: csr_to_bsr(stencil_2d(11, dtype=dt), (4, 4)),
}


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_kernel_matches_twin(cuda, name, dtype):
    bsr = CASES[name](dtype)
    p = ct.bdia_plan(bsr, device=cuda)
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(p.shape[1])
                         .astype(dtype)).to(cuda)
    before = bdia_spmv.launches
    y = p.spmv(x)
    torch.cuda.synchronize()
    assert bdia_spmv.launches == before + 1
    assert _relerr(y, p._spmv_reference(x)) <= TOL[dtype]
    y_sp = to_scipy(bsr).astype(np.float64) @ x.cpu().double().numpy()
    assert _relerr(y, torch.from_numpy(y_sp)) <= 10 * TOL[dtype]


def test_kernel_raises_on_what_it_does_not_take(cuda):
    p = ct.bdia_plan(CASES["fem4"](np.float64), device=cuda)
    with pytest.raises(TypeError):  # f64 plan, f32 x
        bdia_spmv(p, torch.zeros(p.shape[1], dtype=torch.float32, device=cuda))
    with pytest.raises(ValueError):
        bdia_spmv(p, torch.zeros(p.shape[1] + 1, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):  # CPU x, CUDA plan
        bdia_spmv(p, torch.zeros(p.shape[1], dtype=torch.float64))
    with pytest.raises(ValueError):  # not contiguous
        bdia_spmv(p, torch.zeros(2 * p.shape[1], dtype=torch.float64, device=cuda)[::2])
    with pytest.raises(TypeError):
        bdia_spmv(p.astype(torch.bfloat16),
                  torch.zeros(p.shape[1], dtype=torch.bfloat16, device=cuda))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_auto_route_launches_the_kernel(cuda, dtype, monkeypatch):
    a = CASES["fem4"](dtype).to(cuda)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(a.shape[1])
                         .astype(dtype)).to(cuda)
    plans = PlanCache()
    monkeypatch.setattr(spmv_mod, "default_plan_cache", plans)
    before = bdia_spmv.launches
    y = ct.spmv(a, x)
    y2 = ct.spmv(a, x)
    torch.cuda.synchronize()
    assert bdia_spmv.launches == before + 2 and len(plans._plans) == 1
    assert torch.equal(y, y2)
    assert _relerr(y, ct.spmv(a, x, method="xla")) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_auto_route_sees_values_changed_in_place(cuda, dtype):
    a = CASES["fem4"](dtype).to(cuda)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(a.shape[1])
                         .astype(dtype)).to(cuda)
    ct.spmv(a, x)  # plans and caches the matrix
    a.data.mul_(2.0)
    before = bdia_spmv.launches
    y = ct.spmv(a, x)
    assert bdia_spmv.launches == before + 1
    assert _relerr(y, ct.spmv(a, x, method="xla")) <= TOL[dtype]
    a.data.copy_(torch.flip(a.data, (0,)))
    assert _relerr(ct.spmv(a, x), ct.spmv(a, x, method="xla")) <= TOL[dtype]


def test_auto_route_gate_takes_the_gather_formulation(cuda, monkeypatch):
    # remainder > 10 % of the stored entries: the reference's own route
    rng = np.random.default_rng(4)
    n = 2048
    rows = np.concatenate([np.arange(n), rng.integers(0, n, 4000)])
    cols = np.concatenate([np.arange(n), rng.integers(0, n, 4000)])
    s = ct.coo_to_csr(coo_from_arrays(rng.standard_normal(rows.size), rows, cols, (n, n)))
    a = ct.csr_to_bsr(s, (2, 2)).to(cuda)
    x = torch.from_numpy(rng.standard_normal(n)).to(cuda)
    plans = PlanCache()
    monkeypatch.setattr(spmv_mod, "default_plan_cache", plans)
    before = bdia_spmv.launches
    y = ct.spmv(a, x)
    assert bdia_spmv.launches == before and len(plans._plans) == 1
    assert _relerr(y, torch.from_numpy(to_scipy(s) @ x.cpu().numpy())) <= TOL[np.float64]


def test_kernel_writes_every_row(cuda):
    # y comes from torch.empty: a row the kernel missed would hold stale bytes
    p = ct.bdia_plan(CASES["ragged"](np.float64), device=cuda)
    x = torch.zeros(p.shape[1], dtype=torch.float64, device=cuda)
    assert torch.count_nonzero(bdia_spmv(p, x)) == 0
    assert bdia_spmv_reference(p, x).shape == (p.shape[0],)


def test_cg_on_card_matches_cpu(cuda):
    a = to_scipy(fem_blocks(12, dof=4))
    st = csr_to_bsr(_diag_shift(from_scipy((a + a.T).tocsr()), 1.1), (4, 4))
    b = np.random.default_rng(6).standard_normal(st.shape[0])
    op = ct.BdiaOperator(ct.bdia_plan(st, device=cuda))
    assert op.mode == "kernel"
    res = ct.solvers.cg(op, torch.from_numpy(b).to(cuda), tol=1e-10)
    ref = ct.solvers.cg(ct.BdiaOperator(ct.bdia_plan(st)), torch.from_numpy(b), tol=1e-10)
    assert res.converged and abs(res.iterations - ref.iterations) <= 1
    assert _relerr(res.x, ref.x) <= 1e-9


def test_time_cuda(cuda):
    x = torch.ones(1 << 20, device=cuda)
    t = timing.time_cuda(lambda: x.mul_(1.0), warmup=1, runs=3, reps=2)
    assert t.ms > 0 and len(t.samples_ms) == 3 and t.reps == 2
