"""The port's CUDA kernels on the card, against their plain PyTorch twins.

Kernels: BDIA SpMV, DIA SpMV and SpMM, and the wide-k block SpMM kernels
(slab in both frames, BDIA ring, ELL-packed BSR).

Every test here needs a CUDA device and skips without one.  This file
imports neither JAX nor the JAX package, so it also runs on a GPU machine
that has no JAX, without the suite's conftest (which configures JAX):

    python -m pytest tests/test_torch_gpu.py --noconftest -q

Tolerances: f64 ≤ 1e-12 normwise (the same products in the same pair or
diagonal order as the twin), f32 ≤ 1e-5.
"""

import importlib

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cask_tpu_torch as ct
from cask_tpu_torch.formats.convert import coo_from_arrays, csr_to_bsr, from_scipy, to_scipy
from cask_tpu_torch.formats.generate import _diag_shift, banded, fem_blocks, stencil_2d
from cask_tpu_torch.ops.bdia_slab import bdia_slab_plan, slab_auto_plan
from cask_tpu_torch.ops.bsr_spmm import BsrSpmmKernel
from cask_tpu_torch.ops.kernels.bdia_kernels import (MAX_PAIRS, bdia_spmm_ring,
                                                     bdia_spmm_ring_reference, bdia_spmv,
                                                     bdia_spmv_reference)
from cask_tpu_torch.ops.kernels.bdia_slab_kernels import (bdia_spmm_slab,
                                                          bdia_spmm_slab_padded,
                                                          bdia_spmm_slab_reference)
from cask_tpu_torch.ops.kernels.bsr_kernels import bsr_spmm, bsr_spmm_reference
from cask_tpu_torch.ops.kernels.dia_kernels import dia_spmm, dia_spmm_reference, dia_spmv
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
    ref = ct.solvers.cg(ct.BdiaOperator(ct.bdia_plan(st, device="cpu")), torch.from_numpy(b),
                        tol=1e-10)
    assert res.converged and abs(res.iterations - ref.iterations) <= 1
    assert _relerr(res.x, ref.x) <= 1e-9


def test_time_cuda(cuda):
    x = torch.ones(1 << 20, device=cuda)
    t = timing.time_cuda(lambda: x.mul_(1.0), warmup=1, runs=3, reps=2)
    assert t.ms > 0 and len(t.samples_ms) == 3 and t.reps == 2


# -- DIA kernels -------------------------------------------------------------


def _diags(m, n, offsets, seed):
    rng = np.random.default_rng(seed)
    lens = [min(m, n - k) if k >= 0 else min(m + k, n) for k in offsets]
    return sp.diags([rng.standard_normal(ln) for ln in lens], offsets, shape=(m, n)).tocsr()


def _dia_remainder():
    """A dense band, a thin far band below the density floor and scattered
    entries: a plan with a COO remainder."""
    s = to_scipy(banded(3000, 2, seed=1)) + to_scipy(banded(3000, 12, density=0.05, seed=3))
    rng = np.random.default_rng(4)
    r, c = rng.integers(0, 3000, 20), rng.integers(0, 3000, 20)
    return s + sp.csr_matrix((rng.standard_normal(20), (r, c)), shape=s.shape)


DIA_CASES = {  # scipy f64; row counts ragged against the 256-thread blocks
    "stencil": lambda: to_scipy(stencil_2d(33)),
    "banded": lambda: to_scipy(banded(3001, 3, seed=2)),
    "remainder": _dia_remainder,
    "asym_up": lambda: _diags(2000, 2000, [1, 3, 7], 7),
    "asym_down": lambda: _diags(2000, 2000, [-5, -2, 0], 8),
    "rect_tall": lambda: _diags(3000, 1200, [-1500, -2, 0, 1, 700], 9),
    "rect_wide": lambda: _diags(1200, 3000, [-700, -1, 0, 2, 1500], 10),
}


def _dia(name, dtype, device):
    s = DIA_CASES[name]().tocsr().astype(dtype)
    return s, ct.dia_plan(from_scipy(s), device=device)


@pytest.mark.parametrize("name", list(DIA_CASES))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dia_spmv_matches_twin(cuda, name, dtype):
    s, p = _dia(name, dtype, cuda)
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(s.shape[1])
                         .astype(dtype)).to(cuda)
    before = dia_spmv.launches
    y = p.spmv(x)
    torch.cuda.synchronize()
    assert dia_spmv.launches == before + 1
    assert _relerr(y, p._spmv_reference(x)) <= TOL[dtype]
    assert _relerr(y, torch.from_numpy(s.astype(np.float64) @ x.cpu().double().numpy())) \
        <= TOL[dtype]


@pytest.mark.parametrize("name", list(DIA_CASES))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [1, 3, 20, 32, 64, 100, 128])
def test_dia_spmm_matches_twin(cuda, name, dtype, k):
    s, p = _dia(name, dtype, cuda)
    x = torch.from_numpy(np.random.default_rng(11).standard_normal((s.shape[1], k))
                         .astype(dtype)).to(cuda)
    before = dia_spmm.launches
    y = p.spmm(x)
    torch.cuda.synchronize()
    assert dia_spmm.launches == before + 1 and y.shape == (s.shape[0], k)
    assert _relerr(y, p._spmm_reference(x)) <= TOL[dtype]
    assert _relerr(y, torch.from_numpy(s.astype(np.float64) @ x.cpu().double().numpy())) \
        <= TOL[dtype]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_dia_spmm_unaligned_x_takes_scalar_loads(cuda, dtype):
    # X whose rows start off the 16-byte grid: the kernel's scalar path
    s, p = _dia("banded", dtype, cuda)
    k = 32
    buf = torch.from_numpy(np.random.default_rng(12).standard_normal(s.shape[1] * k + 1)
                           .astype(dtype)).to(cuda)
    x = buf[1:].view(s.shape[1], k)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    assert _relerr(dia_spmm(p, x), dia_spmm_reference(p, x)) <= TOL[dtype]


def test_dia_kernels_write_every_row(cuda):
    # y comes from torch.empty: a row the kernel missed would hold stale bytes
    _, p = _dia("rect_tall", np.float64, cuda)
    x = torch.zeros(p.shape[1], dtype=torch.float64, device=cuda)
    assert torch.count_nonzero(dia_spmv(p, x)) == 0
    assert torch.count_nonzero(dia_spmm(p, x[:, None].repeat(1, 5))) == 0


def test_dia_kernels_raise_on_what_they_do_not_take(cuda):
    _, p = _dia("banded", np.float64, cuda)
    n = p.shape[1]
    with pytest.raises(TypeError):  # f64 plan, f32 x
        dia_spmv(p, torch.zeros(n, dtype=torch.float32, device=cuda))
    with pytest.raises(ValueError):
        dia_spmv(p, torch.zeros(n + 1, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):  # CPU x, CUDA plan
        dia_spmv(p, torch.zeros(n, dtype=torch.float64))
    with pytest.raises(ValueError):  # not contiguous
        dia_spmm(p, torch.zeros((n, 4), dtype=torch.float64, device=cuda).T.contiguous().T)
    with pytest.raises(ValueError):  # 1-D x to the SpMM kernel
        dia_spmm(p, torch.zeros(n, dtype=torch.float64, device=cuda))
    with pytest.raises(TypeError):
        dia_spmv(p.astype(torch.bfloat16), torch.zeros(n, dtype=torch.bfloat16, device=cuda))


def test_dia_transposed_tall_plan(cuda):
    s = _diags(20000, 5000, [0, -1], 11)
    p = ct.transposed(ct.dia_plan(from_scipy(s), device=cuda))
    x = torch.from_numpy(np.random.default_rng(13).standard_normal(20000)).to(cuda)
    assert _relerr(p.spmv(x), torch.from_numpy(s.T @ x.cpu().numpy())) <= TOL[np.float64]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_csr_auto_routes_launch_the_dia_kernels(cuda, dtype, monkeypatch):
    s = to_scipy(stencil_2d(40)).astype(dtype)
    a = from_scipy(s).to(cuda)
    plans = PlanCache()
    monkeypatch.setattr(spmv_mod, "default_plan_cache", plans)
    x = torch.from_numpy(np.random.default_rng(14).standard_normal((s.shape[1], 32))
                         .astype(dtype)).to(cuda)
    v, m = dia_spmv.launches, dia_spmm.launches
    y = ct.spmv(a, x[:, 0])
    Y = ct.spmm(a, x)
    torch.cuda.synchronize()
    assert (dia_spmv.launches, dia_spmm.launches) == (v + 1, m + 1)
    assert len(plans._plans) == 1  # one plan serves both ops
    assert _relerr(y, ct.spmv(a, x[:, 0], method="xla")) <= TOL[dtype]
    assert _relerr(Y, ct.spmm(a, x, method="xla")) <= TOL[dtype]
    # values changed in place: the next call plans anew
    a.data.mul_(2.0)
    assert _relerr(ct.spmv(a, x[:, 0]), 2.0 * y) <= TOL[dtype]
    assert _relerr(ct.spmm(a, x), 2.0 * Y) <= TOL[dtype]
    assert (dia_spmv.launches, dia_spmm.launches) == (v + 2, m + 2)


def test_csr_auto_route_gate_takes_the_gather_formulation(cuda, monkeypatch):
    plans = PlanCache()
    monkeypatch.setattr(spmv_mod, "default_plan_cache", plans)
    a = ct.generate.power_law(2000, seed=3).to(cuda)  # no diagonal structure
    x = torch.from_numpy(np.random.default_rng(15).standard_normal(2000)).to(cuda)
    before = dia_spmv.launches
    y = ct.spmv(a, x)
    assert dia_spmv.launches == before and len(plans._plans) == 1
    assert _relerr(y, torch.from_numpy(to_scipy(a) @ x.cpu().numpy())) <= TOL[np.float64]


@pytest.mark.parametrize("k", [8, 100])
def test_bsr_spmm_auto_route_launches_the_dia_kernel(cuda, k):
    # scalar DIA at k ≤ 64; above it the slab kernel (the wide-k chain)
    a = CASES["fem4"](np.float32).to(cuda)
    x = torch.from_numpy(np.random.default_rng(16).standard_normal((a.shape[1], k))
                         .astype(np.float32)).to(cuda)
    before = (dia_spmm.launches, bdia_spmm_slab.launches)
    y = ct.spmm(a, x)
    torch.cuda.synchronize()
    assert (dia_spmm.launches, bdia_spmm_slab.launches) == \
        ((before[0] + 1, before[1]) if k <= 64 else (before[0], before[1] + 1))
    assert _relerr(y, ct.spmm(a, x, method="xla")) <= TOL[np.float32]


def test_solver_operator_cg_on_card_matches_cpu(cuda):
    s = (sp.identity(1600) + to_scipy(stencil_2d(40))).tocsr()
    b = np.random.default_rng(17).standard_normal(1600)
    op = ct.solver_operator(from_scipy(s), device=cuda)
    assert op.mode == "kernel"
    res = ct.solvers.cg(op, torch.from_numpy(b).to(cuda), tol=1e-10)
    ref = ct.solvers.cg(ct.solver_operator(from_scipy(s), device="cpu"), torch.from_numpy(b),
                        tol=1e-10)
    assert res.converged and abs(res.iterations - ref.iterations) <= 1
    assert _relerr(res.x, ref.x) <= 1e-9



# -- wide-k block SpMM kernels: slab, BDIA ring, BSR ---------------------------


def _blocks_on(nb, b, offsets, seed):
    """Random b×b blocks on the given block offsets, as scipy f64."""
    rng = np.random.default_rng(seed)
    s = sp.lil_matrix((nb * b, nb * b))
    for i in range(nb):
        for d in offsets:
            if 0 <= i + d < nb:
                s[i * b : (i + 1) * b, (i + d) * b : (i + d + 1) * b] = rng.standard_normal((b, b))
    return s.tocsr()


EIGHT_FAR = (-70, -49, -33, -17, -1, 0, 1, 17, 33, 49, 70)  # W = 584 at g = 16

WIDE_CASES = {  # name -> (dtype -> BSR); ragged, rectangular, remainder, far offsets
    "fem4": lambda dt: fem_blocks(16, dof=4, dtype=dt, return_bsr=True),
    "fem2": lambda dt: fem_blocks(16, dof=2, dtype=dt, return_bsr=True),
    "fem3_ragged": lambda dt: fem_blocks(11, dof=3, dtype=dt, return_bsr=True),
    "remainder": _remainder_matrix,
    "rect_blocks4x2": lambda dt: csr_to_bsr(fem_blocks(8, dof=4, dtype=dt), (4, 2)),
    "rect_matrix": lambda dt: csr_to_bsr(from_scipy(to_scipy(fem_blocks(12, dof=4))[:517]
                                                    .tocsr().astype(dt)), (4, 4)),
    "far18": lambda dt: csr_to_bsr(from_scipy(_blocks_on(128, 4, (-18, 0, 18), 33)
                                              .astype(dt)), (4, 4)),
    "eight_far": lambda dt: csr_to_bsr(from_scipy(_blocks_on(160, 4, EIGHT_FAR, 34)
                                                  .astype(dt)), (4, 4)),
}
WIDE_KS = [1, 3, 32, 65, 128, 200]


def _wide(name, dtype, k, cuda, seed=30):
    bsr = WIDE_CASES[name](dtype)
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal((bsr.shape[1], k))
                         .astype(dtype)).to(cuda)
    y_sp = torch.from_numpy(to_scipy(bsr).astype(np.float64) @ x.cpu().double().numpy())
    return bsr, x, y_sp


@pytest.mark.parametrize("name", list(WIDE_CASES))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", WIDE_KS)
def test_slab_kernel_matches_twin(cuda, name, dtype, k):
    bsr, x, y_sp = _wide(name, dtype, k, cuda)
    p = ct.bdia_plan(bsr, device=cuda)
    sl = slab_auto_plan(p)
    if sl is None:
        assert p.blocksize[1] == 3  # blocks of 3 fail the reference's slab gate
        return
    before = bdia_spmm_slab.launches
    y = bdia_spmm_slab(sl, x)
    torch.cuda.synchronize()
    assert bdia_spmm_slab.launches == before + 1 and y.shape == (bsr.shape[0], k)
    assert _relerr(y, bdia_spmm_slab_reference(sl, x)) <= TOL[dtype]
    assert _relerr(sl.spmm(x), y_sp) <= TOL[dtype]
    if sl.blocksize[0] == sl.blocksize[1]:  # the padded chain layout
        xp = sl.to_padded(x)
        yp = bdia_spmm_slab_padded(sl, xp)
        torch.cuda.synchronize()
        assert _relerr(yp, bdia_spmm_slab_reference(sl, xp, padded=True)) <= TOL[dtype]


@pytest.mark.parametrize("name", list(WIDE_CASES))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", WIDE_KS)
def test_ring_kernel_matches_twin(cuda, name, dtype, k):
    bsr, x, y_sp = _wide(name, dtype, k, cuda, seed=31)
    p = ct.bdia_plan(bsr, device=cuda)
    if p.npairs > MAX_PAIRS:  # (4, 2) blocks of the FEM band: 61 offsets × 2
        with pytest.raises(ValueError, match="pairs"):
            bdia_spmm_ring(p, x)
        return
    before = bdia_spmm_ring.launches
    y = bdia_spmm_ring(p, x)
    torch.cuda.synchronize()
    assert bdia_spmm_ring.launches == before + 1 and y.shape == (bsr.shape[0], k)
    assert _relerr(y, bdia_spmm_ring_reference(p, x)) <= TOL[dtype]
    rem = sp.csr_matrix((p.rem_data.cpu().double().numpy(),
                         (p.rem_row.cpu().numpy(), p.rem_col.cpu().numpy())), shape=bsr.shape)
    y_rem = torch.from_numpy(rem @ x.cpu().double().numpy())
    assert _relerr(y.double().cpu() + y_rem, y_sp) <= TOL[dtype]


@pytest.mark.parametrize("name", list(WIDE_CASES))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", WIDE_KS)
def test_bsr_kernel_matches_twin(cuda, name, dtype, k):
    bsr, x, y_sp = _wide(name, dtype, k, cuda, seed=32)
    p = BsrSpmmKernel.plan(bsr, k, device=cuda)
    before = bsr_spmm.launches
    y = p(x)
    torch.cuda.synchronize()
    assert bsr_spmm.launches == before + 1 and y.shape == (bsr.shape[0], k)
    assert _relerr(y, bsr_spmm_reference(p, x)) <= TOL[dtype]
    assert _relerr(y, y_sp) <= TOL[dtype]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_wide_kernels_take_a_misaligned_x(cuda, dtype):
    # X rows off the 16-byte grid: the scalar paths
    bsr = WIDE_CASES["fem4"](dtype)
    n, k = bsr.shape[1], 128
    buf = torch.from_numpy(np.random.default_rng(33).standard_normal(n * k + 1)
                           .astype(dtype)).to(cuda)
    x = buf[1:].view(n, k)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    p = ct.bdia_plan(bsr, device=cuda)
    sl = bdia_slab_plan(p, 16)
    assert _relerr(bdia_spmm_slab(sl, x), bdia_spmm_slab_reference(sl, x)) <= TOL[dtype]
    assert _relerr(bdia_spmm_ring(p, x), bdia_spmm_ring_reference(p, x)) <= TOL[dtype]
    q = BsrSpmmKernel.plan(bsr, k, device=cuda)
    assert _relerr(q(x), bsr_spmm_reference(q, x)) <= TOL[dtype]


def test_wide_kernels_write_every_row(cuda):
    # y comes from torch.empty: a row a kernel missed would hold stale bytes
    bsr = WIDE_CASES["rect_matrix"](np.float64)
    x = torch.zeros((bsr.shape[1], 70), dtype=torch.float64, device=cuda)
    p = ct.bdia_plan(bsr, device=cuda)
    sl = bdia_slab_plan(p, 16)
    assert torch.count_nonzero(bdia_spmm_slab(sl, x)) == 0
    assert torch.count_nonzero(bdia_spmm_slab_padded(sl, sl.to_padded(x))) == 0
    assert torch.count_nonzero(bdia_spmm_ring(p, x)) == 0
    assert torch.count_nonzero(BsrSpmmKernel.plan(bsr, 70, device=cuda)(x)) == 0


def test_wide_kernels_f64_output_and_refusals(cuda):
    bsr = WIDE_CASES["fem4"](np.float32)
    p = ct.bdia_plan(bsr, device=cuda)
    sl = bdia_slab_plan(p, 16)
    x = torch.from_numpy(np.random.default_rng(34).standard_normal((bsr.shape[1], 96))
                         .astype(np.float32)).to(cuda)
    y_sp = torch.from_numpy(to_scipy(bsr).astype(np.float64) @ x.cpu().double().numpy())
    # accum_dtype=float64: f32 values and X, f64 sums and output
    for y, twin in ((bdia_spmm_slab(sl, x, out_dtype=torch.float64),
                     bdia_spmm_slab_reference(sl, x, out_dtype=torch.float64)),
                    (bdia_spmm_ring(p, x, out_dtype=torch.float64),
                     bdia_spmm_ring_reference(p, x, out_dtype=torch.float64))):
        assert y.dtype == torch.float64 and _relerr(y, twin) <= TOL[np.float64]
    assert _relerr(ct.spmm(sl, x, accum_dtype=np.float64), y_sp) <= TOL[np.float64]
    with pytest.raises(TypeError):  # bf16 slabs (ROADMAP: bf16 values)
        bdia_spmm_slab(bdia_slab_plan(p, 16, dtype=torch.bfloat16), x)
    with pytest.raises(TypeError):  # f32 plan, f64 X
        bdia_spmm_ring(p, x.double())
    with pytest.raises(TypeError):
        BsrSpmmKernel.plan(bsr, 96, device=cuda)(x.double())
    with pytest.raises(ValueError):  # CPU X, CUDA plan
        bdia_spmm_slab(sl, x.cpu())


def test_wide_k_auto_routes_launch_their_kernels(cuda):
    a = WIDE_CASES["fem4"](np.float32).to(cuda)
    x = torch.from_numpy(np.random.default_rng(35).standard_normal((a.shape[1], 128))
                         .astype(np.float32)).to(cuda)
    y_ref = ct.spmm(a, x, method="xla")
    p = ct.bdia_plan(a)
    for call, counter in ((lambda: ct.spmm(a, x), bdia_spmm_slab),
                          (lambda: ct.spmm(p, x, method="pallas_bdia"), bdia_spmm_ring),
                          (lambda: ct.spmm(a, x, method="pallas_bsr"), bsr_spmm)):
        before, dia_before = counter.launches, dia_spmm.launches
        y = call()
        torch.cuda.synchronize()
        assert counter.launches == before + 1 and dia_spmm.launches == dia_before
        assert _relerr(y, y_ref) <= TOL[np.float32]


def test_host_array_matrices_take_their_kernels(cuda, monkeypatch):
    # a generated matrix (host numpy arrays) with a CUDA operand is planned
    # once on the operand's device and launches its kernel
    plans = PlanCache()
    monkeypatch.setattr(spmv_mod, "default_plan_cache", plans)
    a = fem_blocks(16, dof=4, return_bsr=True)
    x = torch.from_numpy(np.random.default_rng(36).standard_normal(a.shape[1])).to(cuda)
    for _ in range(2):
        before = bdia_spmv.launches
        y = ct.spmv(a, x)
        assert bdia_spmv.launches == before + 1 and len(plans._plans) == 1
    plan = plans.get(a)
    assert plan.device == x.device
    assert _relerr(y, torch.from_numpy(to_scipy(a) @ x.cpu().numpy())) <= TOL[np.float64]
    s = stencil_2d(32)
    X = torch.from_numpy(np.random.default_rng(37).standard_normal((s.shape[1], 8))).to(cuda)
    for _ in range(2):
        before = dia_spmm.launches
        Y = ct.spmm(s, X)
        assert dia_spmm.launches == before + 1 and len(plans._plans) == 2
    assert plans.get(s) is plans.get(s)
    assert _relerr(Y, torch.from_numpy(to_scipy(s) @ X.cpu().numpy())) <= TOL[np.float64]
    # a numpy operand goes to the card too
    before = bdia_spmv.launches
    y_np = ct.spmv(a, x.cpu().numpy())
    assert y_np.is_cuda and bdia_spmv.launches == before + 1


def _spd_bsr(nx):
    a = to_scipy(fem_blocks(nx, dof=4))
    return csr_to_bsr(_diag_shift(from_scipy((a + a.T).tocsr()), 1.1), (4, 4))


@pytest.mark.parametrize("s", [8, 128])
def test_block_cg_on_card_matches_cpu(cuda, s):
    st = _spd_bsr(16)
    b = np.random.default_rng(38).standard_normal((st.shape[0], s))
    before = bdia_spmm_slab.launches
    res = ct.solvers.block_cg(ct.bdia_plan(st, device=cuda), torch.from_numpy(b).to(cuda),
                              tol=1e-10)
    ref = ct.solvers.block_cg(ct.bdia_plan(st, device="cpu"), torch.from_numpy(b), tol=1e-10)
    assert res.converged and abs(res.iterations - ref.iterations) <= 1
    assert _relerr(res.x, ref.x) <= 1e-9
    # s = 128 runs the slab kernel once per iteration (plus the first residual)
    assert bdia_spmm_slab.launches - before == (res.iterations + 1 if s > 64 else 0)


@pytest.mark.parametrize("solver", ["cg", "block_cg"])
def test_solvers_take_host_data_to_the_card(cuda, solver):
    # a matrix of host arrays and a numpy b: the solve runs on the card,
    # one kernel launch per operator call through the cached plan
    st = _spd_bsr(8)
    b = np.random.default_rng(39).standard_normal(st.shape[0])
    counter = bdia_spmv
    if solver == "block_cg":
        b = np.stack([b, 2.0 * b + 1.0], axis=1)
        counter = dia_spmm  # s = 2 <= 64: the scalar-DIA route
    before = counter.launches
    res = getattr(ct.solvers, solver)(st, b, tol=1e-10)
    assert res.x.is_cuda and res.converged
    assert counter.launches - before == res.iterations + 1
    r = b - to_scipy(st) @ res.x.cpu().numpy()
    assert np.linalg.norm(r) / np.linalg.norm(b) <= 1e-8


def test_block_cg_refuses_tf32(cuda):
    st = _spd_bsr(8)
    b = torch.ones((st.shape[0], 4), dtype=torch.float32, device=cuda)
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="tf32"):
            ct.solvers.block_cg(ct.bdia_plan(st.astype(np.float32), device=cuda), b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
