"""The port's CUDA kernels on the card, against their plain PyTorch twins.

Kernels: BDIA SpMV, DIA SpMV and SpMM, the wide-k block SpMM kernels
(slab in both frames, BDIA ring, ELL-packed BSR), and the unstructured-matrix
kernels (POH SpMV and SpMM, LELL group sums and the whole LELL product);
and the paths built on them: the level-scheduled triangular solve
on the card against the CPU, Jacobi sweeps (one DIA SpMV or SpMM launch
each), CG preconditioned by ILU(0), the Chow–Patel factorization and the
SpGEMM numerics (the POH numeric one POH SpMV launch).

Every test here needs a CUDA device and skips without one.  This file
imports neither JAX nor the JAX package, so it also runs on a GPU machine
that has no JAX, without the suite's conftest (which configures JAX):

    python -m pytest tests/test_torch_gpu.py --noconftest -q

Tolerances: f64 ≤ 1e-12 normwise (the same products as the twin, in its
pair or diagonal order but for the ring's, which sums a chunk of block
offsets component by component), f32 ≤ 1e-5; the f32 slab kernel's 4xTF32
products ≤ 2e-6 on a case where one TF32 pass is off by more than 1e-5.
"""

import dataclasses
import functools
import importlib
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cask_tpu_torch as ct
from cask_tpu_torch.formats.convert import (coo_from_arrays, coo_to_csr, csr_to_bsr, from_scipy,
                                            to_scipy)
from cask_tpu_torch.formats.generate import (_diag_shift, banded, fem_blocks, power_law,
                                             random_uniform, stencil_2d)
from cask_tpu_torch.ops.bdia import bdia_to_coo
from cask_tpu_torch.ops.bdia_slab import bdia_slab_plan, slab_auto_plan
from cask_tpu_torch.ops.bsr_spmm import BsrSpmmKernel
from cask_tpu_torch.ops.kernels import bdia_kernels as bk
from cask_tpu_torch.ops.kernels.bdia_kernels import (MAX_PAIRS, bdia_spmm_ring,
                                                     bdia_spmm_ring_reference, bdia_spmv,
                                                     bdia_spmv_reference)
from cask_tpu_torch.ops.kernels.bdia_slab_kernels import (bdia_spmm_slab,
                                                          bdia_spmm_slab_padded,
                                                          bdia_spmm_slab_reference)
from cask_tpu_torch.ops.kernels.bsr_kernels import bsr_spmm, bsr_spmm_reference
from cask_tpu_torch.ops.kernels.dia_kernels import (dia_spmm, dia_spmm_reference, dia_spmv,
                                                    dia_spmv_reference)
from cask_tpu_torch.ops.kernels.lell_kernels import (lell_lane_sums, lell_lane_sums_reference,
                                                     lell_spmv, lell_spmv_reference)
from cask_tpu_torch.ops.kernels.poh_kernels import (poh_spmm, poh_spmm_reference, poh_spmv,
                                                    poh_spmv_reference)
from cask_tpu_torch.ops.poh import poh_to_coo
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
    # the vector x blocks' edges: one block row, block rows ragged against
    # the 256-thread blocks over several of them, one block offset, eight
    # far ones, bc = 1, and the 80-pair cap
    "one_block_row": lambda dt: csr_to_bsr(from_scipy(_blocks_on(1, 4, (0,), 39).astype(dt)),
                                           (4, 4)),
    "fem4_multi": lambda dt: fem_blocks(23, dof=4, dtype=dt, return_bsr=True),
    "one_offset": lambda dt: csr_to_bsr(from_scipy(_blocks_on(300, 4, (0,), 40).astype(dt)),
                                        (4, 4)),
    "eight_far": lambda dt: csr_to_bsr(from_scipy(_blocks_on(160, 4, EIGHT_FAR, 34)
                                                  .astype(dt)), (4, 4)),
    "rect4x1": lambda dt: csr_to_bsr(fem_blocks(6, dof=4, dtype=dt), (4, 1)),
    "pair_cap": lambda dt: csr_to_bsr(from_scipy(_blocks_on(300, 2, tuple(range(-20, 20)), 41)
                                                 .astype(dt)), (2, 2)),
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
    # bf16 values take the bf16 path (f32 sums and y), f16 values and x the
    # f16 path (f32 sums, f16 y)
    y = bdia_spmv(p.astype(torch.bfloat16),
                  torch.zeros(p.shape[1], dtype=torch.bfloat16, device=cuda))
    assert y.dtype == torch.float32 and torch.count_nonzero(y) == 0
    y = bdia_spmv(p.astype(torch.float16),
                  torch.zeros(p.shape[1], dtype=torch.float16, device=cuda))
    assert y.dtype == torch.float16 and torch.count_nonzero(y) == 0
    with pytest.raises(TypeError, match="float16"):  # a half type with f64
        bdia_spmv(p.astype(torch.float16), torch.zeros(p.shape[1], dtype=torch.float64,
                                                       device=cuda))


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


# the DIA SpMM kernel's window (chunks of at most 8 consecutive offsets, 4
# for f64, over 8 rows a thread): runs longer than a chunk, chunks of one,
# offsets far beyond a block's rows, rows near 0 and m, m != n both ways,
# one diagonal, ndiags near the plan's 1024 cap, run after run and scattered
DIA_SPMM_CASES = {
    **DIA_CASES,
    "one_diagonal": lambda: _diags(2001, 2001, [0], 20),
    "one_far_diagonal": lambda: _diags(2001, 2001, [-1999], 21),
    "long_runs": lambda: _diags(3001, 3001, [*range(-41, -32), -5, *range(-3, 4), 9,
                                             *range(30, 35)], 22),
    "scattered": lambda: _diags(2500, 2500, list(range(-181, 182, 3)), 23),
    "tall_far": lambda: _diags(4003, 901, [-3500, -3102, -2, -1, 0, 1, 2, 850], 24),
    "wide_far": lambda: _diags(901, 4003, [-850, -1, 0, 1, 2, 3000, 3500], 25),
    "near_cap_run": lambda: _diags(1500, 1500, list(range(-500, 500)), 26),
    "near_cap_scattered": lambda: _diags(3100, 3100, list(range(-1500, 1500, 3)), 27),
}


@functools.lru_cache(maxsize=None)  # the tests only read the matrix and the plan
def _dia(name, dtype, device):
    s = DIA_SPMM_CASES[name]().tocsr().astype(dtype)
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


@pytest.mark.parametrize("name", list(DIA_SPMM_CASES))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [1, 3, 20, 32, 64, 100, 128, 200])
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


@pytest.mark.parametrize("name", ["banded", "long_runs", "scattered", "tall_far", "wide_far"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [3, 32, 64, 128])
def test_dia_spmm_unaligned_x_takes_scalar_loads(cuda, name, dtype, k):
    # X whose rows start off the 16-byte grid: the kernel's scalar path
    s, p = _dia(name, dtype, cuda)
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
    # bf16 values take the bf16 path (f32 sums and y), f16 values and x the
    # f16 path (f32 sums, f16 y)
    y = dia_spmv(p.astype(torch.bfloat16), torch.zeros(n, dtype=torch.bfloat16, device=cuda))
    assert y.dtype == torch.float32 and torch.count_nonzero(y) == 0
    y = dia_spmv(p.astype(torch.float16), torch.zeros(n, dtype=torch.float16, device=cuda))
    assert y.dtype == torch.float16 and torch.count_nonzero(y) == 0
    with pytest.raises(TypeError, match="float16"):  # a half type with f64
        dia_spmv(p.astype(torch.float16), torch.zeros(n, dtype=torch.float64, device=cuda))


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scalar_dia_plan_built_on_the_card(cuda, monkeypatch, dtype):
    # a BDIA plan on the card derives its scalar-DIA plan there, bit for bit
    # the plan the host composition gives on the CPU; spmm at k ≤ 64 runs
    # through it and matches the plain twin on the CPU plan
    plans = PlanCache()
    monkeypatch.setattr(spmv_mod, "default_plan_cache", plans)
    bsr = fem_blocks(256, dof=4, dtype=np.float32, return_bsr=True)  # 262,144 rows
    host = ct.bdia_plan(bsr, device="cpu").astype(dtype)
    card = host.to(cuda)
    x = torch.from_numpy(np.random.default_rng(47).standard_normal((host.shape[1], 32))
                         .astype(np.float32))
    before = dia_spmm.launches
    y = ct.spmm(card, x.to(cuda))
    torch.cuda.synchronize()
    assert dia_spmm.launches == before + 1 and dict(plans.builds) == {"scalar_dia": 1}
    got = plans.get(card)
    want = ct.dia_plan(coo_to_csr(bdia_to_coo(host)), device="cpu").astype(dtype)
    assert got.vals.is_cuda and (got.offsets, got.shape) == (want.offsets, want.shape)
    for f in ("vals", "rem_data", "rem_row", "rem_col"):
        g, w = getattr(got, f).cpu(), getattr(want, f)
        if g.is_floating_point():  # bit for bit: −0.0 differs from +0.0
            g, w = (t.view({2: torch.int16, 4: torch.int32}[t.element_size()]) for t in (g, w))
        assert g.dtype == w.dtype and torch.equal(g, w), f
    assert _relerr(y.cpu(), want._spmm_reference(x)) <= TOL[np.float32]


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
# the BSR kernel's edges beside WIDE_CASES: block rows ragged against the
# staged kernel's 32 a block (16 for a half X) and a single one, K = 1, bc
# of 1, 8 and 16 (the last past the staged kernel's bc and beyond a block's
# 8 rows), and one block row of K = 120 (past what a staged block holds)
BSR_CASES = {
    **WIDE_CASES,
    "one_block_row": lambda dt: csr_to_bsr(from_scipy(_blocks_on(1, 4, (0,), 39).astype(dt)),
                                           (4, 4)),
    "fem4_ragged": lambda dt: fem_blocks(13, dof=4, dtype=dt, return_bsr=True),
    "k_one": lambda dt: csr_to_bsr(from_scipy(_blocks_on(50, 4, (0,), 42).astype(dt)), (4, 4)),
    "blocks2x1": lambda dt: csr_to_bsr(fem_blocks(8, dof=2, dtype=dt), (2, 1)),
    "fem8": lambda dt: fem_blocks(6, dof=8, dtype=dt, return_bsr=True),
    "fem16": lambda dt: fem_blocks(3, dof=16, dtype=dt, return_bsr=True),
    "wide_row": lambda dt: csr_to_bsr(from_scipy(_wide_row().astype(dt)), (4, 4)),
}
BSR_KS = [*WIDE_KS, 8, 256]
# the ring kernel's window (chunks of at most 4 consecutive block offsets, 2
# for f64 sums, over a warp's block rows): runs longer than a chunk, chunks
# of one, one block offset, the 80-pair cap, n not a multiple of bc
RING_CASES = {
    **WIDE_CASES,
    "one_offset": lambda dt: csr_to_bsr(from_scipy(_blocks_on(100, 4, (0,), 35).astype(dt)),
                                        (4, 4)),
    "long_run": lambda dt: csr_to_bsr(from_scipy(_blocks_on(150, 2, tuple(range(-6, 7)), 36)
                                                 .astype(dt)), (2, 2)),
    "scattered": lambda dt: csr_to_bsr(from_scipy(_blocks_on(
        200, 2, (-150, -97, -50, -21, -7, -3, 0, 2, 5, 9, 33, 77, 120, 160, 190), 37)
        .astype(dt)), (2, 2)),
    "pair_cap": lambda dt: csr_to_bsr(from_scipy(_blocks_on(120, 2, tuple(range(-20, 20)), 38)
                                                 .astype(dt)), (2, 2)),
    "rect_cols": lambda dt: csr_to_bsr(from_scipy(to_scipy(fem_blocks(12, dof=4))[:, :431]
                                                  .tocsr().astype(dt)), (4, 4)),
}
RING_KS = [1, 3, 32, 64, 65, 128, 200]


def _wide_row():
    """Block diagonal 4×4 blocks on 130 block rows, and block row 3 holding
    120 blocks: K = 120, as scipy f64."""
    s = _blocks_on(130, 4, (0,), 43).tolil()
    rng = np.random.default_rng(44)
    for j in range(120):
        s[12:16, j * 4 : j * 4 + 4] = rng.standard_normal((4, 4))
    return s.tocsr()


def _wide(name, dtype, k, cuda, seed=30):
    bsr = {**RING_CASES, **BSR_CASES}[name](dtype)
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
@pytest.mark.parametrize("k", [1, 7, 65, 127, 128, 130])
def test_slab_kernel_takes_ragged_k_in_both_frames(cuda, name, dtype, k):
    # column edges inside and past one 128-column block, k not a multiple of
    # 4 (4-byte copies of X); each entry launches the kernel exactly once
    bsr, x, y_sp = _wide(name, dtype, k, cuda, seed=29)
    sl = slab_auto_plan(ct.bdia_plan(bsr, device=cuda))
    if sl is None:
        assert bsr.blocksize[1] == 3  # blocks of 3 fail the reference's slab gate
        return
    before = bdia_spmm_slab.launches
    y = bdia_spmm_slab(sl, x)
    torch.cuda.synchronize()
    assert bdia_spmm_slab.launches == before + 1
    assert _relerr(y, bdia_spmm_slab_reference(sl, x)) <= TOL[dtype]
    y_rem = torch.from_numpy(sp.csr_matrix(
        (sl.rem_data.cpu().double().numpy(), (sl.rem_row.cpu().numpy(),
                                              sl.rem_col.cpu().numpy())),
        shape=bsr.shape) @ x.cpu().double().numpy())
    assert _relerr(y.double().cpu() + y_rem, y_sp) <= TOL[dtype]
    if sl.blocksize[0] == sl.blocksize[1]:
        xp = sl.to_padded(x)
        before = bdia_spmm_slab_padded.launches
        yp = bdia_spmm_slab_padded(sl, xp)
        torch.cuda.synchronize()
        assert bdia_spmm_slab_padded.launches == before + 1
        assert _relerr(yp, bdia_spmm_slab_reference(sl, xp, padded=True)) <= TOL[dtype]


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 explicit mantissa bits), to nearest with ties
    away from zero, as cvt.rna.tf32.f32."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _low_bits(a: np.ndarray) -> np.ndarray:
    """``a`` (f32) with the 12 mantissa bits below TF32's set on every
    nonzero: values a single TF32 pass rounds by about 2^-11."""
    bits = a.view(np.int32).copy()
    bits[a != 0] |= 0x0FFF
    return bits.view(np.float32)


@pytest.mark.parametrize("padded", [False, True])
def test_slab_kernel_is_f32_class_where_tf32_is_not(cuda, padded):
    # 4xTF32 keeps the low mantissa bits that one TF32 pass drops
    bsr = fem_blocks(16, dof=4, dtype=np.float32, return_bsr=True)
    bsr = dataclasses.replace(bsr, data=_low_bits(np.asarray(bsr.data)))
    sl = slab_auto_plan(ct.bdia_plan(bsr, device=cuda))
    rng = np.random.default_rng(28)
    x = torch.from_numpy(_low_bits(rng.standard_normal((bsr.shape[1], 128))
                                   .astype(np.float32))).to(cuda)
    xin = sl.to_padded(x) if padded else x
    counter = bdia_spmm_slab_padded if padded else bdia_spmm_slab
    before = counter.launches
    y = counter(sl, xin)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    s64 = dataclasses.replace(sl, slabs=sl.slabs.double())
    exact = bdia_spmm_slab_reference(s64, xin.double(), padded=padded)
    assert _relerr(y, bdia_spmm_slab_reference(sl, xin, padded=padded)) <= 2e-6
    assert _relerr(y, exact) <= 2e-6
    if not padded:  # and vs scipy f64 (the slab part: this plan has no remainder)
        assert sl.rem_data.numel() == 0
        assert _relerr(y, torch.from_numpy(to_scipy(bsr).astype(np.float64)
                                           @ x.cpu().double().numpy())) <= 2e-6
    # the case is built right: one TF32 pass misses by more than 1e-5
    one = bdia_spmm_slab_reference(dataclasses.replace(sl, slabs=_tf32(sl.slabs)), _tf32(xin),
                                   padded=padded)
    assert _relerr(one, exact) > 1e-5


@pytest.mark.parametrize("name", list(RING_CASES))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", RING_KS)
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


@pytest.mark.parametrize("name", list(BSR_CASES))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", BSR_KS)
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


@pytest.mark.parametrize("name", ["fem4", "fem3_ragged", "long_run", "scattered", "rect_cols"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [3, 32, 64, 128])
def test_ring_kernel_takes_a_misaligned_x(cuda, name, dtype, k):
    # X rows off the 16-byte grid: the window's scalar loads
    bsr = RING_CASES[name](dtype)
    n = bsr.shape[1]
    buf = torch.from_numpy(np.random.default_rng(39).standard_normal(n * k + 1)
                           .astype(dtype)).to(cuda)
    x = buf[1:].view(n, k)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    p = ct.bdia_plan(bsr, device=cuda)
    assert _relerr(bdia_spmm_ring(p, x), bdia_spmm_ring_reference(p, x)) <= TOL[dtype]


@pytest.mark.parametrize("name", list(RING_CASES))
@pytest.mark.parametrize("k", [1, 3, 64, 128])
def test_ring_kernel_sums_f32_in_f64(cuda, name, k):
    # accum_dtype=float64: f32 values and X, f64 sums and output
    bsr, x, y_sp = _wide(name, np.float32, k, cuda, seed=40)
    p = ct.bdia_plan(bsr, device=cuda)
    if p.npairs > MAX_PAIRS:
        return
    y = bdia_spmm_ring(p, x, out_dtype=torch.float64)
    torch.cuda.synchronize()
    assert y.dtype == torch.float64
    assert _relerr(y, bdia_spmm_ring_reference(p, x, out_dtype=torch.float64)) <= TOL[np.float64]


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
    # bf16 and f16 slabs take the half path (two TF32 passes with f32 X, f32 out)
    for h in (torch.bfloat16, torch.float16):
        y = bdia_spmm_slab(bdia_slab_plan(p, 16, dtype=h), x)
        assert y.dtype == torch.float32 and y.shape == x.shape
    with pytest.raises(TypeError, match="float16"):  # a half type with f64
        bdia_spmm_slab(bdia_slab_plan(p, 16, dtype=torch.float16), x.double())
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


@pytest.mark.parametrize("what", ["block_jacobi", "lobpcg", "amg"])
def test_solver_dense_products_refuse_tf32(cuda, what):
    a = stencil_2d(48, dtype=np.float32)
    r = torch.ones(a.shape[0], dtype=torch.float32, device=cuda)
    if what == "block_jacobi":
        run = functools.partial(ct.solvers.block_jacobi(a, 64, device=cuda), r)
    elif what == "lobpcg":
        run = functools.partial(ct.solvers.lobpcg, a.to(cuda), torch.ones(
            (a.shape[0], 4), dtype=torch.float32, device=cuda))
    else:
        run = functools.partial(ct.solvers.smoothed_aggregation_amg(
            a, dtype=torch.float32, device=cuda), r)
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="tf32"):
            run()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_amg_v_cycle_on_card_matches_cpu(cuda, dtype):
    # the same hierarchy built on the card and on the CPU: the card's cycle
    # runs the DIA SpMV kernel on banded levels and the POH SpMV kernel on
    # the tentative packs, the CPU's their twins
    a = stencil_2d(96, dtype=dtype)
    kw = dict(dense_cutoff=256, coarse_size=64, dtype=dtype)  # set-up is f64 whatever a is
    amg_gpu = ct.solvers.smoothed_aggregation_amg(a, device=cuda, **kw)
    amg_cpu = ct.solvers.smoothed_aggregation_amg(a, device="cpu", **kw)
    assert amg_gpu.level_sizes == amg_cpu.level_sizes
    r = torch.from_numpy(np.random.default_rng(0).standard_normal(a.shape[0]).astype(dtype))
    for fn in (dia_spmv, poh_spmv):
        fn.launches = 0
    y = amg_gpu(r.to(cuda))
    assert dia_spmv.launches > 0 and poh_spmv.launches > 0
    assert _relerr(y, amg_cpu(r)) <= TOL[dtype]
    res = ct.solvers.cg(a.to(cuda), r.to(cuda), tol=1e-6, maxiter=200, M=amg_gpu)
    ref = ct.solvers.cg(a.to("cpu"), r, tol=1e-6, maxiter=200, M=amg_cpu)
    assert res.converged and abs(res.iterations - ref.iterations) <= 1


# -- POH SpMV and SpMM (B16, B17), LELL group sums (B18) -----------------------


def _poh_empty_rows_cols():
    s = to_scipy(random_uniform(400, 400, density=0.02, seed=8)).tolil()
    s[100:200, :] = 0
    s[:, 100:200] = 0
    return from_scipy(s.tocsr())


def _poh_dense_column():
    m = 3000
    rows = np.arange(m)
    return ct.coo_to_csr(coo_from_arrays(np.random.default_rng(0).standard_normal(m), rows,
                                         np.full(m, 7), (m, m)))


def _poh_hub_row():
    # 4 entries a row, and row 5 with 15,000: its panel holds twice the mean
    # tile count, so the SpMM kernel cuts it into pieces
    s = to_scipy(random_uniform(20000, 20000, density=2e-4, seed=47))
    rng = np.random.default_rng(48)
    hub = sp.csr_matrix((rng.standard_normal(15000),
                         (np.full(15000, 5), rng.choice(20000, 15000, replace=False))),
                        shape=s.shape)
    return from_scipy((s + hub).tocsr())


POH_CASES = {  # name -> (CSR f64 on the host, poh_plan arguments): tests/test_poh.py's edges
    "power_law": lambda: (power_law(5000, avg_degree=12, seed=1), {}),
    "wide": lambda: (random_uniform(3000, 4700, density=0.002, seed=2), {}),
    "tall": lambda: (random_uniform(4700, 1100, density=0.002, seed=3), {}),
    "banded": lambda: (banded(2000, 9, seed=4), {}),
    "dense_column": lambda: (_poh_dense_column(), {}),
    "empty_rows_cols": lambda: (_poh_empty_rows_cols(), {}),
    "all_zero": lambda: (from_scipy(sp.csr_matrix((300, 500))), {}),
    "n_below_window": lambda: (random_uniform(5000, 300, density=0.01, seed=7), {}),
    "50x70": lambda: (random_uniform(50, 70, density=0.05, seed=6), {}),
    "row_panel_1024": lambda: (power_law(4000, avg_degree=8, seed=9), {"row_panel": 1024}),
    "col_window_512": lambda: (power_law(4000, avg_degree=8, seed=9), {"col_window": 512}),
    "tile_slots_1024": lambda: (power_law(4000, avg_degree=8, seed=9), {"tile_slots": 1024}),
    "tile_slots_8192": lambda: (power_law(4000, avg_degree=8, seed=9),
                                {"row_panel": 8192, "tile_slots": 8192}),
    "graph_pattern_120": lambda: (ct.read_mtx(Path(__file__).parent / "data"
                                              / "graph_pattern_120.mtx"), {}),
    # R = 8192: 64 KB of f64 accumulator, over the 48 KB a launch gets unasked
    "row_panel_8192": lambda: (power_law(9000, avg_degree=4, seed=9), {"row_panel": 8192}),
    "hub_row": lambda: (_poh_hub_row(), {}),
}


def _poh(name, dtype, device):
    a, kw = POH_CASES[name]()
    a = a.astype(dtype)
    return a, ct.poh_plan(a, device=device, **kw)


def _close(y, twin, ref_np, dtype):
    """kernel vs twin and vs scipy f64, normwise (an all-zero reference must
    be matched exactly)"""
    tol = TOL[dtype]
    ref = torch.from_numpy(np.asarray(ref_np, np.float64))
    for r in (twin, ref):
        if float(r.double().norm()) == 0.0:
            assert float(y.double().norm()) == 0.0
        else:
            assert _relerr(y, r) <= tol


@pytest.mark.parametrize("name", list(POH_CASES))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_poh_kernels_match_twin(cuda, name, dtype):
    a, p = _poh(name, dtype, cuda)
    s64 = to_scipy(a).astype(np.float64)
    rng = np.random.default_rng(40)
    x = torch.from_numpy(rng.standard_normal(a.shape[1]).astype(dtype)).to(cuda)
    y = poh_spmv(p, x)
    _close(y, poh_spmv_reference(p, x), s64 @ x.cpu().double().numpy(), dtype)
    pt = ct.transposed(p)
    xt = torch.from_numpy(rng.standard_normal(a.shape[0]).astype(dtype)).to(cuda)
    _close(ct.spmv(pt, xt), poh_spmv_reference(pt, xt), s64.T @ xt.cpu().double().numpy(),
           dtype)
    for k in (1, 32, 150):
        X = torch.from_numpy(rng.standard_normal((a.shape[1], k)).astype(dtype)).to(cuda)
        _close(poh_spmm(p, X), poh_spmm_reference(p, X), s64 @ X.cpu().double().numpy(), dtype)


@pytest.mark.parametrize("name", list(POH_CASES))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("k", [1, 7, 8, 9, 31, 32, 33, 150])
def test_poh_spmm_matches_twin_at_every_chunk_edge(cuda, name, dtype, k):
    # k around the 8-column (f32) and 4-column (f64) chunks; one launch per call
    a, p = _poh(name, dtype, cuda)
    X = torch.from_numpy(np.random.default_rng(49).standard_normal((a.shape[1], k))
                         .astype(dtype)).to(cuda)
    before = poh_spmm.launches
    Y = ct.spmm(p, X)
    torch.cuda.synchronize()
    assert poh_spmm.launches == before + 1 and Y.shape == (a.shape[0], k)
    _close(Y, poh_spmm_reference(p, X),
           to_scipy(a).astype(np.float64) @ X.cpu().double().numpy(), dtype)
    if name == "hub_row":  # the hub row's panel is cut: its pieces add into Y
        assert p.spmm_pieces.shape[0] > p.n_panels


def test_poh_entry_points_launch_their_kernels(cuda):
    a, p = _poh("power_law", np.float64, cuda)
    x = torch.ones(a.shape[1], dtype=torch.float64, device=cuda)
    before = (poh_spmv.launches, poh_spmm.launches)
    ct.spmv(p, x)
    ct.spmm(p, torch.ones((a.shape[1], 3), dtype=torch.float64, device=cuda))
    p.spmv(x, precision="fast")
    assert (poh_spmv.launches - before[0], poh_spmm.launches - before[1]) == (2, 1)
    with pytest.raises(ValueError):
        p.spmv(x, precision="bf16x3")


def test_poh_kernels_write_every_row(cuda):
    # spmm's Y comes from torch.empty: a row the kernel missed would hold stale bytes
    a, p = _poh("empty_rows_cols", np.float64, cuda)
    X = torch.zeros((a.shape[1], 5), dtype=torch.float64, device=cuda)
    assert torch.count_nonzero(poh_spmm(p, X)) == 0
    assert torch.count_nonzero(poh_spmv(p, X[:, 0].contiguous())) == 0


def test_poh_kernels_raise_on_what_they_do_not_take(cuda):
    a, p = _poh("50x70", np.float32, cuda)
    x = torch.ones(a.shape[1], device=cuda)
    with pytest.raises(TypeError):
        poh_spmv(p, x.double())
    # half values take the half path (tests below); mixed half types do not
    bf = p.astype(torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        poh_spmv(bf, x.to(torch.float16))
    with pytest.raises(TypeError, match="float16"):
        poh_spmm(p.astype(torch.float16), x.double()[:, None])
    with pytest.raises(ValueError):
        poh_spmv(p, x.cpu())  # plan on the card, x on the CPU
    with pytest.raises(ValueError):
        poh_spmv(p.to("cpu"), x)  # plan on the CPU, x on the card
    with pytest.raises(ValueError):
        poh_spmm(p.to("cpu"), x[:, None])
    # R = 32768 rows of f64 accumulator (256 KB) exceed a block's shared memory
    big = ct.poh_plan(random_uniform(33000, 100, density=1e-3, seed=46), row_panel=32768,
                      device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        poh_spmv(big, torch.ones(100, dtype=torch.float64, device=cuda))


def test_cg_over_poh_on_card_matches_cpu(cuda):
    a = to_scipy(power_law(2000, avg_degree=8, seed=41))
    spd = _diag_shift(from_scipy((a + a.T).tocsr()), 1.1)
    b = np.random.default_rng(42).standard_normal(spd.shape[0])
    before = poh_spmv.launches
    res = ct.solvers.cg(ct.poh_plan(spd, device=cuda), torch.from_numpy(b).to(cuda),
                        tol=1e-10, M=ct.solvers.jacobi(spd, device=cuda))
    assert poh_spmv.launches - before == res.iterations + 1
    ref = ct.solvers.cg(ct.poh_plan(spd, device="cpu"), torch.from_numpy(b), tol=1e-10,
                        M=ct.solvers.jacobi(spd, device="cpu"))
    assert res.converged and abs(res.iterations - ref.iterations) <= 1
    assert _relerr(res.x, ref.x) <= 1e-9


LELL_CASES = {  # name -> CSR f64 on the host
    "uniform": lambda: random_uniform(2000, density=0.008, seed=3),
    "power_law": lambda: power_law(3000, avg_degree=10, seed=6),
    "rectangle": lambda: random_uniform(1500, 900, density=0.01, seed=7),
    "past_sb_cap": lambda: random_uniform(500, 70_000, density=2e-4, seed=43),
}


@pytest.mark.parametrize("name", list(LELL_CASES))
@pytest.mark.parametrize("groups", [1, 4, 8, 16])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_lell_kernel_matches_twin(cuda, name, groups, dtype):
    a = LELL_CASES[name]().astype(dtype)
    p = ct.lell_plan(a, groups=groups, device=cuda)
    x = torch.from_numpy(np.random.default_rng(44).standard_normal(a.shape[1])
                         .astype(dtype)).to(cuda)
    sums = lell_lane_sums(p.vals, p.idx, x, groups)
    assert _relerr(sums, lell_lane_sums_reference(p.vals, p.idx, x, groups)) <= TOL[dtype]
    ref = to_scipy(a).astype(np.float64) @ x.cpu().double().numpy()
    assert _relerr(p.spmv(x), torch.from_numpy(ref)) <= TOL[dtype]


@pytest.mark.parametrize("name", list(LELL_CASES))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_lell_hyb_launches_both_tiers(cuda, name, dtype):
    a = LELL_CASES[name]().astype(dtype)
    h = ct.lell_plan_hyb(a, device=cuda)
    x = torch.from_numpy(np.random.default_rng(45).standard_normal(a.shape[1])
                         .astype(dtype)).to(cuda)
    before = lell_spmv.launches
    y = h.spmv(x)
    # the grouped tier's rows, then one launch adding the hub tier and the remainder
    assert lell_spmv.launches - before == 1 + _lell_adds(h)
    ref = to_scipy(a).astype(np.float64) @ x.cpu().double().numpy()
    assert _relerr(y, torch.from_numpy(ref)) <= TOL[dtype]
    assert _relerr(y, h._spmv_reference(x)) <= TOL[dtype]


def _lell_adds(h) -> int:
    """1 when ``HybLell.spmv`` adds a hub tier or a remainder into y (its
    second launch), else 0."""
    return int(h.hub.vals.shape[1] > 0 or h.main.rem_data.shape[0] > 0)


def test_lell_kernel_raises_on_what_it_does_not_take(cuda):
    a = LELL_CASES["uniform"]().astype(np.float32)
    p = ct.lell_plan(a, device=cuda)
    x = torch.ones(a.shape[1], device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        lell_lane_sums(p.vals.to(torch.bfloat16), p.idx, x.to(torch.float16), 8)
    with pytest.raises(TypeError):
        lell_lane_sums(p.vals, p.idx, x.double(), 8)
    with pytest.raises(ValueError):
        lell_lane_sums(p.vals, p.idx, x.cpu(), 8)
    with pytest.raises(ValueError):
        lell_lane_sums(p.vals.cpu(), p.idx.cpu(), x, 8)


# -- half values of the block and banded kernels (B1-B6, B8-B15): bf16 and f16 ---

BF16, F16, F32, F64 = torch.bfloat16, torch.float16, torch.float32, torch.float64
# values and operand: each H or f32, at least one H, for H in bf16 and f16
HALF_COMBOS = [(h, h) for h in (BF16, F16)] + [(h, F32) for h in (BF16, F16)] \
    + [(F32, h) for h in (BF16, F16)]
HALF_TOL = 1e-5  # f32 out, vs the twin: the same half products summed in f32
HALF_SLAB_TOL = 2e-6  # f32 out, the half slab's one or two TF32 passes vs the twin
TOL_F16_COMPOSED = 1e-3  # an f16 y plus its f16 remainder: two f16 roundings
# a SpMM's output: the default (f16 for f16 values and X, else f32), f32, or
# the combination's half type (the fully-half chain)
OUTS = [None, "f32", "half"]


def _half_of(vdt, xdt):
    return BF16 if BF16 in (vdt, xdt) else F16


def _out(vdt, xdt, out):
    """The ``out_dtype`` argument an ``OUTS`` entry stands for."""
    return {None: None, "f32": F32, "half": _half_of(vdt, xdt)}[out]


def _half_close(y, twin32) -> bool:
    """Every element of a bf16 or f16 output within one ulp of its type of
    the twin's f32 sum, plus the f32 rounding by which the two sums may
    differ (2^-20 of the largest |Y|): y is that sum rounded once, to
    nearest even."""
    mant, emin = (7, -126) if y.dtype == BF16 else (10, -14)
    y, ref = y.double().cpu(), twin32.double().cpu()
    exp = torch.floor(torch.log2(ref.abs().clamp_min(1e-30))).clamp_min(emin)
    ulp = torch.pow(2.0, exp - mant)
    slack = 2.0 ** -20 * float(ref.abs().max())
    return bool(((y - ref).abs() <= ulp + slack).all())


def _check_half(y, twin32, want, tol=HALF_TOL):
    """``y`` of type ``want``: a half output within one ulp of the twin's f32
    sums (:func:`_half_close`), an f32 one normwise within ``tol``."""
    assert y.dtype == want, (y.dtype, want)
    if want in (BF16, F16):
        assert _half_close(y, twin32)
    else:
        assert _relerr(y, twin32) <= tol


def _operand(shape, dt, seed, cuda):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32)).to(cuda).to(dt)


def _rounded_scipy(s, vdt) -> sp.csr_matrix:
    """The f64 scipy matrix of ``s`` with its values rounded to ``vdt``."""
    out = s.astype(np.float64)
    out.data = torch.from_numpy(np.asarray(s.data, np.float32)).to(vdt).double().numpy()
    return out


def _spmv_out(vdt, xdt):
    return F16 if (vdt, xdt) == (F16, F16) else F32


@pytest.mark.parametrize("name", ["fem2", "fem4", "fem8", "fem3_br3", "fem16", "remainder",
                                  "rect4x2", "ragged", "one_block_row", "fem4_multi",
                                  "one_offset", "eight_far", "rect4x1", "pair_cap"])
@pytest.mark.parametrize("vdt,xdt", HALF_COMBOS)
def test_half_bdia_spmv_matches_twin(cuda, name, vdt, xdt):
    bsr = CASES[name](np.float32)
    p = ct.bdia_plan(bsr, device=cuda).astype(vdt)
    x = _operand(p.shape[1], xdt, 50, cuda)
    before = bdia_spmv.launches
    y = p.spmv(x)
    yk = bdia_spmv(p, x)
    torch.cuda.synchronize()
    assert bdia_spmv.launches == before + 2
    _check_half(yk, bdia_spmv_reference(p.astype(F32), x.float()), _spmv_out(vdt, xdt))
    s = _rounded_scipy(to_scipy(bsr), vdt)  # the values the plan holds
    y_sp = torch.from_numpy(s @ x.cpu().double().numpy())
    if y.dtype == F16 and p.rem_data.shape[0]:  # the f16 y plus the f16 remainder
        assert _relerr(y, y_sp) <= TOL_F16_COMPOSED
    elif y.dtype == F16:  # the exact sum rounded once
        assert _half_close(y, y_sp)
    else:
        assert _relerr(y, y_sp) <= HALF_TOL


@pytest.mark.parametrize("name", list(DIA_CASES))
@pytest.mark.parametrize("vdt,xdt", HALF_COMBOS)
def test_half_dia_spmv_matches_twin(cuda, name, vdt, xdt):
    s, p = _dia(name, np.float32, cuda)
    p = p.astype(vdt)
    x = _operand(s.shape[1], xdt, 51, cuda)
    before = dia_spmv.launches
    y = p.spmv(x)
    yk = dia_spmv(p, x)
    torch.cuda.synchronize()
    assert dia_spmv.launches == before + 2 and y.dtype == _spmv_out(vdt, xdt)
    _check_half(yk, dia_spmv_reference(p.astype(F32), x.float()), _spmv_out(vdt, xdt))


@pytest.mark.parametrize("name", list(DIA_SPMM_CASES))
@pytest.mark.parametrize("vdt,xdt", HALF_COMBOS)
@pytest.mark.parametrize("k", [1, 12, 65, 128])  # 12, 65: half rows off the 16-byte vector
@pytest.mark.parametrize("out", OUTS)
def test_half_dia_spmm_matches_twin(cuda, name, vdt, xdt, k, out):
    s, p = _dia(name, np.float32, cuda)
    p = p.astype(vdt)
    x = _operand((s.shape[1], k), xdt, 52, cuda)
    out = _out(vdt, xdt, out)
    before = dia_spmm.launches
    y = dia_spmm(p, x, out_dtype=out)
    torch.cuda.synchronize()
    assert dia_spmm.launches == before + 1 and y.shape == (s.shape[0], k)
    _check_half(y, dia_spmm_reference(p, x, out_dtype=F32), bk.result_dtype(vdt, xdt, out))


@pytest.mark.parametrize("name", ["fem4", "fem2", "fem3_ragged", "remainder", "rect_matrix",
                                  "eight_far", "one_offset", "long_run", "scattered", "pair_cap",
                                  "rect_cols"])
@pytest.mark.parametrize("vdt,xdt", HALF_COMBOS)
@pytest.mark.parametrize("k", [1, 12, 65, 128])
@pytest.mark.parametrize("out", OUTS)
def test_half_ring_matches_twin(cuda, name, vdt, xdt, k, out):
    bsr = RING_CASES[name](np.float32)
    p = ct.bdia_plan(bsr, device=cuda).astype(vdt)
    x = _operand((bsr.shape[1], k), xdt, 53, cuda)
    out = _out(vdt, xdt, out)
    before = bdia_spmm_ring.launches
    y = bdia_spmm_ring(p, x, out_dtype=out)
    torch.cuda.synchronize()
    assert bdia_spmm_ring.launches == before + 1 and y.shape == (bsr.shape[0], k)
    _check_half(y, bdia_spmm_ring_reference(p, x, out_dtype=F32),
                bk.result_dtype(vdt, xdt, out))


@pytest.mark.parametrize("name", ["fem4", "fem2", "remainder", "rect_matrix", "far18",
                                  "eight_far"])
@pytest.mark.parametrize("vdt,xdt", HALF_COMBOS)
@pytest.mark.parametrize("k", [1, 12, 65, 128])
@pytest.mark.parametrize("out", OUTS)
def test_half_slab_matches_twin_in_both_frames(cuda, name, vdt, xdt, k, out):
    bsr = WIDE_CASES[name](np.float32)
    p = ct.bdia_plan(bsr, device=cuda)
    sl = slab_auto_plan(p.astype(vdt))
    x = _operand((bsr.shape[1], k), xdt, 54, cuda)
    out = _out(vdt, xdt, out)
    want = bk.result_dtype(vdt, xdt, out)
    before = bdia_spmm_slab.launches
    y = bdia_spmm_slab(sl, x, out_dtype=out)
    torch.cuda.synchronize()
    assert bdia_spmm_slab.launches == before + 1 and y.shape == (bsr.shape[0], k)
    _check_half(y, bdia_spmm_slab_reference(sl, x, out_dtype=F32), want, HALF_SLAB_TOL)
    if sl.blocksize[0] == sl.blocksize[1]:  # the padded chain layout
        xp = sl.to_padded(x)
        yp = bdia_spmm_slab_padded(sl, xp, out_dtype=out)
        torch.cuda.synchronize()
        _check_half(yp, bdia_spmm_slab_reference(sl, xp, padded=True, out_dtype=F32), want,
                    HALF_SLAB_TOL)


def _slab_errors(sl, x):
    """(kernel, plain FP32 twin) normwise errors against the exact f64
    product of the slabs' and X's values (f32 outputs)."""
    s64 = dataclasses.replace(sl, slabs=sl.slabs.double())
    exact = bdia_spmm_slab_reference(s64, x.double())
    y = bdia_spmm_slab(sl, x, out_dtype=F32)
    torch.cuda.synchronize()
    twin = bdia_spmm_slab_reference(sl, x, out_dtype=F32)  # f32 sums (TF32 off: full FP32)
    return _relerr(y, exact), _relerr(twin, exact)


@pytest.mark.parametrize("case", ["headline-shaped", "TF32-sensitive"])
@pytest.mark.parametrize("vdt,xdt", [(F32, F32), (BF16, F32), (F32, BF16), (F16, F32),
                                     (F32, F16), (F16, F16)])
def test_slab_error_class_is_the_plain_fp32_twins(cuda, case, vdt, xdt):
    # the split TF32 products (4 passes f32 x f32, 2 with one half operand,
    # one with two f16 ones) stay within 4x of the plain FP32 twin's own
    # error against f64, also on the TF32-sensitive case (every operand's 12
    # low mantissa bits set), where 3xTF32's dropped lo·lo terms all shared
    # the product's sign
    assert not torch.backends.cuda.matmul.allow_tf32
    bsr = fem_blocks(16, dof=4, dtype=np.float32, return_bsr=True)
    rng = np.random.default_rng(55)
    x = rng.standard_normal((bsr.shape[1], 128)).astype(np.float32)
    if case == "TF32-sensitive":
        bsr = dataclasses.replace(bsr, data=_low_bits(np.asarray(bsr.data)))
        x = _low_bits(x)
    sl = slab_auto_plan(ct.bdia_plan(bsr, device=cuda).astype(vdt))
    err_kernel, err_twin = _slab_errors(sl, torch.from_numpy(x).to(cuda).to(xdt))
    assert err_kernel <= 4 * err_twin, (err_kernel, err_twin)


@pytest.mark.parametrize("h", [BF16, F16])
def test_half_auto_routes_launch_their_kernels(cuda, h):
    # the routes of a half BSR and a half banded CSR: each launches its kernel
    # with the half plan, and no gather formulation; f32 operands give f32,
    # an f16 operand of an f16 matrix gives f16
    a = fem_blocks(16, dof=4, dtype=np.float32, return_bsr=True).to(cuda).astype(h)
    rng = np.random.default_rng(56)
    x = torch.from_numpy(rng.standard_normal(a.shape[1]).astype(np.float32)).to(cuda)
    counts = {f: f.launches for f in (bdia_spmv, dia_spmv, dia_spmm, bdia_spmm_slab,
                                      bdia_spmm_ring)}
    y = ct.spmv(a, x)
    p = spmv_mod.default_plan_cache.get(a)
    assert p.dtype == h and bdia_spmv.launches == counts[bdia_spmv] + 1
    _check_half(y, p._spmv_reference(x), F32)
    yh = ct.spmv(a, x.to(h))
    assert bdia_spmv.launches == counts[bdia_spmv] + 2
    _check_half(yh, bdia_spmv_reference(p.astype(F32), x.to(h).float()), _spmv_out(h, h))
    for k, kernel in ((32, dia_spmm), (128, bdia_spmm_slab)):
        X = torch.from_numpy(rng.standard_normal((a.shape[1], k)).astype(np.float32)).to(cuda)
        before = kernel.launches
        Y = ct.spmm(a, X)
        assert Y.dtype == F32 and kernel.launches == before + 1
        assert _relerr(Y, ct.spmm(p.to("cpu"), X.cpu())) <= HALF_SLAB_TOL * 5
    X = torch.from_numpy(rng.standard_normal((a.shape[1], 128)).astype(np.float32)).to(cuda)
    before = bdia_spmm_ring.launches
    Yr = ct.spmm(p, X, method="pallas_bdia", accum_dtype=h)
    assert Yr.dtype == h and bdia_spmm_ring.launches == before + 1
    assert _half_close(Yr, bdia_spmm_ring_reference(p, X, out_dtype=F32))
    c = stencil_2d(40, dtype=np.float32).to(cuda).astype(h)
    xs = torch.from_numpy(rng.standard_normal(c.shape[1]).astype(np.float32)).to(cuda)
    before = dia_spmv.launches
    ys = ct.spmv(c, xs)
    assert ys.dtype == F32 and dia_spmv.launches == before + 1
    assert ct.spmv(c, xs.to(h)).dtype == _spmv_out(h, h) and dia_spmv.launches == before + 2
    assert spmv_mod.default_plan_cache.get(c).dtype == h


@pytest.mark.parametrize("h", [BF16, F16])
def test_cg_over_half_operators_on_card_matches_cpu(cuda, h):
    s = to_scipy(fem_blocks(12, dof=4))
    spd = csr_to_bsr(_diag_shift(from_scipy((s + s.T).tocsr()), 1.1), (4, 4))
    st = to_scipy(stencil_2d(40))
    st = from_scipy((st + 8.0 * sp.identity(st.shape[0])).tocsr().astype(np.float32))
    for make, kernel, n in ((lambda dev: ct.BdiaOperator(ct.bdia_plan(spd, device=dev)
                                                         .astype(h)), bdia_spmv, spd.shape[0]),
                            (lambda dev: ct.solver_operator(st.to(dev).astype(h)), dia_spmv,
                             st.shape[0])):
        b = torch.from_numpy(np.random.default_rng(57).standard_normal(n).astype(np.float32))
        before = kernel.launches
        res = ct.solvers.cg(make(cuda), b.to(cuda), tol=1e-5, maxiter=300)
        assert kernel.launches - before == res.iterations + 1
        ref = ct.solvers.cg(make("cpu"), b, tol=1e-5, maxiter=300)
        assert res.converged and res.x.dtype == F32
        assert abs(res.iterations - ref.iterations) <= 1
        assert _relerr(res.x, ref.x) <= 1e-4


def test_half_kernels_raise_on_what_they_do_not_take(cuda):
    bsr = WIDE_CASES["fem4"](np.float32)
    p = ct.bdia_plan(bsr, device=cuda)
    sl = slab_auto_plan(p.astype(BF16))
    d = ct.dia_plan(from_scipy(DIA_CASES["banded"]().astype(np.float32)), device=cuda)
    n = bsr.shape[1]
    for v, xdt, out in ((F16, torch.float64, None), (BF16, F16, None), (F16, BF16, None),
                        (BF16, torch.float64, None), (BF16, F32, torch.float64),
                        (F16, F32, torch.float64), (F32, F32, BF16), (F16, F16, BF16),
                        (BF16, BF16, F16)):
        X = torch.zeros((n, 16), dtype=xdt, device=cuda)
        with pytest.raises(TypeError):
            bdia_spmm_ring(p.astype(v), X, out_dtype=out)
        with pytest.raises(TypeError):
            bdia_spmm_slab(dataclasses.replace(sl, slabs=sl.slabs.to(v)), X, out_dtype=out)
        with pytest.raises(TypeError):
            dia_spmm(d.astype(v), torch.zeros((d.shape[1], 16), dtype=xdt, device=cuda),
                     out_dtype=out)
        if out is None:
            with pytest.raises(TypeError):
                bdia_spmv(p.astype(v), X[:, 0].contiguous())
            with pytest.raises(TypeError):
                dia_spmv(d.astype(v), torch.zeros(d.shape[1], dtype=xdt, device=cuda))


# -- half values of BSR SpMM, POH and LELL (B7, B16-B18): bf16 and f16 -----------

HALF_POH_CASES = ["power_law", "wide", "dense_column", "empty_rows_cols", "all_zero", "50x70",
                  "tile_slots_8192", "row_panel_8192", "hub_row"]


def _half_plan_and_operand(p, vdt, xdt, shape, seed, cuda):
    """The plan with its values in ``vdt`` (rounded once from f32) and an
    operand in ``xdt``, from a numpy seed."""
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                         .astype(np.float32)).to(cuda).to(xdt)
    return p.astype(vdt), x


def _scipy_of(p) -> sp.csr_matrix:
    """The f64 scipy matrix a POH plan holds (its values as stored)."""
    coo = poh_to_coo(p)
    return sp.csr_matrix((np.asarray(coo.data, np.float64), (coo.row, coo.col)), shape=p.shape)


@pytest.mark.parametrize("name", HALF_POH_CASES)
@pytest.mark.parametrize("vdt,xdt", HALF_COMBOS)
def test_half_poh_kernels_match_twin(cuda, name, vdt, xdt):
    a, p32 = _poh(name, np.float32, cuda)
    p, x = _half_plan_and_operand(p32, vdt, xdt, a.shape[1], 60, cuda)
    s64 = _scipy_of(p)
    before = (poh_spmv.launches, poh_spmm.launches)
    y = poh_spmv(p, x)
    assert y.dtype == F32
    _close(y, poh_spmv_reference(p, x), s64 @ x.cpu().double().numpy(), np.float32)
    pt = ct.transposed(p)
    assert pt.dtype == vdt
    xt = _half_plan_and_operand(p32, vdt, xdt, a.shape[0], 61, cuda)[1]
    _close(ct.spmv(pt, xt), poh_spmv_reference(pt, xt), s64.T @ xt.cpu().double().numpy(),
           np.float32)
    for k in (1, 32, 33, 150):
        X = _half_plan_and_operand(p32, vdt, xdt, (a.shape[1], k), 62 + k, cuda)[1]
        Y = poh_spmm(p, X)
        assert Y.dtype == F32
        _close(Y, poh_spmm_reference(p, X), s64 @ X.cpu().double().numpy(), np.float32)
    torch.cuda.synchronize()
    assert (poh_spmv.launches - before[0], poh_spmm.launches - before[1]) == (2, 4)


@pytest.mark.parametrize("name", list(LELL_CASES))
@pytest.mark.parametrize("groups", [1, 8, 16])
@pytest.mark.parametrize("vdt,xdt", HALF_COMBOS)
def test_half_lell_kernel_matches_twin(cuda, name, groups, vdt, xdt):
    a = LELL_CASES[name]().astype(np.float32)
    p = ct.lell_plan(a, groups=groups, device=cuda)
    x = torch.from_numpy(np.random.default_rng(63).standard_normal(a.shape[1])
                         .astype(np.float32)).to(cuda).to(xdt)
    vals = p.vals.to(vdt)
    before = lell_lane_sums.launches
    y = lell_lane_sums(vals, p.idx, x, groups)
    torch.cuda.synchronize()
    assert lell_lane_sums.launches == before + 1
    twin32 = lell_lane_sums_reference(vals.float(), p.idx, x.float(), groups)  # the same sums
    if (vdt, xdt) == (F16, F16):  # the reference's f16 output, rounded once
        assert y.dtype == F16 and _half_close(y, twin32)
    else:
        assert y.dtype == F32 and _relerr(y, twin32) <= HALF_TOL
    assert lell_lane_sums_reference(vals, p.idx, x, groups).dtype == y.dtype


@pytest.mark.parametrize("name", list(LELL_CASES))
@pytest.mark.parametrize("vdt,xdt", HALF_COMBOS)
def test_half_lell_hyb_launches_both_tiers(cuda, name, vdt, xdt):
    a = LELL_CASES[name]().astype(np.float32)
    h32 = ct.lell_plan_hyb(a, device=cuda)
    h = ct.lell_plan_hyb(a.to(cuda).astype(vdt))  # planned from the half matrix on the card
    assert h.main.vals.dtype == vdt and h.hub.vals.dtype == vdt
    x = torch.from_numpy(np.random.default_rng(64).standard_normal(a.shape[1])
                         .astype(np.float32)).to(cuda).to(xdt)
    before = lell_spmv.launches
    y = h.spmv(x)
    torch.cuda.synchronize()
    adds = _lell_adds(h)  # an f16 y with a hub tier or remainder: summed in f32, then rounded
    assert lell_spmv.launches - before == 1 + adds + (adds and y.dtype == F16)
    assert h.main.vals.shape == h32.main.vals.shape
    ref = _rounded_scipy(to_scipy(a), vdt) @ x.cpu().double().numpy()
    tol = 1e-3 if y.dtype == F16 else HALF_TOL  # f16 y: the twin rounds it up to three times
    assert _relerr(y, torch.from_numpy(ref)) <= tol
    _check_half(y, _lell_twin(h.main, h.hub, x), _spmv_out(vdt, xdt))


@pytest.mark.parametrize("name", ["fem4", "fem2", "fem3_br3", "fem16", "rect4x2", "ragged",
                                  "fem8", "remainder", "band_as_blocks", "one_block_row",
                                  "one_offset", "eight_far", "rect4x1"])
@pytest.mark.parametrize("vdt,xdt", HALF_COMBOS)
# 12, 65: half rows off the 16-byte vectors; 8: one 16-byte vector a half
# row; 256: two passes of a half X's 16-lane team
@pytest.mark.parametrize("k", [1, 8, 12, 65, 128, 256])
def test_half_bsr_kernel_matches_twin(cuda, name, vdt, xdt, k):
    bsr = CASES[name](np.float32)
    p32 = BsrSpmmKernel.plan(bsr, k, device=cuda)
    p = dataclasses.replace(p32, vals=p32.vals.to(vdt))
    x = torch.from_numpy(np.random.default_rng(65).standard_normal((bsr.shape[1], k))
                         .astype(np.float32)).to(cuda).to(xdt)
    before = bsr_spmm.launches
    y = bsr_spmm(p, x)
    torch.cuda.synchronize()
    assert bsr_spmm.launches == before + 1 and y.dtype == vdt  # the values' type
    twin32 = bsr_spmm_reference(dataclasses.replace(p, vals=p.vals.float()), x.float())
    if vdt in (BF16, F16):
        assert _half_close(y, twin32)
    else:
        assert _relerr(y, twin32) <= HALF_TOL
    assert bsr_spmm_reference(p, x).dtype == vdt


def _misaligned(shape, dt, seed, cuda):
    """A contiguous operand of ``shape`` whose data starts one element past
    a 16-byte boundary (off every vector load's alignment)."""
    n = int(np.prod(shape))
    buf = _operand(n + 1, dt, seed, cuda)
    x = buf[1:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    return x


@pytest.mark.parametrize("name", ["fem4", "fem2", "fem8", "rect4x1"])
@pytest.mark.parametrize("vdt,xdt", [(F32, F32), (F64, F64), *HALF_COMBOS])
def test_bdia_spmv_takes_a_misaligned_x(cuda, name, vdt, xdt):
    # x off its vector loads' alignment: a block's components one at a time
    p = ct.bdia_plan(CASES[name](np.float32 if vdt != F64 else np.float64),
                     device=cuda).astype(vdt)
    x = _misaligned((p.shape[1],), xdt, 68, cuda)
    y = bdia_spmv(p, x)
    torch.cuda.synchronize()
    if vdt in (F32, F64):
        assert _relerr(y, bdia_spmv_reference(p, x)) <= TOL[np.float32 if vdt == F32
                                                             else np.float64]
    else:
        _check_half(y, bdia_spmv_reference(p.astype(F32), x.float()), _spmv_out(vdt, xdt))


@pytest.mark.parametrize("name", ["fem4", "fem2", "fem8", "rect4x1"])
@pytest.mark.parametrize("vdt,xdt", HALF_COMBOS)
@pytest.mark.parametrize("k", [8, 128])
def test_half_bsr_kernel_takes_a_misaligned_x(cuda, name, vdt, xdt, k):
    # X rows off the 16-byte grid: the scalar loads of the fallback kernel
    bsr = CASES[name](np.float32)
    p32 = BsrSpmmKernel.plan(bsr, k, device=cuda)
    p = dataclasses.replace(p32, vals=p32.vals.to(vdt))
    x = _misaligned((bsr.shape[1], k), xdt, 69, cuda)
    y = bsr_spmm(p, x)
    torch.cuda.synchronize()
    twin32 = bsr_spmm_reference(dataclasses.replace(p, vals=p.vals.float()), x.float())
    if vdt in (BF16, F16):
        assert _half_close(y, twin32)
    else:
        assert _relerr(y, twin32) <= HALF_TOL


def test_half_entry_points_launch_their_kernels(cuda):
    # spmv/spmm of a bf16 and an f16 POH plan, spmm(bsr_h, X, method="pallas_bsr")
    # and HybLell.spmv: each launches its kernel with the half plan
    a = power_law(3000, avg_degree=8, seed=66, dtype=np.float32).to(cuda)
    b = fem_blocks(8, dof=4, dtype=np.float32, return_bsr=True).to(cuda)
    rng = np.random.default_rng(67)
    for h in (BF16, F16):
        ah, bh = a.astype(h), b.astype(h)
        p = ct.poh_plan(ah)
        assert p.dtype == h and p.device.type == "cuda"
        for xdt in (h, F32):
            x = torch.from_numpy(rng.standard_normal(a.shape[1]).astype(np.float32)).to(cuda)
            x = x.to(xdt)
            counts = (poh_spmv.launches, poh_spmm.launches, bsr_spmm.launches,
                      lell_spmv.launches)
            assert ct.spmv(p, x).dtype == F32
            assert ct.spmm(p, torch.stack([x, x], 1)).dtype == F32
            Xb = torch.ones((b.shape[1], 16), dtype=xdt, device=cuda)
            Yb = ct.spmm(bh, Xb, method="pallas_bsr")
            hyb = ct.lell_plan_hyb(ah)
            yl = hyb.spmv(x)
            torch.cuda.synchronize()
            assert Yb.dtype == h and yl.dtype == (F16 if (h, xdt) == (F16, F16) else F32)
            assert (poh_spmv.launches - counts[0], poh_spmm.launches - counts[1],
                    bsr_spmm.launches - counts[2]) == (1, 1, 1)
            adds = _lell_adds(hyb)
            assert lell_spmv.launches - counts[3] == 1 + adds + (adds and yl.dtype == F16)


def test_cg_over_a_bf16_poh_plan_on_card_matches_cpu(cuda):
    s = to_scipy(power_law(2000, avg_degree=8, seed=13))
    s2 = (s + s.T).tocsr()
    d = 1.1 * np.asarray(abs(s2).sum(axis=1)).ravel()
    spd = from_scipy((s2 + sp.diags(np.where(d > 0, d, 1.1))).tocsr().astype(np.float32))
    b = torch.from_numpy(np.random.default_rng(68).standard_normal(spd.shape[0])
                         .astype(np.float32))
    before = poh_spmv.launches
    pc = ct.poh_plan(spd.to(cuda).astype(BF16))
    res = ct.solvers.cg(pc, b.to(cuda), tol=1e-6, maxiter=300,
                        M=ct.solvers.jacobi(spd, device=cuda))
    assert poh_spmv.launches - before == res.iterations + 1
    ref = ct.solvers.cg(pc.to("cpu"), b, tol=1e-6, maxiter=300,
                        M=ct.solvers.jacobi(spd, device="cpu"))
    assert res.converged and ref.converged and abs(res.iterations - ref.iterations) <= 2
    sb = _rounded_scipy(to_scipy(spd), BF16)
    assert _relerr(torch.from_numpy(sb @ res.x.cpu().double().numpy()), b) <= 2e-6


# -- the redesigned POH SpMV and LELL kernels (B16, B18): edge plans, every type --

ALL_COMBOS = [(F32, F32), (F64, F64)] + HALF_COMBOS


def _work(vdt, xdt):
    """The twin's type that holds the kernels' sums: f64 for f64, else f32."""
    return F64 if F64 in (vdt, xdt) else F32


def _check_sums(y, twin_wide, vdt, xdt):
    """A kernel output against the twin's sums in the working type: a half
    output within one ulp, f32 within 1e-5 and f64 within 1e-12 normwise (an
    all-zero twin matched exactly)."""
    if y.dtype in (BF16, F16):
        assert _half_close(y, twin_wide)
    elif float(twin_wide.double().norm()) == 0.0:
        assert float(y.double().norm()) == 0.0
    else:
        assert _relerr(y, twin_wide) <= (1e-12 if y.dtype == F64 else HALF_TOL)


def _poh_one_row_per_panel():
    # every live slot of a panel holds one row: rows 7 and 5000 of two panels
    rng = np.random.default_rng(80)
    rows = np.repeat([7, 5000], [3000, 2500])
    cols = np.concatenate([rng.choice(9000, 3000, replace=False),
                           rng.choice(9000, 2500, replace=False)])
    return from_scipy(sp.csr_matrix((rng.standard_normal(5500), (rows, cols)),
                                    shape=(8192, 9000)))


POH_EDGES = {  # name -> CSR on the host: the redesigned SpMV kernel's edges
    "one_row_per_panel": _poh_one_row_per_panel,
    "cut_panels": _poh_hub_row,  # the hub row's panel in several SpMV pieces
    "one_tile_per_panel": lambda: random_uniform(12000, 6000, density=5e-5, seed=81),
}


@pytest.mark.parametrize("name", list(POH_EDGES))
@pytest.mark.parametrize("vdt,xdt", ALL_COMBOS)
def test_poh_spmv_edge_plans_match_twin(cuda, name, vdt, xdt):
    a = POH_EDGES[name]().astype(np.float64 if vdt == F64 else np.float32)
    p = ct.poh_plan(a, device=cuda).astype(vdt)
    heavy = p.heavy_row.cpu().numpy()
    if name == "one_row_per_panel":
        assert heavy.tolist() == [[7, -1], [5000 - p.row_panel, -1]]
    elif name == "cut_panels":
        assert p.spmv_pieces.shape[0] > p.n_panels
    else:
        assert p.ntiles == p.n_panels
    x = torch.from_numpy(np.random.default_rng(82).standard_normal(a.shape[1])).to(cuda).to(xdt)
    before = poh_spmv.launches
    y = ct.spmv(p, x)
    torch.cuda.synchronize()
    assert poh_spmv.launches == before + 1 and y.dtype == (F64 if vdt == F64 else F32)
    w = _work(vdt, xdt)
    _check_sums(y, poh_spmv_reference(p.astype(w), x.to(w)), vdt, xdt)


def _lell_tier(case, a):
    """(tier, groups) of a LELL edge: a grouped plan of ``a``, changed as
    ``case`` says."""
    if case.startswith("groups_"):
        g = int(case[7:])
        return ct.lell_plan(a, groups=g, device="cuda"), g
    if case == "one_layer":
        p = ct.lell_plan(a, max_layers=1, device="cuda")
        assert p.layers == 1 and p.rem_data.shape[0] > 0
        return p, p.groups
    p = ct.lell_plan(a, device="cuda")
    if case == "trailing_padding_layers":  # two more layers, all padding
        pad = torch.zeros((2,) + tuple(p.vals.shape[1:]), dtype=p.vals.dtype, device="cuda")
        return dataclasses.replace(p, vals=torch.cat([p.vals, pad]),
                                   idx=torch.cat([p.idx, pad.int()])), p.groups
    # s_pad not a multiple of the eight slot rows a block takes, rows past it empty
    s = 61
    keep = p.rem_row < s * p.groups
    return dataclasses.replace(p, vals=p.vals[:, :s].contiguous(), idx=p.idx[:, :s].contiguous(),
                               rem_data=p.rem_data[keep], rem_row=p.rem_row[keep],
                               rem_col=p.rem_col[keep]), p.groups


LELL_EDGES = ["groups_1", "groups_2", "groups_4", "groups_8", "groups_16", "groups_32",
              "groups_64", "groups_128", "one_layer", "trailing_padding_layers", "ragged_s_pad"]


@pytest.mark.parametrize("case", LELL_EDGES)
@pytest.mark.parametrize("vdt,xdt", ALL_COMBOS)
def test_lell_edge_tiers_match_twin(cuda, case, vdt, xdt):
    a = power_law(3000, avg_degree=10, seed=6).astype(np.float32)
    tier, g = _lell_tier(case, a)
    if case == "ragged_s_pad":
        assert tier.s_pad % 8 and tier.s_pad * g < a.shape[0]
    vals = tier.vals.to(vdt)
    x = torch.from_numpy(np.random.default_rng(83).standard_normal(a.shape[1])).to(cuda).to(xdt)
    w = _work(vdt, xdt)
    _check_sums(lell_lane_sums(vals, tier.idx, x, g),
                lell_lane_sums_reference(vals.to(w), tier.idx, x.to(w), g), vdt, xdt)
    main = dataclasses.replace(tier, vals=vals, rem_data=tier.rem_data.to(vdt))
    before = lell_spmv.launches
    y = main.spmv(x)
    torch.cuda.synchronize()
    adds = int(main.rem_data.shape[0] > 0)
    assert y.shape == (a.shape[0],)
    assert lell_spmv.launches - before == 1 + adds + (adds and y.dtype == F16)
    _check_sums(y, _lell_twin(main, None, x), vdt, xdt)


def _lell_twin(main, hub, x):
    """The LELL product's twin with every value and x widened to the
    kernels' working type: the sums a kernel's output rounds once."""
    w = _work(main.vals.dtype, x.dtype)
    main = dataclasses.replace(main, vals=main.vals.to(w), rem_data=main.rem_data.to(w))
    if hub is not None:
        hub = dataclasses.replace(hub, vals=hub.vals.to(w))
    return lell_spmv_reference(main, hub, x.to(w))


@pytest.mark.parametrize("vdt,xdt", ALL_COMBOS)
def test_lell_hub_rows_cross_block_boundaries(cuda, vdt, xdt):
    # row 5 with 15,000 entries owns some 30 hub slot rows, and other hub rows
    # start and end inside a block's eight
    a = _poh_hub_row().astype(np.float32)
    s = to_scipy(a).tolil()
    for r in (40, 41, 42):
        s[r, :3000] = np.random.default_rng(r).standard_normal(3000)
    a = from_scipy(s.tocsr())
    h = ct.lell_plan_hyb(a.to(cuda).astype(vdt))
    rows = h.hub.slot2row.cpu().numpy()
    runs = np.flatnonzero(np.diff(rows)) + 1  # where a run of equal rows starts
    assert np.diff(np.concatenate([[0], runs])).max() > 8 and (runs % 8).any()
    x = torch.from_numpy(np.random.default_rng(84).standard_normal(a.shape[1])).to(cuda).to(xdt)
    before = lell_spmv.launches
    y = h.spmv(x)
    torch.cuda.synchronize()
    assert lell_spmv.launches - before == 2 + (y.dtype == F16)
    _check_sums(y, _lell_twin(h.main, h.hub, x), vdt, xdt)


# -- the level sweep, Jacobi sweeps, Chow-Patel and the SpGEMM numerics -------


def _tri(n, density, lower, seed, unit=False):
    rs = np.random.RandomState(seed)
    s = sp.random(n, n, density=density, format="csr", random_state=rs)
    s = sp.tril(s, k=-1) if lower else sp.triu(s, k=1)
    s = (s + sp.diags(np.ones(n) if unit else rs.rand(n) + 1.0)).tocsr()
    s.sum_duplicates()
    return s


TRI_CASES = {  # padded levels (the stencil's anti-diagonals), ragged ones, a chain
    "stencil lower": lambda: (sp.tril(to_scipy(stencil_2d(23))).tocsr(), True, False),
    "stencil upper": lambda: (sp.triu(to_scipy(stencil_2d(23))).tocsr(), False, False),
    "random lower": lambda: (_tri(700, 0.01, True, 1), True, False),
    "random upper, unit": lambda: (_tri(700, 0.01, False, 2, unit=True), False, True),
    "chain": lambda: ((_tri(300, 0.0, True, 3) + sp.diags(np.ones(299), -1)).tocsr(), True,
                      False),
}


@pytest.mark.parametrize("name", sorted(TRI_CASES))
@pytest.mark.parametrize("k", [None, 5])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_level_sweep_on_card_matches_cpu(cuda, name, k, dtype):
    s, lower, unit = TRI_CASES[name]()
    a = from_scipy(s.astype(dtype))
    trisolve_mod = importlib.import_module("cask_tpu_torch.ops.trisolve")
    plan = trisolve_mod.trisolve_plan(a, lower=lower, unit_diag=unit, device=cuda)
    plan_cpu = trisolve_mod.trisolve_plan(a, lower=lower, unit_diag=unit, device="cpu")
    b = np.random.default_rng(5).standard_normal(s.shape[0] if k is None else (s.shape[0], k))
    bt = torch.from_numpy(b.astype(dtype))
    x = plan.solve(a.data, bt.to(cuda))
    xe = trisolve_mod._level_sweep(torch.from_numpy(a.data).to(cuda), bt.to(cuda),
                                   plan.dev["rows"], plan.dev["diag"], plan.dev["ent_local"],
                                   plan.dev["ent_col"], plan.dev["ent_idx"],
                                   plan.dev["ent_valid"], n=plan.n, max_rows=plan.max_rows,
                                   unit_diag=unit)
    torch.cuda.synchronize()
    assert x.is_cuda and x.shape == bt.shape and bool((xe[plan.n] == 0).all())
    assert _relerr(x, plan_cpu.solve(a.data, bt)) <= TOL[dtype]


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("k", [None, 32])
def test_jacobi_sweeps_launch_the_dia_kernels(cuda, lower, k):
    s = to_scipy(stencil_2d(40))
    s = (sp.tril(s) if lower else sp.triu(s)).tocsr().astype(np.float32)
    trisolve_mod = importlib.import_module("cask_tpu_torch.ops.trisolve")
    plan = trisolve_mod.jacobi_trisolve_plan(from_scipy(s), lower=lower, device=cuda)
    plan_cpu = trisolve_mod.jacobi_trisolve_plan(from_scipy(s), lower=lower, device="cpu")
    assert isinstance(plan.strict, ct.DiaMatrix)
    b = torch.from_numpy(np.random.default_rng(6).standard_normal(
        1600 if k is None else (1600, k)).astype(np.float32))
    counter = dia_spmv if k is None else dia_spmm
    before = counter.launches
    x = plan.solve(b.to(cuda), sweeps=5)
    torch.cuda.synchronize()
    assert counter.launches == before + 5
    assert _relerr(x, plan_cpu.solve(b, sweeps=5)) <= TOL[np.float32]


def test_ilu_cg_on_card_matches_cpu(cuda):
    s = (sp.identity(1600) + to_scipy(stencil_2d(40))).tocsr()
    b = np.random.default_rng(7).standard_normal(1600)
    op = ct.solver_operator(from_scipy(s), device=cuda)
    for method in ("levels", "jacobi"):
        f, f_cpu = ct.ilu0(from_scipy(s), device=cuda), ct.ilu0(from_scipy(s), device="cpu")
        M = f.apply if method == "levels" else f.jacobi_applier(5)
        M_cpu = f_cpu.apply if method == "levels" else f_cpu.jacobi_applier(5)
        before = dia_spmv.launches
        res = ct.solvers.cg(op, torch.from_numpy(b).to(cuda), tol=1e-10, M=M)
        torch.cuda.synchronize()
        per_apply = 0 if method == "levels" else 10
        assert dia_spmv.launches - before == (res.iterations + 1) * (1 + per_apply)
        ref = ct.solvers.cg(from_scipy(s), torch.from_numpy(b), tol=1e-10, M=M_cpu)
        assert res.converged and abs(res.iterations - ref.iterations) <= 1
        assert _relerr(res.x, ref.x) <= 1e-9


def test_chow_patel_factorize_on_card_matches_cpu(cuda):
    ilu_mod = importlib.import_module("cask_tpu_torch.ops.ilu")
    a = stencil_2d(30)
    plan = ilu_mod.ilu0_device_plan(a, device=cuda)
    plan_cpu = ilu_mod.ilu0_device_plan(a, device="cpu")
    v = plan.factorize(sweeps=25)
    torch.cuda.synchronize()
    assert v.is_cuda and _relerr(v, plan_cpu.factorize(sweeps=25)) <= 1e-12
    assert float(plan.residual(v)) < 1e-9
    assert _relerr(v, torch.from_numpy(ct.ilu0(a, device="cpu").lu.data)) <= 1e-9
    b = torch.from_numpy(np.random.default_rng(8).standard_normal(900))
    assert _relerr(plan.apply(v, b.to(cuda)), plan_cpu.apply(plan_cpu.factorize(sweeps=25),
                                                             b)) <= 1e-12


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spgemm_numerics_on_card(cuda, dtype):
    spgemm_mod = importlib.import_module("cask_tpu_torch.ops.spgemm")
    a = power_law(2000, avg_degree=6, seed=9, dtype=dtype)
    ref = to_scipy(a).astype(np.float64) @ to_scipy(a).astype(np.float64)
    plan = spgemm_mod.spgemm_plan(a, a, device=cuda)
    c = ct.spgemm(a, plan=plan)
    torch.cuda.synchronize()
    assert c.data.is_cuda
    tol = TOL[dtype] * 10
    assert float(abs(to_scipy(c) - ref).max()) <= tol * abs(ref).max()
    bound = plan.bind_poh(a.data)
    before = poh_spmv.launches
    cp = bound(torch.from_numpy(a.data).to(cuda))
    torch.cuda.synchronize()
    assert poh_spmv.launches == before + 1 and cp.data.is_cuda
    assert _relerr(cp.data, c.data) <= tol
    ca = ct.sp_add(a, a, alpha=2.0, beta=-1.0)
    torch.cuda.synchronize()
    assert ca.data.is_cuda and _relerr(ca.data, torch.from_numpy(a.data)) <= TOL[dtype]


# -- the tuner on the card ------------------------------------------------------


def _tuner_cache(tmp_path):
    from cask_tpu_torch.tune import TunerCache

    return TunerCache(path=str(tmp_path / "tuner.json"))


def test_tune_on_card_picks_a_kernel_variant(cuda, tmp_path):
    from cask_tpu_torch.tune import tune

    a = fem_blocks(128, dof=4, dtype=np.float32)
    cache = _tuner_cache(tmp_path)
    t = tune(a, cache=cache, time_budget=20, device=cuda)
    assert "_xla" not in t.variant, cache.get(t.signature_key)
    entry = cache.get(t.signature_key)
    assert all("refused" in r or r["floor_seconds"] > 0 for r in entry["timings"].values())
    assert not any(r.get("non_finite") for r in entry["timings"].values())
    x = np.random.default_rng(0).standard_normal(a.shape[1]).astype(np.float32)
    y = t(torch.from_numpy(x).to(cuda))
    assert y.is_cuda
    ref = to_scipy(a).astype(np.float64) @ x.astype(np.float64)
    assert _relerr(y, torch.from_numpy(ref)) <= TOL[np.float32]


TUNE_VARIANTS = [("bsr_pallas:4", None), ("bsr_pallas:4", 8), ("bsr_pallas:4", 72),
                 ("bsr_pallas:32", 72), ("dia_pallas", None), ("dia_pallas", 8),
                 ("dia_pallas", 72), ("poh", None), ("poh:8192", None),
                 ("poh_fast:2048", None), ("poh_fast:8192", None), ("poh_mm", 8),
                 ("poh_mm_fast", 8), ("rcm:dia_pallas", None), ("rcm:dia_pallas", 8)]


@pytest.mark.parametrize("name,k", TUNE_VARIANTS, ids=[f"{n}-k{k}" for n, k in TUNE_VARIANTS])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_tuner_kernel_variant_equals_its_twin(cuda, name, k, dtype):
    from cask_tpu_torch.tune import Variant

    if name.startswith("rcm:"):
        s = to_scipy(banded(600, 4, seed=2, dtype=dtype))
        p = np.random.default_rng(0).permutation(600)
        a = from_scipy(s.tocsr()[p][:, p].tocsr(), format="csr")
    elif name.startswith("poh"):
        a = power_law(3000, avg_degree=8, seed=4, dtype=dtype)
    else:
        a = fem_blocks(12, dof=4, dtype=dtype)
    x = np.random.default_rng(1).standard_normal((a.shape[1], k) if k else a.shape[1])
    x = torch.from_numpy(x.astype(dtype))
    _, fn = Variant(name, 0.0).build(a, k, cuda)
    _, twin = Variant(name, 0.0).build(a, k, "cpu")
    before = sum(c.launches for c in (bdia_spmv, dia_spmv, dia_spmm, bsr_spmm, poh_spmv,
                                      poh_spmm, bdia_spmm_ring, bdia_spmm_slab))
    y = fn(x.to(cuda))
    torch.cuda.synchronize()
    after = sum(c.launches for c in (bdia_spmv, dia_spmv, dia_spmm, bsr_spmm, poh_spmv,
                                     poh_spmm, bdia_spmm_ring, bdia_spmm_slab))
    assert after > before, f"{name} launched no kernel"
    assert _relerr(y, twin(x)) <= TOL[dtype] * (10 if name.startswith("poh") else 1)


def test_tuner_cache_hit_times_nothing(cuda, tmp_path, monkeypatch):
    from cask_tpu_torch.tune import tune

    tuner_mod = importlib.import_module("cask_tpu_torch.tune.tuner")
    a = fem_blocks(32, dof=4, dtype=np.float32)
    cache = _tuner_cache(tmp_path)
    t = tune(a, cache=cache, time_budget=3, device=cuda)

    def no_measure(*args, **kw):
        raise AssertionError("a cache hit times nothing")

    monkeypatch.setattr(tuner_mod, "measure", no_measure)
    before = bdia_spmv.launches + dia_spmv.launches + poh_spmv.launches
    hit = tune(a, cache=cache, device=cuda)
    assert hit.variant == t.variant
    assert bdia_spmv.launches + dia_spmv.launches + poh_spmv.launches == before


# -- the distributed executors on one NCCL rank ----------------------------------


@pytest.fixture()
def nccl_rank(cuda):
    """A world of one NCCL rank in this process (the card's only rank)."""
    import torch.distributed as dist

    from cask_tpu_torch.parallel import row_mesh

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1)
    try:
        yield row_mesh()
    finally:
        dist.destroy_process_group()


def test_distspmv_on_one_nccl_rank_launches_the_kernels(nccl_rank):
    """Each interior a kernel: once a call on one rank (POH: once a pack),
    agreeing with the plain formulation and with scipy; CG and pipelined CG
    over the BDIA operator within one iteration of the single-device solve."""
    import cask_tpu_torch.parallel as tpar

    mesh = nccl_rank
    assert mesh.backend == "nccl" and not mesh.staged and mesh.device.type == "cuda"
    rng = np.random.default_rng(3)
    fem = tpar.fem_bdia_partition(48, dof=4, nshards=1)  # 9216 rows, f32
    fem_sp = to_scipy(tpar.fem_formula_bsr(48, dof=4)).astype(np.float32)
    sten = tpar.stencil_dia_partition(96, nshards=1, align=8192)
    sten_sp = to_scipy(stencil_2d(96, dtype=np.float32))
    pl = power_law(3000, avg_degree=6, seed=1, dtype=np.float32)
    poh = tpar.partition_poh(pl, 1)
    cases = [("fused", fem, fem_sp, None, dict(interior="fused"), bdia_spmv),
             ("pallas", fem, fem_sp, None, dict(interior="pallas"), bdia_spmv),
             ("slab", fem, fem_sp, 128, dict(mm_interior="slab"), bdia_spmm_slab),
             ("dia", sten, sten_sp, None, dict(interior="pallas"), dia_spmv),
             ("poh", poh, to_scipy(pl), None, {}, poh_spmv),
             ("poh_mm", poh, to_scipy(pl), 32, {}, poh_spmm)]
    for name, plan, s, k, kw, counter in cases:
        x = rng.standard_normal((s.shape[1], k) if k else s.shape[1]).astype(np.float32)
        op = tpar.DistSpmv(plan, mesh, **kw)
        before = counter.launches
        y = op(x)
        torch.cuda.synchronize()
        # POH: the interior and the exterior pack, one launch each
        assert counter.launches - before == (2 if name.startswith("poh") else 1), name
        ref = torch.from_numpy(s.astype(np.float64) @ x.astype(np.float64))
        assert _relerr(y, ref) <= 1e-5, name
        if not name.startswith("poh"):  # POH has no plain interior
            plain = tpar.DistSpmv(plan, mesh, interior="plain", mm_interior="plain")
            assert _relerr(y, plain(x)) <= 1e-5, name
    op = tpar.DistSpmv(fem, mesh)
    assert (op.interior, op.mm_interior) == ("fused", "slab")
    # the solves: an SPD block system (the FEM formula matrix is not symmetric)
    a_sp = to_scipy(fem_blocks(48, dof=4, dtype=np.float32))
    spd = csr_to_bsr(_diag_shift(from_scipy((a_sp + a_sp.T).tocsr()), 1.1), (4, 4))
    op = tpar.DistSpmv(tpar.partition_bdia(spd, 1), mesh)
    single = ct.BdiaOperator(ct.bdia_plan(spd, device=mesh.device))
    b = op.padded(rng.standard_normal(spd.shape[0]).astype(np.float32))
    from cask_tpu_torch.solvers import cg, pipelined_cg

    for solver in (cg, pipelined_cg):
        res = solver(op.padded_op, b, tol=1e-6, maxiter=200)
        ref = solver(single, b, tol=1e-6, maxiter=200)
        # (f32 pipelined CG's recurrence drifts: its true residual, which
        # decides converged, ends near 1e-6 in both)
        assert abs(res.iterations - ref.iterations) <= 1, solver.__name__
        assert res.residual_norm <= 10 * max(ref.residual_norm, 1e-6 * float(b.norm()))
        assert res.converged or solver is pipelined_cg
