"""CG over the port's BdiaOperator against the JAX package's CG over its
BdiaOperator, on the CPU, at f64; and the slice as a whole.

The SPD block system is built as on the card: S = A + Aᵀ (through scipy),
``_diag_shift(S, 1.1)`` (strictly diagonally dominant, κ ≤ 21), blocked
(4, 4).  Iterations agree within ±1 and x within 1e-9 relative.
"""

import jax  # noqa: F401  (kept on the CPU with x64 by conftest)
import numpy as np
import pytest
import torch

import cask_tpu.formats.convert as jconv
import cask_tpu.formats.generate as jgen
import cask_tpu.ops.bdia as jbdia
import cask_tpu.solvers.krylov as jkrylov
import cask_tpu.solvers.precond as jprecond
import cask_tpu_torch as ct
import cask_tpu_torch.formats.convert as tconv
import cask_tpu_torch.formats.generate as tgen
from cask_tpu_torch.solvers import cg, extract_diagonal, jacobi
from cask_tpu_torch.tune import timing


def _spd_system(nx=12, dof=4, dtype=np.float64):
    """(reference BSR, port BSR, port CSR) of the same SPD block matrix."""
    a = tconv.to_scipy(tgen.fem_blocks(nx, dof=dof, dtype=dtype))
    s_t = tgen._diag_shift(tconv.from_scipy((a + a.T).tocsr()), 1.1)
    s_j = jgen._diag_shift(jconv.from_scipy((a + a.T).tocsr()), 1.1)
    return jconv.csr_to_bsr(s_j, (dof, dof)), tconv.csr_to_bsr(s_t, (dof, dof)), s_t


def _b(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n)


@pytest.mark.parametrize("nx,dof", [(12, 4), (9, 2), (6, 8)])
def test_cg_over_bdia_operator_matches_the_reference(nx, dof):
    sj, st, _ = _spd_system(nx, dof)
    b = _b(st.shape[0])
    ref = jkrylov.cg(jbdia.BdiaOperator(jbdia.bdia_plan(sj)), b, tol=1e-10, maxiter=200)
    op = ct.BdiaOperator(ct.bdia_plan(st))
    assert op.mode == "reference"
    res = cg(op, torch.from_numpy(b), tol=1e-10, maxiter=200)
    assert res.converged and bool(ref.converged)
    assert abs(res.iterations - int(ref.iterations)) <= 1
    xr = np.asarray(ref.x)
    assert np.linalg.norm(res.x.numpy() - xr) / np.linalg.norm(xr) <= 1e-9
    s = tconv.to_scipy(st)
    assert np.linalg.norm(b - s @ res.x.numpy()) / np.linalg.norm(b) <= 1e-9


def test_jacobi_pcg_matches_the_reference():
    sj, st, s_csr = _spd_system(10, 4)
    b = _b(st.shape[0], 1)
    j_csr = jconv.bsr_to_csr(sj)
    ref = jkrylov.cg(jbdia.BdiaOperator(jbdia.bdia_plan(sj)), b, tol=1e-10,
                     M=jprecond.jacobi(j_csr))
    res = cg(ct.BdiaOperator(ct.bdia_plan(st)), torch.from_numpy(b), tol=1e-10,
             M=jacobi(tconv.bsr_to_csr(st)))
    assert abs(res.iterations - int(ref.iterations)) <= 1
    assert np.linalg.norm(res.x.numpy() - np.asarray(ref.x)) / np.linalg.norm(ref.x) <= 1e-9
    assert np.array_equal(extract_diagonal(s_csr), jprecond.extract_diagonal(
        jconv.from_scipy(tconv.to_scipy(s_csr))))


def test_cg_on_a_matrix_goes_through_spmv():
    # a CSR operand runs the gather formulation through spmv, as in the reference
    a = jgen.stencil_2d(16)
    t = tgen.stencil_2d(16)
    b = _b(a.shape[0], 2)
    ref = jkrylov.cg(a, b, tol=1e-10)
    res = cg(t, torch.from_numpy(b), tol=1e-10)
    assert abs(res.iterations - int(ref.iterations)) <= 1
    assert np.linalg.norm(res.x.numpy() - np.asarray(ref.x)) / np.linalg.norm(ref.x) <= 1e-9


def test_stopping_rule_and_result_fields():
    _, st, _ = _spd_system(6, 2)
    b = torch.from_numpy(_b(st.shape[0], 3))
    op = ct.BdiaOperator(ct.bdia_plan(st))
    res = cg(op, b, tol=1e-12, maxiter=2)
    assert res.iterations == 2 and res.converged is False
    assert isinstance(res.residual_norm, float) and res.residual_norm > 0
    # atol above ‖b‖ stops before the first iteration
    res = cg(op, b, atol=2 * float(b.norm()))
    assert res.iterations == 0 and res.converged is True
    # a warm start at the solution stops at once too
    x = cg(op, b, tol=1e-12).x
    assert cg(op, b, x0=x, tol=1e-8).iterations == 0


def test_jacobi_needs_a_nonzero_diagonal():
    t = tconv.coo_to_csr(tconv.coo_from_arrays([1.0, 2.0], [0, 1], [1, 0], (2, 2)))
    with pytest.raises(ValueError):
        jacobi(t)
    d = tgen.stencil_2d(3)
    apply = jacobi(d)
    r = torch.ones(9, dtype=torch.float64)
    assert torch.allclose(apply(r), r / 4.0)
    assert apply(torch.ones(9, 2, dtype=torch.float64)).shape == (9, 2)


def test_slice_end_to_end_on_cpu():
    # generator -> BSR -> spmv (public entry) -> plan -> CG, all in the port
    a = ct.generate.fem_blocks(8, dof=4, return_bsr=True)
    x = torch.from_numpy(_b(a.shape[1], 4))
    y = ct.spmv(a, x)
    ref = jconv.to_scipy(jgen.fem_blocks(8, dof=4)) @ x.numpy()
    assert np.linalg.norm(y.numpy() - ref) / np.linalg.norm(ref) <= 1e-12
    assert np.linalg.norm(ct.bdia_plan(a).spmv(x).numpy() - ref) / np.linalg.norm(ref) <= 1e-12
    _, st, _ = _spd_system(8, 4)
    res = ct.solvers.cg(ct.BdiaOperator(st), torch.from_numpy(_b(st.shape[0], 5)), tol=1e-8)
    assert res.converged


def test_time_cuda_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        timing.time_cuda(lambda: None)


