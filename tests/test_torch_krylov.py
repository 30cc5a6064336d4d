"""The port's Krylov solvers against the JAX package's, on the CPU, at f64.

pipelined CG, BiCGStab (with block Jacobi on a nonsymmetric system),
Chebyshev, MINRES (on a symmetric indefinite system), GMRES(m), CGLS (on a
CSR, on a POH plan and with a callable pair) and iterative refinement (an
f32 inner solve reaching 1e-12).  Both packages get the same scipy matrix
and the same numpy right-hand side.

Tolerances: iterations within ±1 of the reference's (GMRES's restarts and
the outer steps of refinement equal), x within 1e-9 relative; where a
solver reports the true residual, it is ‖b − A·x‖ of its own x within
1e-9 relative.
"""

import jax  # noqa: F401  (kept on the CPU with x64 by conftest)
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cask_tpu.formats.convert as jconv
import cask_tpu.solvers.krylov as jkrylov
import cask_tpu.solvers.precond as jprecond
import cask_tpu_torch as ct
import cask_tpu_torch.formats.convert as tconv
import cask_tpu_torch.formats.generate as tgen
from cask_tpu_torch.solvers import (bicgstab, block_jacobi, cgls, chebyshev, gmres, ir_solve,
                                    minres, pipelined_cg)

X_TOL = 1e-9


def _pair(s):
    """(reference CSR, port CSR) of the scipy matrix ``s``."""
    s = sp.csr_matrix(s)
    s.sort_indices()
    return jconv.from_scipy(s), tconv.from_scipy(s)


def _poisson(nx=16, shift=1.0):
    """``shift·I + stencil_2d(nx)`` as scipy f64 (indefinite for shift < 0
    below the top of the spectrum)."""
    st = tconv.to_scipy(tgen.stencil_2d(nx))
    return (st + shift * sp.identity(st.shape[0])).tocsr()


def _nonsymmetric(nx=14):
    """The 5-point stencil plus a skew first-order term: a convection-
    diffusion operator, nonsymmetric with a positive definite symmetric
    part."""
    st = tconv.to_scipy(tgen.stencil_2d(nx))
    n = st.shape[0]
    skew = sp.diags([np.full(n - 1, 0.6), np.full(n - 1, -0.6)], [1, -1])
    return (st + skew + 0.5 * sp.identity(n)).tocsr()


def _b(n, seed=0):
    return np.random.default_rng(seed).standard_normal(n)


def _same(res, ref, *, iters=1):
    assert abs(res.iterations - int(ref.iterations)) <= iters
    assert res.converged == bool(ref.converged)
    xr = np.asarray(ref.x)
    assert np.linalg.norm(res.x.numpy() - xr) / np.linalg.norm(xr) <= X_TOL


def _eig_bounds(nx, shift):
    h = np.pi / (nx + 1)
    lo = shift + 4 - 4 * np.cos(h)
    hi = shift + 4 + 4 * np.cos(h)
    return lo, hi


@pytest.mark.parametrize("nx,shift", [(16, 1.0), (12, 0.2)])
@pytest.mark.parametrize("precond", [None, "jacobi"])
def test_pipelined_cg_matches_the_reference(nx, shift, precond):
    s = _poisson(nx, shift)
    j, t = _pair(s)
    b = _b(s.shape[0], 1)
    jm = jprecond.jacobi(j) if precond else None
    tm = ct.solvers.jacobi(t, device="cpu") if precond else None
    ref = jkrylov.pipelined_cg(j, b, tol=1e-10, maxiter=500, M=jm)
    res = pipelined_cg(t, torch.from_numpy(b), tol=1e-10, maxiter=500, M=tm)
    _same(res, ref)
    # the reported norm is the true residual's, one product after the loop
    assert abs(res.residual_norm - float(ref.residual_norm)) <= X_TOL * np.linalg.norm(b)
    assert res.residual_norm == pytest.approx(np.linalg.norm(b - s @ res.x.numpy()), rel=1e-9)


def test_pipelined_cg_counts_one_product_an_iteration_and_three_more():
    s = _poisson(10)
    _, t = _pair(s)
    calls = []

    def op(v):
        calls.append(1)
        return ct.spmv(t, v)

    res = pipelined_cg(op, torch.from_numpy(_b(s.shape[0], 2)), tol=1e-10)
    assert res.converged and len(calls) == res.iterations + 3


@pytest.mark.parametrize("precond", [None, "block_jacobi"])
def test_bicgstab_on_a_nonsymmetric_system(precond):
    s = _nonsymmetric()
    j, t = _pair(s)
    b = _b(s.shape[0], 3)
    jm = jprecond.block_jacobi(j, 16) if precond else None
    tm = block_jacobi(t, 16, device="cpu") if precond else None
    ref = jkrylov.bicgstab(j, b, tol=1e-10, maxiter=500, M=jm)
    res = bicgstab(t, torch.from_numpy(b), tol=1e-10, maxiter=500, M=tm)
    assert res.converged
    _same(res, ref)
    assert np.linalg.norm(b - s @ res.x.numpy()) / np.linalg.norm(b) <= 1e-9


@pytest.mark.parametrize("nx,shift", [(16, 1.0), (10, 0.5)])
def test_chebyshev_matches_the_reference(nx, shift):
    s = _poisson(nx, shift)
    j, t = _pair(s)
    b = _b(s.shape[0], 4)
    lo, hi = _eig_bounds(nx, shift)
    ref = jkrylov.chebyshev(j, b, lmin=lo, lmax=hi, tol=1e-10, maxiter=2000)
    res = chebyshev(t, torch.from_numpy(b), lmin=lo, lmax=hi, tol=1e-10, maxiter=2000)
    assert res.converged
    _same(res, ref)
    with pytest.raises(TypeError):  # the bounds are keyword-only
        chebyshev(t, torch.from_numpy(b), lo, hi)


# 64 unknowns: MINRES here runs no orthogonalization, and past about 50
# iterations the packages' rounding moves its stopping step by a few
@pytest.mark.parametrize("shift", [-3.1, -1.9, -0.7])
@pytest.mark.parametrize("precond", [None, "jacobi"])
def test_minres_on_a_symmetric_indefinite_system(shift, precond):
    s = _poisson(8, shift)
    assert np.linalg.eigvalsh(s.toarray()).min() < 0 < np.linalg.eigvalsh(s.toarray()).max()
    j, t = _pair(s)
    b = _b(s.shape[0], 5)
    # an SPD preconditioner for an indefinite system: |diag|⁻¹ here
    d = np.abs(s.diagonal())
    jm = (lambda r: r / d) if precond else None
    tm = (lambda r: r / torch.from_numpy(d)) if precond else None
    ref = jkrylov.minres(j, b, tol=1e-10, maxiter=1000, M=jm)
    res = minres(t, torch.from_numpy(b), tol=1e-10, maxiter=1000, M=tm)
    assert res.converged
    _same(res, ref)
    # converged tests |eta|; residual_norm is the true ‖b − Ax‖
    true = np.linalg.norm(b - s @ res.x.numpy())
    assert res.residual_norm == pytest.approx(true, rel=1e-9)


@pytest.mark.parametrize("restart,system", [(32, "spd"), (10, "spd"), (20, "nonsymmetric")])
def test_gmres_matches_the_reference(restart, system):
    s = _poisson(14, 0.5) if system == "spd" else _nonsymmetric(12)
    j, t = _pair(s)
    b = _b(s.shape[0], 6)
    ref = jkrylov.gmres(j, b, tol=1e-10, restart=restart, maxiter=50)
    res = gmres(t, torch.from_numpy(b), tol=1e-10, restart=restart, maxiter=50)
    assert res.converged
    _same(res, ref, iters=0)  # restarts equal
    assert res.residual_norm == pytest.approx(float(ref.residual_norm), rel=1e-6, abs=1e-12)


def test_gmres_stops_on_the_preconditioned_residual_and_reports_the_true_one():
    s = _nonsymmetric(12)
    j, t = _pair(s)
    b = _b(s.shape[0], 7)
    jm, tm = jprecond.jacobi(j), ct.solvers.jacobi(t, device="cpu")
    ref = jkrylov.gmres(j, b, tol=1e-8, restart=8, maxiter=40, M=jm)
    res = gmres(t, torch.from_numpy(b), tol=1e-8, restart=8, maxiter=40, M=tm)
    _same(res, ref, iters=0)
    assert res.residual_norm == pytest.approx(np.linalg.norm(b - s @ res.x.numpy()), rel=1e-9)


def _lsq(m=400, n=150, seed=0):
    a = tgen.random_uniform(m, n, density=0.03, seed=seed)
    s = tconv.to_scipy(a).tocsr()
    x = np.random.default_rng(seed + 1).standard_normal(n)
    b = s @ x + 1e-3 * np.random.default_rng(seed + 2).standard_normal(m)
    return s, b


@pytest.mark.parametrize("form", ["csr", "poh", "callable"])
def test_cgls_matches_the_reference(form):
    s, b = _lsq()
    j, t = _pair(s)
    ref = jkrylov.cgls(j, b, tol=1e-10, maxiter=2000)
    if form == "csr":
        res = cgls(t, torch.from_numpy(b), tol=1e-10, maxiter=2000)
    elif form == "poh":
        plan = ct.poh_plan(t, device="cpu")
        res = cgls(plan, torch.from_numpy(b), tol=1e-10, maxiter=2000)
    else:
        res = cgls(lambda v: ct.spmv(t, v), torch.from_numpy(b),
                   at=lambda v: ct.spmv(t, v, transpose=True), tol=1e-10, maxiter=2000)
    assert res.converged
    _same(res, ref)
    normal = np.linalg.norm(s.T @ (b - s @ res.x.numpy()))
    assert normal <= 1e-9 * np.linalg.norm(s.T @ b)
    assert res.residual_norm <= 1e-10 * np.linalg.norm(s.T @ b)  # ‖Aᵀr‖ of the recurrence


def test_cgls_with_a_callable_needs_its_transpose():
    s, b = _lsq(60, 20)
    _, t = _pair(s)
    with pytest.raises(ValueError, match="at="):
        cgls(lambda v: ct.spmv(t, v), torch.from_numpy(b))


@pytest.mark.parametrize("inner", ["cg", "bicgstab", "minres"])
def test_ir_solve_reaches_f64_from_an_f32_inner_solve(inner):
    s = _poisson(16, 1.0)
    j, t = _pair(s)
    b = _b(s.shape[0], 8)
    ref = jkrylov.ir_solve(j, b, work_dtype=np.float32, tol=1e-12, inner=inner)
    res = ir_solve(t, torch.from_numpy(b), tol=1e-12, inner=inner)
    assert res.converged and res.x.dtype == torch.float64
    assert res.iterations == int(ref.iterations)
    xr = np.asarray(ref.x)
    assert np.linalg.norm(res.x.numpy() - xr) / np.linalg.norm(xr) <= X_TOL
    assert np.linalg.norm(b - s @ res.x.numpy()) / np.linalg.norm(b) <= 1e-12


def test_ir_solve_over_a_dia_plan_and_its_refusals():
    s = _poisson(16, 1.0)
    _, t = _pair(s)
    b = torch.from_numpy(_b(s.shape[0], 9))
    res = ir_solve(ct.dia_plan(t, device="cpu"), b, tol=1e-12)
    assert res.converged
    assert np.linalg.norm(b.numpy() - s @ res.x.numpy()) / np.linalg.norm(b.numpy()) <= 1e-12
    with pytest.raises(ValueError, match="matrix"):
        ir_solve(lambda v: v, b)
    with pytest.raises(KeyError):
        ir_solve(t, b, inner="gmres")
