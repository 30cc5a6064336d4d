"""The port's LOBPCG against the JAX package's, on the CPU, at f64.

Both get the same scipy matrix and the same numpy start block.  Eigenvector
signs, and the basis chosen inside a degenerate eigenspace, differ between
LAPACK builds, so the tests compare Ritz values and the subspaces the Ritz
vectors span, never columns.

Tolerances: Ritz values within 1e-8 relative; the largest principal angle
between the two Ritz subspaces (its sine, ‖(I − Q₁Q₁ᵀ)Q₂‖₂) at most 1e-6;
both solves converged, to tol 1e-7 (both packages stagnate near 5e-8
here, where round-off in the whitened basis sets the floor).  Each Ritz
subspace is within about tol·|θ|/gap of the true one, so the cases are
those whose gap past the k-th eigenvalue keeps that under 1e-6: the top of
the 5-point spectrum crowds (the 4 largest of ``stencil_2d(20)`` leave the
two packages' subspaces 1.5e-6 apart, each converged).
"""

import jax  # noqa: F401  (kept on the CPU with x64 by conftest)
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cask_tpu.formats.convert as jconv
import cask_tpu.solvers.eig as jeig
import cask_tpu.solvers.precond as jprecond
import cask_tpu_torch as ct
import cask_tpu_torch.formats.convert as tconv
import cask_tpu_torch.formats.generate as tgen
from cask_tpu_torch.solvers import EigResult, ic0, lobpcg


def _pair(s):
    s = sp.csr_matrix(s)
    s.sort_indices()
    return jconv.from_scipy(s), tconv.from_scipy(s)


def _largest_angle_sine(x1, x2) -> float:
    q1, _ = np.linalg.qr(np.asarray(x1))
    q2, _ = np.linalg.qr(np.asarray(x2))
    return float(np.linalg.norm(q2 - q1 @ (q1.T @ q2), 2))


def _check(res, ref, s, k):
    assert isinstance(res, EigResult) and res.converged and bool(ref.converged)
    assert isinstance(res.iterations, int) and isinstance(res.residual_norm, float)
    assert res.theta.shape == (k,) and res.x.shape == (s.shape[0], k)
    th = res.theta.numpy()
    assert np.all(np.diff(th) >= 0)  # ascending
    assert np.allclose(th, np.asarray(ref.theta), rtol=1e-8, atol=0)
    assert _largest_angle_sine(res.x.numpy(), ref.x) <= 1e-6
    # the reported residual is a true one: one more product at exit
    r = s @ res.x.numpy() - res.x.numpy() * th[None, :]
    assert res.residual_norm == pytest.approx(np.linalg.norm(r, axis=0).max(), rel=1e-6)


TOL = 1e-7


@pytest.mark.parametrize("nx,k,largest", [(20, 4, False), (16, 6, False), (14, 3, False),
                                          (14, 3, True), (12, 2, True)])
def test_lobpcg_matches_the_reference(nx, k, largest):
    s = tconv.to_scipy(tgen.stencil_2d(nx)) + 0.1 * sp.identity(nx * nx)
    j, t = _pair(s)
    x0 = np.random.default_rng(nx).standard_normal((nx * nx, k))
    ref = jeig.lobpcg(j, x0, largest=largest, tol=TOL, maxiter=500)
    res = lobpcg(t, torch.from_numpy(x0), largest=largest, tol=TOL, maxiter=500)
    _check(res, ref, s, k)
    ev = np.linalg.eigvalsh(s.toarray())
    want = ev[-k:] if largest else ev[:k]
    assert np.allclose(res.theta.numpy(), want, rtol=1e-8)


def test_lobpcg_preconditioned_by_ic0_matches_the_reference():
    s = tconv.to_scipy(tgen.stencil_2d(14)) + 0.1 * sp.identity(196)
    j, t = _pair(s)
    x0 = np.random.default_rng(0).standard_normal((s.shape[0], 3))
    ref = jeig.lobpcg(j, x0, tol=TOL, maxiter=300, M=jprecond.ic0(j).apply)
    res = lobpcg(t, torch.from_numpy(x0), tol=TOL, maxiter=300,
                 M=ic0(t, device="cpu").apply)
    _check(res, ref, s, 3)
    plain = lobpcg(t, torch.from_numpy(x0), tol=TOL, maxiter=300)
    assert res.iterations < plain.iterations  # IC(0) speeds the smallest pairs


def test_lobpcg_over_a_callable_and_a_fem_matrix():
    a = tconv.to_scipy(tgen.fem_blocks(6, dof=2))
    s = ((a + a.T) + 30.0 * sp.identity(a.shape[0])).tocsr()
    j, t = _pair(s)
    x0 = np.random.default_rng(1).standard_normal((s.shape[0], 5))
    # θ ≈ 38: the relative tolerance leaves 38·tol of residual, so 1e-8 here
    ref = jeig.lobpcg(j, x0, tol=1e-8, maxiter=400)
    res = lobpcg(lambda v: ct.spmm(t, v), torch.from_numpy(x0), tol=1e-8, maxiter=400)
    _check(res, ref, s, 5)


def test_lobpcg_stopping_rule_and_refusals():
    s = tconv.to_scipy(tgen.stencil_2d(10))
    _, t = _pair(s)
    x0 = torch.from_numpy(np.random.default_rng(2).standard_normal((100, 3)))
    res = lobpcg(t, x0, tol=1e-12, maxiter=2)
    assert res.iterations == 2 and res.converged is False
    with pytest.raises(ValueError, match="3k"):
        lobpcg(t, torch.zeros((100, 34), dtype=torch.float64))
    with pytest.raises(ValueError, match="shape"):
        lobpcg(t, torch.zeros(100, dtype=torch.float64))
