"""The port's block Jacobi, spectrum estimates and Chebyshev preconditioner
against the JAX package's, on the CPU.

The reference draws its start vectors with ``jax.random.normal``, which the
port cannot reproduce, so both sides are given the same numpy vector: the
test replaces ``jax.random.normal`` and the port's ``_start_vector``.

Tolerances: block Jacobi's apply within 1e-12 normwise (f64, on a vector
and on a block); ``lanczos_extremal`` within 1e-10 relative (f64);
``estimate_lmax`` within 1e-5 relative (its start vector is float32
whatever the matrix's type); the Chebyshev preconditioner's apply within
1e-12 normwise (f64).
"""

import jax
import jax.numpy as jnp
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
import cask_tpu_torch.solvers.precond as tprecond
from cask_tpu_torch.solvers import (block_jacobi, chebyshev_precond, estimate_lmax, jacobi,
                                    lanczos_extremal)


def _pair(s):
    s = sp.csr_matrix(s)
    s.sort_indices()
    return jconv.from_scipy(s), tconv.from_scipy(s)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _same_start(monkeypatch, v0):
    """Give both packages ``v0`` as their start vector."""
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(v0, dtype))
    monkeypatch.setattr(tprecond, "_start_vector",
                        lambda n, dtype, seed, device: torch.as_tensor(v0, dtype=dtype,
                                                                       device=device))


def _fem(nx=6, dof=3):
    a = tconv.to_scipy(tgen.fem_blocks(nx, dof=dof))
    return (a + a.T).tocsr() + sp.identity(a.shape[0]) * 20.0


@pytest.mark.parametrize("block", [64, 16, 7])
@pytest.mark.parametrize("cols", [None, 5])
def test_block_jacobi_apply_matches_the_reference(block, cols):
    s = _fem()  # 108 rows: the last block is padded for every size here
    j, t = _pair(s)
    rng = np.random.default_rng(block)
    r = rng.standard_normal(s.shape[0] if cols is None else (s.shape[0], cols))
    ref = np.asarray(jprecond.block_jacobi(j, block)(jnp.asarray(r)))
    out = block_jacobi(t, block, device="cpu")(torch.from_numpy(r))
    assert out.shape == r.shape
    assert _rel(out.numpy(), ref) <= 1e-12


def test_block_jacobi_patches_a_zero_diagonal():
    s = _fem(4, 2).tolil()
    s[3, 3] = 0.0  # the reference puts 1 there before inverting the block
    s = s.tocsr()
    s.eliminate_zeros()
    j, t = _pair(s)
    r = np.random.default_rng(1).standard_normal(s.shape[0])
    ref = np.asarray(jprecond.block_jacobi(j, 8)(jnp.asarray(r)))
    assert _rel(block_jacobi(t, 8, device="cpu")(torch.from_numpy(r)).numpy(), ref) <= 1e-12


def test_block_jacobi_of_one_block_is_the_inverse():
    s = _fem(3, 2)
    _, t = _pair(s)
    r = np.random.default_rng(2).standard_normal(s.shape[0])
    out = block_jacobi(t, s.shape[0], device="cpu")(torch.from_numpy(r)).numpy()
    assert _rel(out, np.linalg.solve(s.toarray(), r)) <= 1e-12


@pytest.mark.parametrize("nx", [12, 20])
@pytest.mark.parametrize("iters", [5, 30])
def test_lanczos_extremal_matches_the_reference(monkeypatch, nx, iters):
    s = tconv.to_scipy(tgen.stencil_2d(nx)) + sp.identity(nx * nx)
    j, t = _pair(s)
    v0 = np.random.default_rng(nx).standard_normal(nx * nx)
    _same_start(monkeypatch, v0)
    ref = jprecond.lanczos_extremal(j, nx * nx, iters=iters)
    out = lanczos_extremal(t, nx * nx, iters=iters, device="cpu")
    assert out[0] == pytest.approx(ref[0], rel=1e-10)
    assert out[1] == pytest.approx(ref[1], rel=1e-10)
    if iters == 30:  # converged at the top, then nudged outward past it
        ev = np.linalg.eigvalsh(s.toarray())
        assert ev[-1] <= out[1] <= 1.06 * ev[-1]


def test_lanczos_extremal_of_a_callable_and_a_breakdown(monkeypatch):
    # a diagonal operator with 6 distinct values: the Krylov space stops at 6,
    # so trailing Ritz values are the reference's spurious zeros
    d = np.repeat(np.arange(1.0, 7.0), 10)
    v0 = np.random.default_rng(3).standard_normal(d.size)
    _same_start(monkeypatch, v0)
    dj, dt = jnp.asarray(d, jnp.float32), torch.from_numpy(d).float()
    ref = jprecond.lanczos_extremal(lambda v: dj * v, d.size, iters=12)
    out = lanczos_extremal(lambda v: dt * v, d.size, iters=12, device="cpu")
    assert out == pytest.approx(ref, rel=1e-5, abs=1e-6)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_estimate_lmax_matches_the_reference(monkeypatch, dtype):
    s = (tconv.to_scipy(tgen.stencil_2d(16)) + sp.identity(256)).astype(dtype)
    j, t = _pair(s)
    v0 = np.random.default_rng(4).standard_normal(256).astype(np.float32)
    _same_start(monkeypatch, v0)
    ref = jprecond.estimate_lmax(j, 256, iters=25)
    out = estimate_lmax(t, 256, iters=25, device="cpu")
    assert out == pytest.approx(ref, rel=1e-5)


def test_the_start_vector_is_seeded_and_lands_where_asked():
    a = tprecond._start_vector(50, torch.float64, 7, "cpu")
    assert torch.equal(a, tprecond._start_vector(50, torch.float64, 7, "cpu"))
    assert not torch.equal(a, tprecond._start_vector(50, torch.float64, 8, "cpu"))
    s = tgen.stencil_2d(20)
    ev = np.linalg.eigvalsh(tconv.to_scipy(s).toarray())
    assert estimate_lmax(s, 400, iters=200, device="cpu") == pytest.approx(1.05 * ev[-1],
                                                                             rel=1e-2)
    lo, hi = lanczos_extremal(s.to("cpu"), 400, iters=40)
    assert 0 < lo < hi and ev[-1] <= hi <= 1.06 * ev[-1]


@pytest.mark.parametrize("degree", [1, 4, 8])
@pytest.mark.parametrize("inner", [None, "jacobi"])
def test_chebyshev_precond_apply_matches_the_reference(degree, inner):
    s = tconv.to_scipy(tgen.stencil_2d(14)) + 0.5 * sp.identity(196)
    j, t = _pair(s)
    jm = jprecond.jacobi(j) if inner else None
    tm = jacobi(t, device="cpu") if inner else None
    lo, hi = (0.5 / 4.5, 8.5 / 4.5) if inner else (0.5, 8.5)
    r = np.random.default_rng(degree).standard_normal(196)
    ref = np.asarray(jprecond.chebyshev_precond(j, lmin=lo, lmax=hi, degree=degree,
                                                M=jm)(jnp.asarray(r)))
    out = chebyshev_precond(t, lmin=lo, lmax=hi, degree=degree, M=tm)(torch.from_numpy(r))
    assert _rel(out.numpy(), ref) <= 1e-12


def test_preconditioned_cg_iterations_match_the_reference():
    # the preconditioners in the solve they serve: CG within one iteration
    s = tconv.to_scipy(tgen.stencil_2d(24)) + 0.05 * sp.identity(576)
    j, t = _pair(s)
    b = np.random.default_rng(5).standard_normal(576)
    for jm, tm in ((jprecond.block_jacobi(j, 24), block_jacobi(t, 24, device="cpu")),
                   (jprecond.chebyshev_precond(j, lmin=0.05, lmax=8.05, degree=6),
                    chebyshev_precond(t, lmin=0.05, lmax=8.05, degree=6))):
        ref = jkrylov.cg(j, b, tol=1e-10, maxiter=1000, M=jm)
        res = ct.solvers.cg(t, torch.from_numpy(b), tol=1e-10, maxiter=1000, M=tm)
        assert res.converged and abs(res.iterations - int(ref.iterations)) <= 1
        assert _rel(res.x.numpy(), ref.x) <= 1e-9
