"""The port's block CG against the JAX package's, on the CPU, at f64; and the
wide-k slice as a whole.

Systems: the 5-point stencil (SPD) as a CSR, and the FEM SPD block system
built as on the card (S = A + Aᵀ, ``_diag_shift(S, 1.1)``, blocked (4, 4),
as tests/test_torch_cg.py builds it) through its BDIA plan.  Iterations
agree within ±1 and x within 1e-9 relative.
"""

import jax  # noqa: F401  (kept on the CPU with x64 by conftest)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cask_tpu.formats.convert as jconv
import cask_tpu.formats.generate as jgen
import cask_tpu.ops.bdia as jbdia
import cask_tpu.ops.pallas.bdia_slab as jslab
import cask_tpu.solvers.krylov as jkrylov
import cask_tpu.solvers.precond as jprecond
import cask_tpu_torch as ct
import cask_tpu_torch.formats.convert as tconv
import cask_tpu_torch.formats.generate as tgen
from cask_tpu.ops.spmm import spmm as jax_spmm
from cask_tpu_torch.ops.bdia_slab import bdia_slab_plan
from cask_tpu_torch.solvers import block_cg, jacobi


def _relerr(y, ref):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(y - ref) / np.linalg.norm(ref)


def _spd_blocks(nx, dof=4):
    """(reference BSR, port BSR, port CSR) of the FEM SPD block system."""
    a = tconv.to_scipy(tgen.fem_blocks(nx, dof=dof))
    s_t = tgen._diag_shift(tconv.from_scipy((a + a.T).tocsr()), 1.1)
    s_j = jgen._diag_shift(jconv.from_scipy((a + a.T).tocsr()), 1.1)
    return jconv.csr_to_bsr(s_j, (dof, dof)), tconv.csr_to_bsr(s_t, (dof, dof)), s_t


def _system(name):
    """(reference operand, port operand, reference CSR, port CSR)."""
    if name == "stencil":
        j, t = jgen.stencil_2d(12), tgen.stencil_2d(12).to("cpu")
        return j, t, j, t
    sj, st, s_csr = _spd_blocks(8)
    return (jbdia.bdia_plan(sj), ct.bdia_plan(st, device="cpu"), jconv.bsr_to_csr(sj),
            s_csr)


def _B(n, s, seed=0):
    return np.random.default_rng(seed).standard_normal((n, s))


@pytest.mark.parametrize("name", ["stencil", "fem_blocks"])
@pytest.mark.parametrize("s", [1, 4, 8])
@pytest.mark.parametrize("precond", [False, True])
def test_matches_the_reference(name, s, precond):
    j, t, j_csr, t_csr = _system(name)
    b = _B(t.shape[0], s, seed=s)
    M_j = jprecond.jacobi(j_csr) if precond else None
    M_t = jacobi(t_csr, device="cpu") if precond else None
    ref = jkrylov.block_cg(j, jnp.asarray(b), tol=1e-10, maxiter=300, M=M_j)
    res = block_cg(t, torch.from_numpy(b), tol=1e-10, maxiter=300, M=M_t)
    assert res.converged and bool(ref.converged)
    assert abs(res.iterations - int(ref.iterations)) <= 1
    assert _relerr(res.x, np.asarray(ref.x)) <= 1e-9
    s_sp = tconv.to_scipy(t_csr)
    assert np.linalg.norm(b - s_sp @ res.x.numpy()) / np.linalg.norm(b) <= 1e-9


def test_rank_deficient_block_gives_no_nan():
    # two equal columns: the (s, s) Gram matrices are singular from the start;
    # the pseudo-inverse solve keeps the iteration finite, as lstsq does
    _, t, _, t_csr = _system("fem_blocks")
    j, _, _, _ = _system("fem_blocks")
    b = _B(t.shape[0], 4, seed=9)
    b[:, 2] = b[:, 0]
    ref = jkrylov.block_cg(j, jnp.asarray(b), tol=1e-10, maxiter=300)
    res = block_cg(t, torch.from_numpy(b), tol=1e-10, maxiter=300)
    assert torch.isfinite(res.x).all() and res.converged and bool(ref.converged)
    assert abs(res.iterations - int(ref.iterations)) <= 1
    assert _relerr(res.x, np.asarray(ref.x)) <= 1e-9
    assert torch.equal(res.x[:, 0], res.x[:, 2])


def test_rejects_a_vector_and_reports_the_worst_column():
    _, t, _, _ = _system("stencil")
    with pytest.raises(ValueError, match="cg"):
        block_cg(t, torch.ones(t.shape[0], dtype=torch.float64))
    b = torch.from_numpy(_B(t.shape[0], 3, seed=4))
    res = block_cg(t, b, tol=1e-12, maxiter=2)
    assert res.iterations == 2 and res.converged is False
    worst = float(torch.linalg.vector_norm(b - ct.spmm(t, res.x), dim=0).max())
    assert abs(res.residual_norm - worst) <= 1e-8 * worst
    # a callable operator and atol above every column's norm
    res = block_cg(lambda v: ct.spmm(t, v), b, atol=1e3)
    assert res.iterations == 0 and res.converged is True


def test_host_rhs_follows_the_matrix():
    # a numpy b goes to the matrix's device (here the CPU, where its tensors are)
    _, t, _, _ = _system("stencil")
    b = _B(t.shape[0], 2, seed=5)
    res = block_cg(t, b, tol=1e-10)
    assert res.x.device.type == "cpu" and res.converged


def test_slice_end_to_end_on_cpu():
    # generator -> BSR -> spmm(method="slab") -> slab plan -> block CG over
    # the slab operand, all in the port, against the reference
    a_t = ct.generate.fem_blocks(16, dof=4, return_bsr=True)
    a_j = jgen.fem_blocks(16, dof=4, return_bsr=True)
    x = _B(a_t.shape[1], 80, seed=6)
    y = ct.spmm(a_t, torch.from_numpy(x), method="slab")
    y_ref = np.asarray(jax_spmm(jbdia.bdia_plan(a_j), jnp.asarray(x), method="slab"))
    assert _relerr(y, y_ref) <= 1e-12
    assert _relerr(y, jconv.to_scipy(a_j) @ x) <= 1e-12
    sj, st, s_csr = _spd_blocks(16)
    sl_t = bdia_slab_plan(ct.bdia_plan(st, device="cpu"), 16)
    sl_j = jslab.bdia_slab_plan(jbdia.bdia_plan(sj), 16)
    b = _B(st.shape[0], 4, seed=7)
    ref = jkrylov.block_cg(sl_j, jnp.asarray(b), tol=1e-8, maxiter=100)
    res = block_cg(sl_t, torch.from_numpy(b), tol=1e-8, maxiter=100)
    assert res.converged and bool(ref.converged)
    assert abs(res.iterations - int(ref.iterations)) <= 1
    assert _relerr(res.x, np.asarray(ref.x)) <= 1e-9
    s_sp = tconv.to_scipy(s_csr)
    assert np.linalg.norm(b - s_sp @ res.x.numpy()) / np.linalg.norm(b) <= 1e-7
