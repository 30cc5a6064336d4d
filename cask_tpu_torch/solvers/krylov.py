"""Krylov solvers over device tensors: CG, block CG, pipelined CG,
BiCGStab, Chebyshev, MINRES, CGLS, GMRES(m) and mixed-precision iterative
refinement.

The PyTorch counterparts of :mod:`cask_tpu.solvers.krylov`: the same
recurrences and the same stopping rules.  The JAX package runs each loop
as one jitted ``lax.while_loop``; here it is a Python loop over tensors on
the device, with one host sync per iteration for the stopping test.

``a`` may be a port matrix (:func:`cask_tpu_torch.ops.spmv.spmv` or
:func:`cask_tpu_torch.ops.spmm.spmm` is used) or any callable
``x -> A@x``, such as a :class:`cask_tpu_torch.ops.bdia.BdiaOperator`.
``M`` is an optional preconditioner callable ``r -> M⁻¹r``.

An operator that carries a ``mesh`` (the ``padded_op`` of
:class:`cask_tpu_torch.parallel.DistSpmv` or ``Dist2DSpmv``) works on this
rank's shard of every vector: each inner product and norm is then summed
over the mesh with an ``all_reduce`` (:class:`_Dots`), which XLA does for
the reference when a ``vdot`` meets sharded arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from cask_tpu_torch.formats.matrix import BSR, COO, CSR
from cask_tpu_torch.ops.spmm import spmm
from cask_tpu_torch.ops.spmv import as_operand, spmv, transposed
from cask_tpu_torch.utils.platform import require_full_fp32


@dataclasses.dataclass
class SolveResult:
    x: torch.Tensor
    iterations: int
    residual_norm: float  # ||r||₂ at exit: the recurrence's, or the true one where a solver says so
    converged: bool


def _operator_and_rhs(a, b, product):
    """The operator ``v -> A@v`` (``product(a, v)`` for a matrix, ``a``
    itself for a callable) and ``b`` as a tensor.  A tensor ``b`` stays
    where it is (a CPU tensor asks for the CPU); host data goes to the
    matrix's or operator's device, else to the CUDA device, which raises
    without one (:func:`cask_tpu_torch.ops.spmv.as_operand`)."""
    op = a if callable(a) and not hasattr(a, "shape") else (lambda v: product(a, v))
    return op, as_operand(a, b)


def _ident(r):
    return r


class _Dots:
    """Inner products and norms of an operator's vectors: local
    (``torch.vdot``, ``vector_norm``) for an operator without a mesh, the
    sum over the mesh's ranks (one ``all_reduce`` each) for one with a mesh,
    whose vectors are this rank's shards."""

    def __init__(self, op):
        self.mesh = getattr(op, "mesh", None)

    def total(self, t: torch.Tensor) -> torch.Tensor:
        return t if self.mesh is None else self.mesh.all_reduce(t).wait()

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.total(torch.vdot(a, b))

    def gram(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``aᴴ b`` of two (n, s) blocks."""
        return self.total(a.mH @ b)

    def norm(self, v: torch.Tensor, dim=None) -> torch.Tensor:
        """‖v‖₂ (per column with ``dim=0``)."""
        if self.mesh is None:
            return torch.linalg.vector_norm(v, dim=dim)
        sq = (v.conj() * v).real
        return torch.sqrt(self.total(sq.sum() if dim is None else sq.sum(dim)))


def cg(a, b, *, x0=None, tol: float = 1e-8, atol: float = 0.0, maxiter: int = 1000,
       M: Optional[Callable] = None) -> SolveResult:
    """Conjugate gradients for SPD (or Hermitian positive definite) ``a``,
    optionally preconditioned.  A host (numpy) ``b`` is placed as in
    :func:`block_cg`."""
    op, b = _operator_and_rhs(a, b, spmv)
    dots = _Dots(op)
    M = M or _ident
    x = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0, device=b.device)

    # the threshold is real (a norm), also for a complex system
    target = torch.clamp(tol * dots.norm(b), min=atol)

    r = b - op(x)
    z = M(r)
    p = z
    rz = dots.dot(r, z)  # conjugates r: the Hermitian inner product
    k = 0
    while k < maxiter and bool(dots.norm(r) > target):
        ap = op(p)
        alpha = rz / dots.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = M(r)
        rz_new = dots.dot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        k += 1
    rn = dots.norm(r)
    return SolveResult(x=x, iterations=k, residual_norm=float(rn),
                       converged=bool(rn <= target))


def _solve_small(g: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """``g⁺ @ rhs``: the minimum-norm solve of the reference's ``lstsq``,
    singular values below ``eps·max(s, s)`` of the largest cut, so a Gram
    matrix gone rank-deficient as columns converge gives no NaN.  (On CUDA
    ``torch.linalg.lstsq`` has only the full-rank ``gels`` driver.)"""
    return torch.linalg.pinv(g) @ rhs


def block_cg(a, b, *, x0=None, tol: float = 1e-8, atol: float = 0.0,
             maxiter: int = 1000, M: Optional[Callable] = None) -> SolveResult:
    """Block CG (O'Leary 1980) for SPD (or Hermitian positive definite)
    ``a`` with ``s`` right-hand sides.

    ``b`` is (n, s).  All columns share one Krylov iteration: one SpMM per
    step (on a BDIA plan at s > 64 the slab kernel, the reference's wide-k
    route) and tiny (s, s) recurrence solves.  The loop runs while any
    column's ‖r‖ is above ``max(tol·‖b_j‖, atol)`` and ``k < maxiter``.
    ``residual_norm`` is the worst column's.  ``M`` must take (n, s)
    blocks (:func:`cask_tpu_torch.solvers.jacobi` does).

    A host (numpy) ``b`` goes to the matrix's or operator's device, or to
    the CUDA device for a plain callable or a matrix of host numpy arrays.
    The Gram and update
    products are ``torch.matmul`` in full FP32: on a CUDA float32 ``b`` it
    raises if ``torch.backends.cuda.matmul.allow_tf32`` is set, and it does
    not change that global setting."""
    op, b = _operator_and_rhs(a, b, spmm)
    dots = _Dots(op)
    M = M or _ident
    if b.ndim != 2:
        raise ValueError("block_cg expects b of shape (n, s); use cg for one RHS")
    require_full_fp32(b, "block_cg")
    x = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0, device=b.device)

    target = torch.clamp(tol * dots.norm(b, dim=0), min=atol)  # real
    r = b - op(x)
    z = M(r)
    p = z
    s = dots.gram(r, z)  # (s, s)
    k = 0
    while k < maxiter and bool(torch.any(dots.norm(r, dim=0) > target)):
        q = op(p)
        alpha = _solve_small(dots.gram(p, q), s)
        x = x + p @ alpha
        r = r - q @ alpha
        z = M(r)
        s_new = dots.gram(r, z)
        beta = _solve_small(s, s_new)
        p = z + p @ beta
        s = s_new
        k += 1
    rns = dots.norm(r, dim=0)
    return SolveResult(x=x, iterations=k, residual_norm=float(rns.max()),
                       converged=bool(torch.all(rns <= target)))


def _where0(v: torch.Tensor) -> torch.Tensor:
    """``v`` with a zero replaced by 1, the reference's ``where(v == 0, 1, v)``."""
    return torch.where(v == 0, torch.ones_like(v), v)


def pipelined_cg(a, b, *, x0=None, tol: float = 1e-8, atol: float = 0.0,
                 maxiter: int = 1000, M: Optional[Callable] = None) -> SolveResult:
    """Pipelined PCG (Ghysels & Vanroose 2014): both inner products of an
    iteration come from vectors known before its operator and
    preconditioner applications, so on a mesh the reduction overlaps them:
    the iteration's ‖r‖², γ and δ go out in one ``all_reduce``, issued
    before ``M`` and the product and waited on after them (the iteration
    that finds ‖r‖ small enough has then made one product for nothing).
    Without a mesh, one operator application an iteration, two before the
    loop and one after it: ``residual_norm`` and ``converged`` are the true
    residual ``b − A·x``'s, not the recurrence's, which drifts over long
    runs."""
    op, b = _operator_and_rhs(a, b, spmv)
    dots = _Dots(op)
    M = M or _ident
    x = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0, device=b.device)
    target = torch.clamp(tol * dots.norm(b), min=atol)

    r = b - op(x)
    u = M(r)
    w = op(u)
    z = torch.zeros_like(b)
    q = p = s = z
    gamma_old = alpha_old = torch.ones((), dtype=b.dtype, device=b.device)
    k = 0
    while k < maxiter:
        if dots.mesh is None:
            if not bool(torch.linalg.vector_norm(r) > target):
                break
            gamma, delta = torch.vdot(r, u), torch.vdot(w, u)
        else:
            sums = dots.mesh.all_reduce(torch.stack([torch.vdot(r, r), torch.vdot(r, u),
                                                     torch.vdot(w, u)]))
        m = M(w)
        n_ = op(m)
        if dots.mesh is not None:
            rr, gamma, delta = sums.wait()
            if not bool(torch.sqrt(rr.real) > target):
                break
        beta = torch.zeros_like(gamma) if k == 0 else gamma / gamma_old
        alpha = gamma / (delta - beta * gamma / alpha_old)
        z = n_ + beta * z
        q = m + beta * q
        p = u + beta * p
        s = w + beta * s
        x = x + alpha * p
        r = r - alpha * s
        u = u - alpha * q
        w = w - alpha * z
        gamma_old, alpha_old = gamma, alpha
        k += 1
    rn = dots.norm(b - op(x))
    return SolveResult(x=x, iterations=k, residual_norm=float(rn), converged=bool(rn <= target))


def bicgstab(a, b, *, x0=None, tol: float = 1e-8, atol: float = 0.0, maxiter: int = 1000,
             M: Optional[Callable] = None) -> SolveResult:
    """BiCGStab for general (nonsymmetric) ``a``: two operator and two
    preconditioner applications an iteration, the shadow residual
    ``r̂ = r₀``, inner products conjugating their first argument."""
    op, b = _operator_and_rhs(a, b, spmv)
    dots = _Dots(op)
    M = M or _ident
    x = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0, device=b.device)
    target = torch.clamp(tol * dots.norm(b), min=atol)

    r = b - op(x)
    rhat = r
    rho = alpha = omega = torch.ones((), dtype=b.dtype, device=b.device)
    v = p = torch.zeros_like(b)
    k = 0
    while k < maxiter and bool(dots.norm(r) > target):
        rho_new = dots.dot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        phat = M(p)
        v = op(phat)
        alpha = rho_new / dots.dot(rhat, v)
        s = r - alpha * v
        shat = M(s)
        t = op(shat)
        omega = dots.dot(t, s) / dots.dot(t, t)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
        k += 1
    rn = dots.norm(r)
    return SolveResult(x=x, iterations=k, residual_norm=float(rn), converged=bool(rn <= target))


def chebyshev(a, b, *, lmin: float, lmax: float, x0=None, tol: float = 1e-8,
              atol: float = 0.0, maxiter: int = 1000,
              M: Optional[Callable] = None) -> SolveResult:
    """Chebyshev iteration for SPD ``a`` with spectrum in ``[lmin, lmax]``
    (of ``M⁻¹A`` when ``M`` is given): no inner products, one operator
    application an iteration; ‖r‖ is tested every iteration like CG.  The
    scalar recurrence runs on the host in Python floats (the reference's
    are of ``b``'s type: the same numbers in f64)."""
    op, b = _operator_and_rhs(a, b, spmv)
    dots = _Dots(op)
    M = M or _ident
    x = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0, device=b.device)
    target = torch.clamp(tol * dots.norm(b), min=atol)

    theta = (lmax + lmin) / 2.0
    delta = (lmax - lmin) / 2.0
    r = b - op(x)
    alpha = 1.0 / theta
    d = M(r) * alpha
    k = 0
    while k < maxiter and bool(dots.norm(r) > target):
        x = x + d
        r = r - op(d)
        beta = (delta * alpha / 2.0) ** 2
        alpha_new = 1.0 / (theta - beta / alpha)
        d = alpha_new * (M(r) + beta * d / alpha)
        alpha = alpha_new
        k += 1
    rn = dots.norm(r)
    return SolveResult(x=x, iterations=k, residual_norm=float(rn), converged=bool(rn <= target))


def minres(a, b, *, x0=None, tol: float = 1e-8, atol: float = 0.0, maxiter: int = 1000,
           M: Optional[Callable] = None) -> SolveResult:
    """MINRES for symmetric (possibly indefinite) real ``a``: Lanczos with
    Givens QR, one operator and one preconditioner application an
    iteration.  ``M`` must be SPD.  The loop stops on the recurrence's
    residual estimate ``|η|`` (the M⁻¹-norm of the residual), which decides
    ``converged``; ``residual_norm`` is the true ‖b − A·x‖₂, one more
    operator application after the loop."""
    op, b = _operator_and_rhs(a, b, spmv)
    dots = _Dots(op)
    M = M or _ident
    x = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0, device=b.device)

    r0 = b - op(x)
    z = M(r0)
    gamma = torch.sqrt(torch.clamp(dots.dot(r0, z), min=0))
    target = torch.clamp(tol * gamma, min=atol)
    zeros = torch.zeros_like(b)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    nil = torch.zeros((), dtype=b.dtype, device=b.device)

    v_old, v = zeros, r0
    gamma_old, eta = one, gamma
    c_old = c = one
    s_old = s = nil
    w_old = w = zeros
    k = 0
    while k < maxiter and bool(torch.abs(eta) > target):
        zj = z / _where0(gamma)
        az = op(zj)
        delta = dots.dot(zj, az)
        v_new = az - (delta / _where0(gamma)) * v - (gamma / _where0(gamma_old)) * v_old
        z_new = M(v_new)
        gamma_new = torch.sqrt(torch.clamp(dots.dot(z_new, v_new), min=0))
        a0 = c * delta - c_old * s * gamma
        a1 = torch.sqrt(a0 * a0 + gamma_new * gamma_new)
        a2 = s * delta + c_old * c * gamma
        a3 = s_old * gamma
        a1s = _where0(a1)
        c_new = a0 / a1s
        s_new = gamma_new / a1s
        w_new = (zj - a3 * w_old - a2 * w) / a1s
        x = x + c_new * eta * w_new
        eta = -s_new * eta
        v_old, v, z = v, v_new, z_new
        gamma_old, gamma = gamma, gamma_new
        c_old, c, s_old, s = c, c_new, s, s_new
        w_old, w = w, w_new
        k += 1
    rn = dots.norm(b - op(x))
    return SolveResult(x=x, iterations=k, residual_norm=float(rn),
                       converged=bool(torch.abs(eta) <= target))


def cgls(a, b, *, at: Optional[Callable] = None, x0=None, tol: float = 1e-8,
         atol: float = 0.0, maxiter: int = 1000) -> SolveResult:
    """CGLS: least squares ``min ‖A x − b‖₂`` for rectangular ``a``, CG on
    ``AᵀA x = Aᵀb`` without forming ``AᵀA``: one product with A and one with
    Aᵀ an iteration.  A CSR, COO or BSR applies Aᵀ through
    ``spmv(a, v, transpose=True)``; a plan (DIA, BDIA, POH) builds
    :func:`~cask_tpu_torch.ops.spmv.transposed` once; a callable ``a``
    needs ``at`` (``v → Aᵀv``).  Convergence is on ‖Aᵀr‖ relative to
    ‖Aᵀb‖, and ``residual_norm`` is ‖Aᵀr‖."""
    if callable(a) and not hasattr(a, "shape"):
        if at is None:
            raise ValueError("cgls with a callable operator requires at= (x -> A^T x)")
        op, opt = a, at
    elif isinstance(a, (CSR, COO, BSR)):
        op = lambda v: spmv(a, v)  # noqa: E731
        opt = lambda v: spmv(a, v, transpose=True)  # noqa: E731
    else:
        a_t = transposed(a)  # plans: build Aᵀ once
        op = lambda v: spmv(a, v)  # noqa: E731
        opt = lambda v: spmv(a_t, v)  # noqa: E731
    b = as_operand(a, b)
    dots = _Dots(a)
    s = opt(b)
    x = torch.zeros_like(s) if x0 is None else torch.as_tensor(x0, device=b.device)
    target = torch.clamp(tol * dots.norm(s), min=atol)

    r = b - op(x)
    s = opt(r)
    p = s
    gamma = dots.dot(s, s)
    k = 0
    while k < maxiter and bool(torch.sqrt(gamma.real) > target):
        q = op(p)
        alpha = gamma / dots.dot(q, q)
        x = x + alpha * p
        r = r - alpha * q
        s = opt(r)
        gamma_new = dots.dot(s, s)
        p = s + (gamma_new / gamma) * p
        gamma = gamma_new
        k += 1
    rn = torch.sqrt(gamma.real)
    return SolveResult(x=x, iterations=k, residual_norm=float(rn), converged=bool(rn <= target))


def ir_solve(a, b, *, work_dtype=torch.float32, tol: float = 1e-12, atol: float = 0.0,
             maxiter: int = 20, inner: str = "cg", inner_tol: float = 1e-5,
             inner_maxiter: int = 300, M: Optional[Callable] = None) -> SolveResult:
    """Mixed-precision iterative refinement: each correction is solved in
    ``work_dtype`` (``inner``: ``"cg"``, ``"bicgstab"`` or ``"minres"``,
    over ``a.astype(work_dtype)``, with ``M`` built at that type), and the
    residual ``b − A·x`` is taken in ``b``'s precision each outer step.
    ``a`` must be a matrix or plan (a low-precision copy is made), not a
    callable.  ``iterations`` counts outer steps."""
    if callable(a) and not hasattr(a, "shape"):
        raise ValueError("ir_solve needs a matrix (it builds a low-precision copy)")
    b = as_operand(a, b)
    a_lo = a.astype(work_dtype)
    inner_fn = {"cg": cg, "bicgstab": bicgstab, "minres": minres}[inner]
    target = torch.clamp(tol * torch.linalg.vector_norm(b), min=atol)

    x = torch.zeros_like(b)
    r = b
    k = 0
    while k < maxiter and bool(torch.linalg.vector_norm(r) > target):
        d = inner_fn(a_lo, r.to(work_dtype), tol=inner_tol, maxiter=inner_maxiter, M=M).x
        x = x + d.to(b.dtype)
        r = b - spmv(a, x)
        k += 1
    rn = torch.linalg.vector_norm(r)
    return SolveResult(x=x, iterations=k, residual_norm=float(rn), converged=bool(rn <= target))


def gmres(a, b, *, x0=None, tol: float = 1e-8, atol: float = 0.0, restart: int = 32,
          maxiter: int = 50, M: Optional[Callable] = None) -> SolveResult:
    """Restarted GMRES(m) with left-preconditioned Arnoldi (modified
    Gram–Schmidt).  ``maxiter`` counts restarts.  The loop runs while
    ‖M(b − A·x)‖ is above ``max(tol·‖M(b)‖, atol)`` (one operator
    application a test), and ``converged`` compares the true ‖b − A·x‖ with
    ``max(tol·‖b‖, atol)``.  A cycle makes ``restart + 1`` operator
    applications; its small least-squares problem is solved by
    :func:`_solve_small` (a breakdown leaves H rank-deficient)."""
    op, b = _operator_and_rhs(a, b, spmv)
    dots = _Dots(op)
    M = M or _ident
    x = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0, device=b.device)
    m = restart
    target = torch.clamp(tol * dots.norm(M(b)), min=atol)

    def arnoldi_cycle(x):
        r = M(b - op(x))
        beta = dots.norm(r)
        V = b.new_zeros((m + 1, b.shape[0]))
        V[0] = r / _where0(beta)
        H = b.new_zeros((m + 1, m))
        for j in range(m):
            w = M(op(V[j]))
            for i in range(j + 1):  # the reference's masked scan over i ≤ j
                h = dots.dot(V[i], w)
                w = w - h * V[i]
                H[i, j] = h
            hnorm = dots.norm(w)
            H[j + 1, j] = hnorm
            V[j + 1] = w / _where0(hnorm)
        e1 = b.new_zeros(m + 1)
        e1[0] = beta
        return x + V[:m].T @ _solve_small(H, e1)

    k = 0
    while k < maxiter and bool(dots.norm(M(b - op(x))) > target):
        x = arnoldi_cycle(x)
        k += 1
    rn = dots.norm(b - op(x))
    done = rn <= torch.clamp(tol * dots.norm(b), min=atol)
    return SolveResult(x=x, iterations=k, residual_norm=float(rn), converged=bool(done))
