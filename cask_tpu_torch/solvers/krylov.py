"""Conjugate gradients and block CG over device tensors.

The PyTorch counterparts of ``cg`` and ``block_cg`` in
:mod:`cask_tpu.solvers.krylov`: the same recurrences and the same stopping
rules.  The JAX package runs each loop as one jitted ``lax.while_loop``;
here it is a Python loop over tensors on the device, with one host sync
per iteration for the stopping test.

``a`` may be a port matrix (:func:`cask_tpu_torch.ops.spmv.spmv` or
:func:`cask_tpu_torch.ops.spmm.spmm` is used) or any callable
``x -> A@x``, such as a :class:`cask_tpu_torch.ops.bdia.BdiaOperator`.
``M`` is an optional preconditioner callable ``r -> M⁻¹r``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from cask_tpu_torch.ops.spmm import spmm
from cask_tpu_torch.ops.spmv import as_operand, spmv


@dataclasses.dataclass
class SolveResult:
    x: torch.Tensor
    iterations: int
    residual_norm: float  # ||r||₂ of the recurrence residual at exit
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


def cg(a, b, *, x0=None, tol: float = 1e-8, atol: float = 0.0, maxiter: int = 1000,
       M: Optional[Callable] = None) -> SolveResult:
    """Conjugate gradients for SPD (or Hermitian positive definite) ``a``,
    optionally preconditioned.  A host (numpy) ``b`` is placed as in
    :func:`block_cg`."""
    op, b = _operator_and_rhs(a, b, spmv)
    M = M or _ident
    x = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0, device=b.device)

    # the threshold is real (a norm), also for a complex system
    target = torch.clamp(tol * torch.linalg.vector_norm(b), min=atol)

    r = b - op(x)
    z = M(r)
    p = z
    rz = torch.vdot(r, z)  # conjugates r: the Hermitian inner product
    k = 0
    while k < maxiter and bool(torch.linalg.vector_norm(r) > target):
        ap = op(p)
        alpha = rz / torch.vdot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = M(r)
        rz_new = torch.vdot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        k += 1
    rn = torch.linalg.vector_norm(r)
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
    M = M or _ident
    if b.ndim != 2:
        raise ValueError("block_cg expects b of shape (n, s); use cg for one RHS")
    if b.is_cuda and b.dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("block_cg needs full-FP32 products, but "
                           "torch.backends.cuda.matmul.allow_tf32 is set")
    x = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0, device=b.device)

    target = torch.clamp(tol * torch.linalg.vector_norm(b, dim=0), min=atol)  # real
    r = b - op(x)
    z = M(r)
    p = z
    s = r.mH @ z  # (s, s)
    k = 0
    while k < maxiter and bool(torch.any(torch.linalg.vector_norm(r, dim=0) > target)):
        q = op(p)
        alpha = _solve_small(p.mH @ q, s)
        x = x + p @ alpha
        r = r - q @ alpha
        z = M(r)
        s_new = r.mH @ z
        beta = _solve_small(s, s_new)
        p = z + p @ beta
        s = s_new
        k += 1
    rns = torch.linalg.vector_norm(r, dim=0)
    return SolveResult(x=x, iterations=k, residual_norm=float(rns.max()),
                       converged=bool(torch.all(rns <= target)))
