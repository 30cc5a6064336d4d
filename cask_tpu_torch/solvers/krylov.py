"""Conjugate gradients over device tensors.

The PyTorch counterpart of ``cg`` in :mod:`cask_tpu.solvers.krylov`: the
same recurrences and the same stopping rule (``‖r‖ > max(tol·‖b‖, atol)``
and ``k < maxiter``).  The JAX package runs the loop as one jitted
``lax.while_loop``; here it is a Python loop over tensors on the device,
with one host sync per iteration for the stopping test.

``a`` may be a port matrix (:func:`cask_tpu_torch.ops.spmv.spmv` is used)
or any callable ``x -> A@x``, such as a
:class:`cask_tpu_torch.ops.bdia.BdiaOperator`.  ``M`` is an optional
preconditioner callable ``r -> M⁻¹r``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from cask_tpu_torch.ops.spmv import spmv


@dataclasses.dataclass
class SolveResult:
    x: torch.Tensor
    iterations: int
    residual_norm: float  # ||r||₂ of the recurrence residual at exit
    converged: bool


def _as_operator(a) -> Callable:
    if callable(a) and not hasattr(a, "shape"):
        return a
    return lambda v: spmv(a, v)


def _ident(r):
    return r


def cg(a, b, *, x0=None, tol: float = 1e-8, atol: float = 0.0, maxiter: int = 1000,
       M: Optional[Callable] = None) -> SolveResult:
    """Conjugate gradients for SPD ``a`` (optionally preconditioned)."""
    op = _as_operator(a)
    M = M or _ident
    b = torch.as_tensor(b)
    x = torch.zeros_like(b) if x0 is None else torch.as_tensor(x0, device=b.device)

    bnorm = torch.linalg.vector_norm(b)
    target = torch.clamp(tol * bnorm, min=atol).to(b.dtype)

    r = b - op(x)
    z = M(r)
    p = z
    rz = torch.dot(r, z)
    k = 0
    while k < maxiter and bool(torch.linalg.vector_norm(r) > target):
        ap = op(p)
        alpha = rz / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = M(r)
        rz_new = torch.dot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        k += 1
    rn = torch.linalg.vector_norm(r)
    return SolveResult(x=x, iterations=k, residual_norm=float(rn),
                       converged=bool(rn <= target))
