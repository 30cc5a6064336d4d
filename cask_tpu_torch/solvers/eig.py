"""LOBPCG: locally optimal block preconditioned conjugate gradients, the
eigensolver for a few extremal eigenpairs of a real symmetric positive
definite operator.

The PyTorch counterpart of :mod:`cask_tpu.solvers.eig`: the same iteration,
basis whitening and stopping rule.  One block product ``A·W`` an iteration,
through :func:`cask_tpu_torch.ops.spmm.spmm` (on a banded matrix at k ≤ 64
the DIA SpMM kernel); ``A·X`` and ``A·P`` are recovered as combinations of
the block products already made.  The small (3k, 3k) Rayleigh–Ritz
problems are ``torch.linalg`` calls (cuSOLVER on the card), as the
reference computes them outside any kernel of its own.  Directions the
overlap matrix shows degenerate (the first iteration's empty P block,
converged residuals) are pushed out of the Ritz window with a ±``_PENALTY``
diagonal instead of a change of shape.  Real only: the reference uses
``.T``, not the conjugate transpose.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from cask_tpu_torch.ops.spmm import spmm
from cask_tpu_torch.ops.spmv import as_operand
from cask_tpu_torch.utils.platform import require_full_fp32

_PENALTY = 1e30


@dataclasses.dataclass
class EigResult:
    theta: torch.Tensor  # (k,) Ritz values, ascending
    x: torch.Tensor  # (n, k) Ritz vectors
    iterations: int
    residual_norm: float  # max_i ‖A xᵢ − θᵢ xᵢ‖₂ at exit
    converged: bool


def _eigh(a: torch.Tensor):
    """``eigh`` of the symmetric part of ``a``: ``jnp.linalg.eigh``
    symmetrizes its input, ``torch.linalg.eigh`` reads one triangle."""
    return torch.linalg.eigh(0.5 * (a + a.T))


def lobpcg(a, x0, *, largest: bool = False, tol: float = 1e-6,
           maxiter: int = 200, M: Optional[Callable] = None) -> EigResult:
    """The ``k`` smallest (or largest) eigenpairs of real SPD ``a``.

    ``x0`` is the (n, k) start block; its column count fixes ``k`` and
    ``3k < n``.  ``a`` is a port matrix or plan (``spmm``) or a callable
    ``V → A @ V`` over (n, k) blocks; ``M`` an optional preconditioner
    ``R → T R`` with ``T ≈ A⁻¹`` (e.g. :func:`~cask_tpu_torch.solvers.ic0`'s
    ``apply`` or an AMG V-cycle), which speeds the smallest eigenpairs.
    A host (numpy) ``x0`` goes to the matrix's or operator's device, else
    to the CUDA device.  The Gram products are full FP32 on the card: a
    CUDA float32 block raises under ``allow_tf32``.

    Convergence: ``‖A xᵢ − θᵢ xᵢ‖ ≤ tol · max(1, |θᵢ|)`` for all i, tested
    every iteration (one host sync); ``residual_norm`` comes from one more
    block product at exit."""
    op = a if callable(a) and not hasattr(a, "shape") else (lambda v: spmm(a, v))
    M = M or (lambda r: r)
    x0 = as_operand(a, x0)
    if x0.ndim != 2:
        raise ValueError("lobpcg expects x0 of shape (n, k)")
    n, k = x0.shape
    if 3 * k >= n:
        raise ValueError(f"lobpcg basis 3k={3 * k} must be < n={n}; shrink the block")
    require_full_fp32(x0, "lobpcg")
    eps = torch.finfo(x0.dtype).eps

    def residual(xb, axb, th):
        return axb - xb * th[None, :]

    def targets(th):
        return tol * torch.clamp(torch.abs(th), min=1.0)

    xb, _ = torch.linalg.qr(x0)
    axb = op(xb)
    th = torch.sum(xb * axb, dim=0)  # Rayleigh quotients of orthonormal X
    pb = apb = torch.zeros_like(xb)
    it = 0
    while it < maxiter and bool(torch.any(
            torch.linalg.vector_norm(residual(xb, axb, th), dim=0) > targets(th))):
        w = M(residual(xb, axb, th))
        aw = op(w)
        s = torch.cat([xb, w, pb], dim=1)  # (n, 3k)
        a_s = torch.cat([axb, aw, apb], dim=1)

        o = s.T @ s
        g = s.T @ a_s
        g = 0.5 * (g + g.T)

        # pseudo-inverse whitening of the basis: drop degenerate directions
        ow, ov = _eigh(o)
        keep = ow > (3 * k) * eps * torch.max(torch.abs(ow))
        inv_sqrt = torch.where(keep, 1.0 / torch.sqrt(torch.where(keep, ow, torch.ones_like(ow))),
                               torch.zeros_like(ow))
        wh = ov * inv_sqrt[None, :]  # columns: whitened basis coordinates
        g2 = wh.T @ g @ wh
        # dropped directions get Ritz values at ±∞, outside the window
        pen = torch.where(keep, torch.zeros_like(ow),
                          torch.full_like(ow, -_PENALTY if largest else _PENALTY))
        ritz, y = _eigh(g2 + torch.diag(pen))  # ascending
        if largest:
            th = ritz[2 * k:].flip(0)
            yk = y[:, 2 * k:].flip(1)
        else:
            th = ritz[:k]
            yk = y[:, :k]

        c = wh @ yk  # coordinates of the new X in the S basis, (3k, k)
        xb = s @ c
        axb = a_s @ c
        # conjugate direction: the same combination less its X-block part
        cp = c.clone()
        cp[:k, :] = 0.0
        pb = s @ cp
        apb = a_s @ cp
        pn = torch.linalg.vector_norm(pb, dim=0)
        scale = torch.where(pn > 0, 1.0 / torch.where(pn > 0, pn, torch.ones_like(pn)),
                            torch.zeros_like(pn))
        pb = pb * scale[None, :]
        apb = apb * scale[None, :]
        it += 1
    order = torch.argsort(th)
    th = th[order]
    xb = xb[:, order]
    # A·X in the loop is a combination of earlier products and carries their
    # round-off: apply the operator once more for a true residual
    rn = torch.linalg.vector_norm(residual(xb, op(xb), th), dim=0)
    return EigResult(theta=th, x=xb, iterations=it, residual_norm=float(torch.max(rn)),
                     converged=bool(torch.all(rn <= targets(th))))
