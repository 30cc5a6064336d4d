"""Preconditioners: Jacobi, IC(0) and SSOR.

The PyTorch counterparts of ``extract_diagonal``, ``jacobi``, ``ic0`` and
``ssor`` in :mod:`cask_tpu.solvers.precond`; ILU(0) lives in
:mod:`cask_tpu_torch.ops.ilu`.  Each is a callable ``r → M⁻¹r`` (or has an
``apply``) on the device, for the Krylov solvers.  IC(0) and SSOR apply
through the same level-scheduled triangular-solve plans as ILU(0), so on
the card each apply is a Python loop of small launches per level (about
2·√n levels for a 2-D stencil); IC(0)'s ``method='jacobi'`` apply is a
few DIA SpMV launches instead.  Block Jacobi and the Chebyshev
preconditioner are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cask_tpu_torch.formats.convert import coo_from_arrays, coo_to_csr, from_scipy, to_scipy
from cask_tpu_torch.formats.matrix import CSR, host, to_device
from cask_tpu_torch.ops.ilu import _split_lu, ilu0_lu
from cask_tpu_torch.ops.trisolve import TriSolvePlan, jacobi_trisolve_plan, trisolve_plan
from cask_tpu_torch.utils.platform import plan_device


def extract_diagonal(a: CSR) -> np.ndarray:
    indptr = host(a.indptr).astype(np.int64)
    indices = host(a.indices).astype(np.int64)
    data = host(a.data)
    n = min(a.shape)
    rows = np.repeat(np.arange(a.shape[0], dtype=np.int64), np.diff(indptr))
    on = (rows == indices) & (rows < n)
    d = np.zeros(n, dtype=data.dtype)
    d[rows[on]] = data[on]
    return d


def jacobi(a: CSR, *, device=None):
    """Diagonal (Jacobi) preconditioner: ``r → r / diag(A)``, with the
    inverse diagonal on ``device`` (default: where ``a``'s tensors are, the
    CUDA device for host numpy arrays)."""
    device = plan_device(a.data, device)
    d = extract_diagonal(a)
    if np.any(d == 0):
        raise ValueError("Jacobi preconditioner requires a nonzero diagonal")
    inv = torch.as_tensor(1.0 / d, device=device)

    def apply(r):
        if r.ndim == 1:
            return r * inv
        return r * inv[:, None]

    return apply


@dataclasses.dataclass(frozen=True, eq=False)
class IC0Factors:
    """IC(0) factor ``L_c`` with ``A ≈ L_c L_cᵀ`` (host numpy, ``l``) plus
    cached solve plans and each plan's values on the plans' device."""

    l: CSR  # lower-triangular Cholesky factor (diag included)  # noqa: E741
    _lower_plan: TriSolvePlan
    _upper_plan: TriSolvePlan
    _lower_data: torch.Tensor
    _upper_data: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self._lower_plan.device

    def apply(self, b, *, method: str = "levels", sweeps: int = 5) -> torch.Tensor:
        """Preconditioner solve ``x = L_c⁻ᵀ L_c⁻¹ b`` (symmetric).

        ``method='jacobi'`` uses sweep solves (see
        :meth:`cask_tpu_torch.ops.ilu.ILU0Factors.apply`)."""
        if method == "jacobi":
            lp, up = self._jacobi_plans()
            return up.solve(lp.solve(b, sweeps=sweeps), sweeps=sweeps)
        y = self._lower_plan.solve(self._lower_data, b)
        return self._upper_plan.solve(self._upper_data, y)

    def jacobi_applier(self, sweeps: int = 5):
        """``r → M⁻¹r`` via Jacobi–Richardson sweep solves."""
        lp, up = self._jacobi_plans()
        return lambda r: up.solve(lp.solve(r, sweeps=sweeps), sweeps=sweeps)

    def _jacobi_plans(self):
        cached = getattr(self, "_jacobi_cache", None)
        if cached is None:
            lct = from_scipy(to_scipy(self.l).T.tocsr())
            cached = (jacobi_trisolve_plan(self.l, lower=True, unit_diag=False,
                                           device=self.device),
                      jacobi_trisolve_plan(lct, lower=False, unit_diag=False,
                                           device=self.device))
            object.__setattr__(self, "_jacobi_cache", cached)
        return cached


def ic0(a: CSR, *, device=None) -> IC0Factors:
    """Incomplete Cholesky IC(0) for SPD ``a`` with a symmetric pattern.

    Built through the identity that ILU(0) on a symmetric matrix/pattern
    yields ``U = D Lᵀ``, hence ``L_c = L D^{1/2}`` satisfies ``A ≈ L_c L_cᵀ``
    on A's pattern.  Unlike raw ILU(0) the ``apply`` is a *symmetric*
    operator, the form CG requires of ``M``, at the cost of the ILU(0)
    apply.  Raises if a pivot is nonpositive (not SPD on its own pattern):
    fall back to :func:`cask_tpu_torch.ops.ilu.ilu0` then.  The plans and
    values go to ``device`` (default: where ``a``'s tensors are, the CUDA
    device for host numpy arrays)."""
    device = plan_device(a.data, device)
    low, up = _split_lu(ilu0_lu(a))  # L has an explicit unit diagonal; U carries D
    d = extract_diagonal(up)
    if np.any(d <= 0):
        raise ValueError("IC(0): nonpositive pivot — matrix is not SPD on its own pattern")
    sq = np.sqrt(d)
    lc = CSR(data=host(low.data) * sq[host(low.indices).astype(np.int64)],
             indices=low.indices, indptr=low.indptr, shape=low.shape)
    lct = from_scipy(to_scipy(lc).T.tocsr())  # host planning only
    return IC0Factors(l=lc,
                      _lower_plan=trisolve_plan(lc, lower=True, unit_diag=False, device=device),
                      _upper_plan=trisolve_plan(lct, lower=False, unit_diag=False,
                                                device=device),
                      _lower_data=to_device(lc.data, device),
                      _upper_data=to_device(lct.data, device))


def ssor(a: CSR, omega: float = 1.0, *, device=None):
    """SSOR preconditioner ``M = (D+ωL) D⁻¹ (D+ωU) / (ω(2−ω))``.

    Factorization-free (A's own triangles, so it never breaks down where
    ILU can), symmetric for symmetric A; ω ∈ (0, 2), ω = 1 giving
    symmetric Gauss–Seidel.  The apply is two level-scheduled triangular
    sweeps plus a diagonal scale, on ``device`` as :func:`ic0`."""
    if not 0.0 < omega < 2.0:
        raise ValueError("SSOR requires 0 < omega < 2")
    device = plan_device(a.data, device)
    indptr = host(a.indptr).astype(np.int64)
    indices = host(a.indices).astype(np.int64)
    data = host(a.data)
    n = a.shape[0]
    d = extract_diagonal(a)
    if np.any(d == 0):
        raise ValueError("SSOR requires a nonzero diagonal")
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    diag_idx = np.arange(n, dtype=np.int64)

    def tri(strict_mask):
        r = np.concatenate([rows[strict_mask], diag_idx])
        c = np.concatenate([indices[strict_mask], diag_idx])
        v = np.concatenate([omega * data[strict_mask], d])
        return coo_to_csr(coo_from_arrays(v, r, c, a.shape), sum_duplicates=False)

    low = tri(indices < rows)
    up = tri(indices > rows)
    lowplan = trisolve_plan(low, lower=True, unit_diag=False, device=device)
    upplan = trisolve_plan(up, lower=False, unit_diag=False, device=device)
    low_data = to_device(low.data, device)
    up_data = to_device(up.data, device)
    dj = torch.as_tensor(d, device=device)
    scale = omega * (2.0 - omega)

    def apply(r):
        y = lowplan.solve(low_data, r)
        y = y * dj if y.ndim == 1 else y * dj[:, None]
        return scale * upplan.solve(up_data, y)

    return apply
