"""Preconditioners: the diagonal (Jacobi) one.

The PyTorch counterpart of ``extract_diagonal`` and ``jacobi`` in
:mod:`cask_tpu.solvers.precond`.  The others (block Jacobi, IC(0), SSOR,
Chebyshev, ILU) are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from cask_tpu_torch.formats.matrix import CSR, host


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
    inverse diagonal on ``device`` (default: where ``a``'s arrays are)."""
    if device is None:
        device = a.data.device if isinstance(a.data, torch.Tensor) else "cpu"
    d = extract_diagonal(a)
    if np.any(d == 0):
        raise ValueError("Jacobi preconditioner requires a nonzero diagonal")
    inv = torch.as_tensor(1.0 / d, device=device)

    def apply(r):
        if r.ndim == 1:
            return r * inv
        return r * inv[:, None]

    return apply
