"""Bandwidth-reducing reordering (reverse Cuthill–McKee).

The PyTorch counterpart of :mod:`cask_tpu.formats.reorder`, numpy only.
The DIA kernels win where the referenced columns cluster near the
diagonal; RCM makes that locality for a matrix whose natural ordering
lacks it.  The BFS runs in the port's native core
(:mod:`cask_tpu_torch.native`), or in Python where the core is not built;
both give the JAX package's permutation.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from cask_tpu_torch.formats.convert import coo_from_arrays, coo_to_csr, csr_to_coo
from cask_tpu_torch.formats.matrix import CSR, host


def _symmetrize_pattern(a: CSR) -> CSR:
    """The pattern of ``A + Aᵀ`` as a CSR of counts (the reference sums a
    one per stored entry of either), built from one sort of the (row, col)
    keys: the same arrays as the reference's COO round trip, without its
    lexsort of twice the entries."""
    m, n = a.shape
    indptr = host(a.indptr).astype(np.int64)
    r = np.repeat(np.arange(m, dtype=np.int64), np.diff(indptr))
    c = host(a.indices).astype(np.int64)
    key, counts = np.unique(np.concatenate([r * n + c, c * n + r]), return_counts=True)
    rows = key // n
    out_ptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=m), out=out_ptr[1:])
    return CSR(data=counts.astype(np.float64), indices=(key % n).astype(np.int32),
               indptr=out_ptr.astype(np.int32), shape=a.shape)


def _rcm_python(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    from collections import deque

    n = indptr.shape[0] - 1
    deg = np.diff(indptr)
    seen = np.zeros(n, dtype=bool)
    order = []
    remaining = np.argsort(deg, kind="stable")
    ri = 0
    while len(order) < n:
        while ri < len(remaining) and seen[remaining[ri]]:
            ri += 1
        seed = remaining[ri]
        seen[seed] = True
        q = deque([seed])
        while q:
            u = q.popleft()
            order.append(u)
            nbrs = indices[indptr[u] : indptr[u + 1]]
            nbrs = nbrs[~seen[nbrs]]
            seen[nbrs] = True
            for v in nbrs[np.argsort(deg[nbrs], kind="stable")]:
                q.append(int(v))
    return np.asarray(order[::-1], dtype=np.int32)


def rcm_permutation(a: CSR) -> np.ndarray:
    """perm[new] = old, on the symmetrized pattern of ``a`` (square)."""
    if a.shape[0] != a.shape[1]:
        raise ValueError("RCM needs a square matrix")
    sym = _symmetrize_pattern(a)
    indptr = np.asarray(sym.indptr, dtype=np.int32)
    indices = np.asarray(sym.indices, dtype=np.int32)
    from cask_tpu_torch.native import NativeUnavailable
    from cask_tpu_torch.native import binding as nat

    try:
        return nat.rcm(indptr, indices)
    except NativeUnavailable:
        return _rcm_python(indptr.astype(np.int64), indices.astype(np.int64))


def permute_symmetric(a: CSR, perm: np.ndarray) -> CSR:
    """Return P A Pᵀ where perm[new] = old (rows and columns relabeled)."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
    coo = csr_to_coo(a)
    r = inv[np.asarray(coo.row)]
    c = inv[np.asarray(coo.col)]
    return coo_to_csr(coo_from_arrays(np.asarray(coo.data), r, c, a.shape))


def reorder_rcm(a: CSR) -> Tuple[CSR, np.ndarray]:
    """RCM-reorder ``a``; returns (P A Pᵀ, perm) with perm[new] = old.

    To use: solve with the reordered matrix and permute vectors with
    ``x_new = x[perm]`` / ``y = y_new[inv]``.
    """
    perm = rcm_permutation(a)
    return permute_symmetric(a, perm), perm


def bandwidth(a: CSR) -> int:
    """Max |i - j| over stored entries (what sets the DIA kernel's span)."""
    indptr = host(a.indptr).astype(np.int64)
    indices = host(a.indices).astype(np.int64)
    rows = np.repeat(np.arange(a.shape[0], dtype=np.int64), np.diff(indptr))
    return int(np.abs(rows - indices).max(initial=0))
