"""Structural checks of matrices, packed plans and partitions, and a
non-finite tripwire.

The PyTorch counterparts of :mod:`cask_tpu.utils.debug`: each check runs on
host copies and raises the reference's exception on the same bad input.
Call them in tests or before long runs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cask_tpu_torch.formats.matrix import host


def check_csr(a) -> None:
    """Index bounds and ``indptr`` monotonicity (the gather's bounds)."""
    indptr = host(a.indptr)
    indices = host(a.indices)
    m, n = a.shape
    if indptr.shape[0] != m + 1:
        raise AssertionError(f"indptr length {indptr.shape[0]} != m+1 ({m + 1})")
    if indptr[0] != 0 or indptr[-1] != indices.shape[0]:
        raise AssertionError("indptr endpoints corrupt")
    if np.any(np.diff(indptr) < 0):
        raise AssertionError("indptr not monotone")
    if indices.size and (indices.min() < 0 or indices.max() >= n):
        raise AssertionError("column index out of bounds")


def check_permutation(perm) -> None:
    perm = host(perm)
    if not np.array_equal(np.sort(perm), np.arange(perm.shape[0])):
        raise AssertionError("not a permutation")


def nan_guard(fn):
    """Wrap an op so that a non-finite value in its output (the first
    element of a tuple) raises ``FloatingPointError``.  Debug only: the
    check syncs with the device once a call."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        first = out[0] if isinstance(out, tuple) else out
        finite = (bool(torch.isfinite(first).all()) if isinstance(first, torch.Tensor)
                  else bool(np.all(np.isfinite(host(first)))))
        if not finite:
            raise FloatingPointError(f"{fn.__name__}: non-finite output")
        return out

    return wrapped


def check_poh(p, a=None) -> None:
    """Validate a :class:`cask_tpu_torch.ops.poh.PohMatrix` pack's structural
    invariants; if the source CSR ``a`` is given, also verify that the pack
    reconstructs it exactly.  (The reference also checks ``rloc_t``, which
    the port's plan does not carry.)"""
    m, n = p.shape
    C, R = p.col_window, p.row_panel
    cloc = host(p.cloc)
    rloc = host(p.rloc)
    vals = host(p.vals)
    wlo = host(p.wlo)
    panel = host(p.panel)
    first = host(p.first)
    last = host(p.last)
    if not ((cloc >= 0).all() and (cloc < 2 * C).all()):
        raise AssertionError("POH: local column out of the 2C window")
    if not ((rloc >= 0).all() and (rloc < R).all()):
        raise AssertionError("POH: local row out of the panel")
    if (np.diff(panel) < 0).any():
        raise AssertionError("POH: panel indices must be non-decreasing")
    for I in range(p.n_panels):
        sel = np.nonzero(panel == I)[0]
        if sel.size == 0:
            raise AssertionError(f"POH: panel {I} has no tiles (never written)")
        if first[sel[0]] != 1 or last[sel[-1]] != 1:
            raise AssertionError(f"POH: panel {I} first/last flags wrong")
    if a is not None:
        import scipy.sparse as sp

        from cask_tpu_torch.formats.convert import to_scipy

        g_row = (panel[:, None, None].astype(np.int64) * R + rloc).reshape(-1)
        g_col = (wlo[:, None, None].astype(np.int64) * C + cloc).reshape(-1)
        v = vals.reshape(-1)
        nz = v != 0
        got = sp.coo_matrix(
            (v[nz], (g_row[nz], g_col[nz])), shape=(p.n_panels * R, (p.nseg + 1) * C)
        ).tocsr()[:m, :n]
        if abs(got - to_scipy(a).tocsr()).max() != 0:
            raise AssertionError("POH: pack does not reconstruct the matrix")


def check_partition(plan) -> None:
    """:class:`~cask_tpu_torch.parallel.CooPartition` /
    :class:`~cask_tpu_torch.parallel.DiaPartition` invariants: every index in
    range, structural zeros where claimed (a DIA remainder is checked as a
    COO partition)."""
    from cask_tpu_torch.parallel.partition import CooPartition, DiaPartition

    if isinstance(plan, DiaPartition):
        vals = np.asarray(plan.vals)
        P, _, mloc = vals.shape
        if P != plan.nshards or mloc != plan.mloc:
            raise AssertionError("DiaPartition shape metadata mismatch")
        rows = np.arange(P * mloc)
        for d, off in enumerate(plan.offsets):
            if abs(off) > plan.mloc:
                raise AssertionError(f"offset {off} wider than a shard ({plan.mloc})")
            # entries whose global column falls outside [0, n) must be 0
            cols = rows + off
            bad = (cols < 0) | (cols >= plan.shape[1]) | (rows >= plan.shape[0])
            if np.any(vals[:, d, :].reshape(-1)[bad] != 0):
                raise AssertionError(f"nonzero out-of-range entry on diagonal {off}")
        if plan.remainder is not None:
            check_partition(plan.remainder)
        return
    if isinstance(plan, CooPartition):
        mloc = plan.mloc
        for name in ("int_row", "ext_row"):
            r = np.asarray(getattr(plan, name))
            if r.size and (r.min() < 0 or r.max() >= mloc):
                raise AssertionError(f"{name} out of local range")
        ic = np.asarray(plan.int_col)
        if ic.size and (ic.min() < 0 or ic.max() >= mloc):
            raise AssertionError("interior column not local")
        ec = np.asarray(plan.ext_col)
        if ec.size and (ec.min() < 0 or ec.max() >= plan.nshards * mloc):
            raise AssertionError("exterior column out of padded-global range")
        return
    raise TypeError(f"not a partition plan: {type(plan)}")
