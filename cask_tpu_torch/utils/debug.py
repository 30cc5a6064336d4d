"""Structural checks of packed plans.

The PyTorch counterpart of ``check_poh`` in :mod:`cask_tpu.utils.debug`.
"""

from __future__ import annotations

import numpy as np


def check_poh(p, a=None) -> None:
    """Validate a :class:`cask_tpu_torch.ops.poh.PohMatrix` pack's structural
    invariants; if the source CSR ``a`` is given, also verify that the pack
    reconstructs it exactly.  (The reference also checks ``rloc_t``, which
    the port's plan does not carry.)"""
    from cask_tpu_torch.formats.matrix import host

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
