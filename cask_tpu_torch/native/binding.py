"""ctypes bindings for the port's copy of the native preprocessing core.

The counterpart of :mod:`cask_tpu.native.binding`, the same surface on the
library that :mod:`cask_tpu_torch.native.build` builds from the port's own
``src/preprocess.cpp``.  Every function raises ``NativeUnavailable`` if the
library can't be built/loaded; call sites that have a numpy path catch it
and take that path, and those asked for the core by name re-raise.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from cask_tpu_torch.native.build import lib_path


class NativeUnavailable(RuntimeError):
    pass


_lib = None
_tried = False


def _get() -> ctypes.CDLL:
    global _lib, _tried
    if _lib is not None:
        return _lib
    if _tried:
        raise NativeUnavailable("native core unavailable (cached failure)")
    _tried = True
    p = lib_path()
    if p is None:
        raise NativeUnavailable("could not build native core")
    lib = ctypes.CDLL(p)
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")

    lib.cask_parse_mtx_body.restype = ctypes.c_int64
    lib.cask_parse_mtx_body.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        i32p, i32p, f64p,
    ]
    lib.cask_ilu0.restype = ctypes.c_int32
    lib.cask_ilu0.argtypes = [ctypes.c_int32, i32p, i32p, f64p]
    lib.cask_levels_lower.restype = ctypes.c_int32
    lib.cask_levels_lower.argtypes = [ctypes.c_int32, i32p, i32p, i32p]
    lib.cask_rcm.restype = None
    lib.cask_rcm.argtypes = [ctypes.c_int32, i32p, i32p, i32p]
    lib.cask_bsr_count.restype = ctypes.c_int64
    lib.cask_bsr_count.argtypes = [
        ctypes.c_int32, ctypes.c_int32, i32p, i32p, ctypes.c_int32, ctypes.c_int32,
    ]
    lib.cask_bsr_fill.restype = ctypes.c_int64
    lib.cask_bsr_fill.argtypes = [
        ctypes.c_int32, ctypes.c_int32, i32p, i32p, f64p,
        ctypes.c_int32, ctypes.c_int32, i32p, i32p, f64p,
    ]
    lib.cask_spgemm_count.restype = ctypes.c_int64
    lib.cask_spgemm_count.argtypes = [
        ctypes.c_int32, ctypes.c_int32, i32p, i32p, i32p, i32p, i32p,
    ]
    lib.cask_spgemm_fill.restype = None
    lib.cask_spgemm_fill.argtypes = [
        ctypes.c_int32, ctypes.c_int32, i32p, i32p, f64p, i32p, i32p, f64p,
        i32p, i32p, f64p,
    ]
    lib.cask_aggregate.restype = ctypes.c_int32
    lib.cask_aggregate.argtypes = [ctypes.c_int32, i32p, i32p, i32p]
    _lib = lib
    return lib


def available() -> bool:
    try:
        _get()
        return True
    except NativeUnavailable:
        return False


def _i32(x) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.int32)


def parse_mtx_body(body: bytes, nnz: int, field: int):
    """field: 0=pattern, 1=real/integer, 2=complex."""
    lib = _get()
    row = np.empty(nnz, np.int32)
    col = np.empty(nnz, np.int32)
    val = np.empty(nnz, np.float64)
    got = lib.cask_parse_mtx_body(body, len(body), nnz, field, row, col, val)
    if got != nnz:
        raise ValueError("native mtx parse failed (truncated or malformed body)")
    return row, col, val


def ilu0(indptr, indices, data) -> np.ndarray:
    lib = _get()
    lu = np.ascontiguousarray(data, dtype=np.float64).copy()
    n = len(indptr) - 1
    rc = lib.cask_ilu0(n, _i32(indptr), _i32(indices), lu)
    if rc < 0:
        raise ZeroDivisionError(f"ILU(0): zero/missing pivot at row {-rc - 1}")
    return lu


def levels_lower(n: int, strict_indptr, strict_indices) -> Tuple[np.ndarray, int]:
    lib = _get()
    level = np.zeros(n, np.int32)
    nlev = lib.cask_levels_lower(n, _i32(strict_indptr), _i32(strict_indices), level)
    return level, int(nlev)


def rcm(indptr, indices) -> np.ndarray:
    lib = _get()
    n = len(indptr) - 1
    perm = np.empty(n, np.int32)
    lib.cask_rcm(n, _i32(indptr), _i32(indices), perm)
    return perm


def csr_to_bsr_arrays(m, n, indptr, indices, data, br, bc):
    lib = _get()
    ip, ix = _i32(indptr), _i32(indices)
    dd = np.ascontiguousarray(data, dtype=np.float64)
    nblocks = lib.cask_bsr_count(m, n, ip, ix, br, bc)
    nbr = -(-m // br)
    bindptr = np.zeros(nbr + 1, np.int32)
    bindices = np.zeros(max(nblocks, 1), np.int32)
    bdata = np.zeros((max(nblocks, 1), br, bc), np.float64)
    got = lib.cask_bsr_fill(m, n, ip, ix, dd, br, bc, bindptr, bindices,
                            bdata.reshape(-1))
    if got != nblocks:
        raise RuntimeError("native bsr fill mismatch")
    if nblocks == 0:
        bindices = bindices[:0]
        bdata = bdata[:0]
    return bindptr, bindices, bdata


def spgemm(m, n, p, a_indptr, a_indices, a_data, b_indptr, b_indices, b_data):
    """Full host Gustavson SpGEMM: returns (c_indptr, c_indices, c_data)."""
    lib = _get()
    ap, ac = _i32(a_indptr), _i32(a_indices)
    bp, bc = _i32(b_indptr), _i32(b_indices)
    av = np.ascontiguousarray(a_data, dtype=np.float64)
    bv = np.ascontiguousarray(b_data, dtype=np.float64)
    c_ptr = np.zeros(m + 1, np.int32)
    nnz = lib.cask_spgemm_count(m, p, ap, ac, bp, bc, c_ptr)
    if nnz > np.iinfo(np.int32).max:
        raise OverflowError("SpGEMM result exceeds int32 nnz")
    c_col = np.zeros(max(nnz, 1), np.int32)
    c_val = np.zeros(max(nnz, 1), np.float64)
    lib.cask_spgemm_fill(m, p, ap, ac, av, bp, bc, bv, c_ptr, c_col, c_val)
    if nnz == 0:
        c_col, c_val = c_col[:0], c_val[:0]
    return c_ptr, c_col, c_val


def aggregate(indptr, indices):
    """Greedy Vaněk aggregation over a CSR strength graph.

    Returns ``(agg, n_agg)`` with ``agg[i]`` the aggregate id of node i.
    Bit-identical to the Python fallback in ``solvers/amg.py`` (both are
    order-dependent greedy passes in row order)."""
    lib = _get()
    ip, ic = _i32(indptr), _i32(indices)
    n = len(ip) - 1
    agg = np.zeros(max(n, 1), np.int32)
    n_agg = lib.cask_aggregate(n, ip, ic, agg)
    return agg[:n].astype(np.int64), int(n_agg)
