"""Host-side format construction and conversion (numpy).

The PyTorch counterpart of :mod:`cask_tpu.formats.convert`, line for line.
Every function here is preprocessing that runs once per matrix on the
host, on numpy arrays; a matrix whose arrays are device tensors is copied
to the host first (:func:`cask_tpu_torch.formats.matrix.host`).  The JAX
package also has a C++ fast path for large f64 ``csr_to_bsr``; the port
has only the numpy path, which gives the same blocks.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np

from cask_tpu_torch.formats.matrix import BSR, COO, CSR, host

_INT = np.int32


def _as1d(x, dtype=None):
    a = host(x)
    if dtype is not None:
        a = a.astype(dtype, copy=False)
    return np.ravel(a)


# ---------------------------------------------------------------------------
# COO <-> CSR
# ---------------------------------------------------------------------------


def coo_from_arrays(data, row, col, shape) -> COO:
    data = _as1d(data)
    row = _as1d(row, _INT)
    col = _as1d(col, _INT)
    if not (data.shape == row.shape == col.shape):
        raise ValueError("data/row/col must have equal length")
    m, n = shape
    if data.size and (row.min() < 0 or row.max() >= m or col.min() < 0 or col.max() >= n):
        raise ValueError("index out of bounds for shape %r" % (shape,))
    return COO(data=data, row=row, col=col, shape=(int(m), int(n)))


def coo_to_csr(a: COO, *, sum_duplicates: bool = True) -> CSR:
    """Sort by (row, col), optionally sum duplicates, build indptr."""
    data = host(a.data)
    row = host(a.row).astype(np.int64)
    col = host(a.col).astype(np.int64)
    order = np.lexsort((col, row))
    row, col, data = row[order], col[order], data[order]
    if sum_duplicates and data.size:
        key = row * a.shape[1] + col
        uniq_mask = np.empty(key.shape, dtype=bool)
        uniq_mask[0] = True
        np.not_equal(key[1:], key[:-1], out=uniq_mask[1:])
        seg = np.cumsum(uniq_mask) - 1
        out_data = np.zeros(int(seg[-1]) + 1, dtype=data.dtype)
        np.add.at(out_data, seg, data)
        row, col, data = row[uniq_mask], col[uniq_mask], out_data
    indptr = np.zeros(a.shape[0] + 1, dtype=np.int64)
    np.add.at(indptr, row + 1, 1)
    indptr = np.cumsum(indptr)
    return CSR(
        data=data,
        indices=col.astype(_INT),
        indptr=indptr.astype(_INT),
        shape=a.shape,
    )


def csr_to_coo(a: CSR) -> COO:
    indptr = host(a.indptr)
    row = np.repeat(np.arange(a.shape[0], dtype=_INT), np.diff(indptr))
    return COO(
        data=host(a.data),
        row=row,
        col=host(a.indices).astype(_INT),
        shape=a.shape,
    )


# ---------------------------------------------------------------------------
# CSR <-> BSR
# ---------------------------------------------------------------------------


def csr_to_bsr(a: CSR, blocksize: Union[int, Tuple[int, int]]) -> BSR:
    """Group entries into dense (br, bc) blocks, zero-filling block gaps."""
    if isinstance(blocksize, int):
        blocksize = (blocksize, blocksize)
    br, bc = int(blocksize[0]), int(blocksize[1])
    m, n = a.shape

    indptr = host(a.indptr).astype(np.int64)
    indices = host(a.indices).astype(np.int64)
    data = host(a.data)

    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(indptr))
    brow = rows // br
    bcol = indices // bc
    # Unique (block-row, block-col) pairs in row-major block order.
    n_bcols = -(-n // bc)
    bkey = brow * n_bcols + bcol
    order = np.argsort(bkey, kind="stable")
    bkey_s = bkey[order]
    uniq_mask = np.empty(bkey_s.shape, dtype=bool)
    if bkey_s.size:
        uniq_mask[0] = True
        np.not_equal(bkey_s[1:], bkey_s[:-1], out=uniq_mask[1:])
        block_id = np.cumsum(uniq_mask) - 1  # dense block slot per entry
        n_blocks = int(block_id[-1]) + 1
    else:
        block_id = bkey_s.astype(np.int64)
        n_blocks = 0

    bdata = np.zeros((n_blocks, br, bc), dtype=data.dtype)
    r_in = (rows % br)[order]
    c_in = (indices % bc)[order]
    np.add.at(bdata, (block_id, r_in, c_in), data[order])

    uniq_key = bkey_s[uniq_mask] if bkey_s.size else bkey_s
    ubrow = uniq_key // n_bcols
    ubcol = uniq_key % n_bcols
    n_brows = -(-m // br)
    bindptr = np.zeros(n_brows + 1, dtype=np.int64)
    np.add.at(bindptr, ubrow + 1, 1)
    bindptr = np.cumsum(bindptr)
    return BSR(
        data=bdata,
        indices=ubcol.astype(_INT),
        indptr=bindptr.astype(_INT),
        shape=(m, n),
        blocksize=(br, bc),
    )


def bsr_to_csr(a: BSR, *, prune: bool = True) -> CSR:
    """Expand blocks back to scalar CSR, dropping explicit zeros if
    ``prune`` (block fill and padding rows/cols disappear)."""
    br, bc = a.blocksize
    m, n = a.shape
    data = host(a.data)
    indices = host(a.indices).astype(np.int64)
    indptr = host(a.indptr).astype(np.int64)
    nb = data.shape[0]
    if nb == 0:
        return CSR(
            data=data.reshape(0),
            indices=np.zeros(0, _INT),
            indptr=np.zeros(m + 1, _INT),
            shape=(m, n),
        )
    brow = np.repeat(np.arange(len(indptr) - 1, dtype=np.int64), np.diff(indptr))
    # entry coordinates for every stored scalar
    r = np.broadcast_to(
        brow[:, None, None] * br + np.arange(br)[None, :, None], (nb, br, bc)
    ).ravel()
    c = np.broadcast_to(
        indices[:, None, None] * bc + np.arange(bc)[None, None, :], (nb, br, bc)
    ).ravel()
    v = data.ravel()
    keep = (r < m) & (c < n)
    if prune:
        keep &= v != 0
    coo = COO(data=v[keep], row=r[keep].astype(_INT), col=c[keep].astype(_INT), shape=(m, n))
    return coo_to_csr(coo, sum_duplicates=True)


# ---------------------------------------------------------------------------
# transpose
# ---------------------------------------------------------------------------


def transpose(a):
    """Transpose of a COO/CSR/BSR matrix, as a host-side one-time
    re-encode.  Build the transposed matrix once and reuse it; never
    transpose inside a hot loop.  Plans transpose through
    :func:`cask_tpu_torch.ops.bdia.transpose_plan`."""
    if isinstance(a, COO):
        return COO(data=a.data, row=a.col, col=a.row,
                   shape=(a.shape[1], a.shape[0]))
    if isinstance(a, CSR):
        c = csr_to_coo(a)
        return coo_to_csr(
            COO(data=c.data, row=c.col, col=c.row,
                shape=(a.shape[1], a.shape[0])),
            sum_duplicates=False,
        )
    if isinstance(a, BSR):
        data = host(a.data)
        indices = host(a.indices).astype(np.int64)
        indptr = host(a.indptr).astype(np.int64)
        brow = np.repeat(
            np.arange(len(indptr) - 1, dtype=np.int64), np.diff(indptr))
        order = np.lexsort((brow, indices))
        new_indptr = np.zeros(a.n_block_cols + 1, dtype=np.int64)
        np.add.at(new_indptr, indices + 1, 1)
        br, bc = a.blocksize
        return BSR(
            data=np.ascontiguousarray(data[order].transpose(0, 2, 1)),
            indices=brow[order].astype(_INT),
            indptr=np.cumsum(new_indptr).astype(_INT),
            shape=(a.shape[1], a.shape[0]),
            blocksize=(bc, br),
        )
    raise TypeError(f"cannot transpose {type(a)}")


# ---------------------------------------------------------------------------
# scipy interop
# ---------------------------------------------------------------------------


def from_scipy(a, format: Optional[str] = None):
    """Convert a ``scipy.sparse`` matrix (any format) to a port matrix.

    ``format``: 'csr' (default), 'coo', or 'bsr:<br>x<bc>' / ('bsr', (br, bc)).
    """
    a = a.tocoo()
    coo = coo_from_arrays(a.data, a.row, a.col, a.shape)
    if format in (None, "csr"):
        return coo_to_csr(coo)
    if format == "coo":
        return coo
    if isinstance(format, tuple) and format[0] == "bsr":
        return csr_to_bsr(coo_to_csr(coo), format[1])
    if isinstance(format, str) and format.startswith("bsr:"):
        br, bc = format[4:].split("x")
        return csr_to_bsr(coo_to_csr(coo), (int(br), int(bc)))
    raise ValueError(f"unknown format {format!r}")


def to_scipy(a):
    """Convert a port matrix to ``scipy.sparse`` (csr).

    Arrays are copied: scipy mutates its index arrays in place
    (sort/dedup/prune).
    """
    import scipy.sparse as sp

    def _cp(x):
        return np.array(host(x), copy=True)

    if isinstance(a, CSR):
        return sp.csr_matrix(
            (_cp(a.data), _cp(a.indices), _cp(a.indptr)), shape=a.shape
        )
    if isinstance(a, COO):
        return sp.coo_matrix(
            (_cp(a.data), (_cp(a.row), _cp(a.col))), shape=a.shape
        ).tocsr()
    if isinstance(a, BSR):
        return to_scipy(bsr_to_csr(a))
    raise TypeError(f"not a cask_tpu_torch matrix: {type(a)}")
