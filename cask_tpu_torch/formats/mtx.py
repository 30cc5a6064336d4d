"""Matrix Market (.mtx) reader/writer (host numpy).

The PyTorch counterpart of :mod:`cask_tpu.formats.mtx`: the same parse on
the same files gives the same matrix.  Handles ``matrix coordinate``
real/integer/pattern/complex-as-real with general/symmetric/skew-symmetric
symmetry, and ``matrix array`` (dense) files, plain or gzipped.  The JAX
package also has a C++ parser for large bodies; the port has only the
numpy path, which gives the same entries.
"""

from __future__ import annotations

import gzip
import io
from typing import Union

import numpy as np

from cask_tpu_torch.formats.convert import coo_from_arrays, coo_to_csr, csr_to_coo
from cask_tpu_torch.formats.matrix import COO, CSR, host


def _open(path_or_file, mode="rt"):
    if hasattr(path_or_file, "read") or hasattr(path_or_file, "write"):
        return path_or_file, False
    p = str(path_or_file)
    if p.endswith(".gz"):
        return gzip.open(p, mode), True
    return open(p, mode), True


def read_mtx(path_or_file, *, dtype=np.float64, format: str = "csr") -> Union[CSR, COO]:
    """Parse a MatrixMarket file into CSR (default) or COO."""
    f, should_close = _open(path_or_file, "rt")
    try:
        header = f.readline()
        if not header.startswith("%%MatrixMarket"):
            raise ValueError("not a MatrixMarket file (missing %%MatrixMarket header)")
        parts = header.strip().split()
        if len(parts) < 5 or parts[1].lower() != "matrix":
            raise ValueError(f"unsupported MatrixMarket header: {header!r}")
        layout, field, symmetry = parts[2].lower(), parts[3].lower(), parts[4].lower()
        if layout not in ("coordinate", "array"):
            raise ValueError(f"unsupported layout {layout!r}")
        if field not in ("real", "integer", "pattern", "complex", "double"):
            raise ValueError(f"unsupported field {field!r}")

        line = f.readline()
        while line.startswith("%") or not line.strip():
            line = f.readline()
        dims = line.split()

        if layout == "array":
            m, n = int(dims[0]), int(dims[1])
            vals = np.loadtxt(f, dtype=np.float64).reshape(-1)
            dense = vals.reshape((n, m)).T  # array layout is column-major
            if symmetry in ("symmetric", "skew-symmetric", "hermitian"):
                tri = np.tril(dense)  # file stores lower triangle column-major
                dense = tri + (tri.T - np.diag(np.diag(tri))) * (
                    -1.0 if symmetry == "skew-symmetric" else 1.0
                )
            r, c = np.nonzero(dense)
            coo = coo_from_arrays(dense[r, c].astype(dtype), r, c, (m, n))
        else:
            m, n, nnz = int(dims[0]), int(dims[1]), int(dims[2])
            raw = f.read().split()
            per = 2 if field == "pattern" else (4 if field == "complex" else 3)
            if len(raw) < nnz * per:
                raise ValueError("truncated MatrixMarket body")
            arr = np.asarray(raw[: nnz * per], dtype=np.float64).reshape(nnz, per)
            row = arr[:, 0].astype(np.int64) - 1
            col = arr[:, 1].astype(np.int64) - 1
            if field == "pattern":
                data = np.ones(nnz, dtype=dtype)
            else:
                data = arr[:, 2].astype(dtype)  # complex keeps the real part
            if data.size and (row.min() < 0 or col.min() < 0):
                raise ValueError("MatrixMarket indices must be 1-based positive")
            if symmetry in ("symmetric", "hermitian", "skew-symmetric"):
                off = row != col
                s = -1.0 if symmetry == "skew-symmetric" else 1.0
                row, col = np.concatenate([row, col[off]]), np.concatenate([col, row[off]])
                data = np.concatenate([data, s * data[off]])
            coo = coo_from_arrays(data, row, col, (m, n))
    finally:
        if should_close:
            f.close()
    if format == "coo":
        return coo
    return coo_to_csr(coo)


def write_mtx(path_or_file, a, *, comment: str = "") -> None:
    """Write a COO/CSR matrix as MatrixMarket 'coordinate real general'."""
    if isinstance(a, CSR):
        a = csr_to_coo(a)
    if not isinstance(a, COO):
        raise TypeError(f"cannot write {type(a)} as .mtx")
    f, should_close = _open(path_or_file, "wt")
    try:
        f.write("%%MatrixMarket matrix coordinate real general\n")
        if comment:
            for line in comment.splitlines():
                f.write(f"% {line}\n")
        f.write(f"{a.shape[0]} {a.shape[1]} {a.nnz}\n")
        row = host(a.row) + 1
        col = host(a.col) + 1
        data = host(a.data)
        buf = io.StringIO()
        np.savetxt(buf, np.column_stack([row, col, data]), fmt="%d %d %.17g")
        f.write(buf.getvalue())
    finally:
        if should_close:
            f.close()
