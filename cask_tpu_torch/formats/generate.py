"""Synthetic matrix generators (numpy, host side).

The PyTorch counterpart of :mod:`cask_tpu.formats.generate`: the same
code on the same seeds, so each generator gives bit-identical arrays to
the JAX package's.

- ``banded``        — diagonal band (tridiag generalization): bcsstk-style
- ``stencil_2d``    — 5/9-point Laplacian on a grid: FEM/stencil class
- ``fem_blocks``    — stencil graph with dense (b×b) node blocks: multi-dof
                      FEM, the natural BSR workload
- ``power_law``     — scale-free graph (Barabási–Albert-ish)
- ``random_uniform`` — Erdős–Rényi uniform random sparsity
- ``suite``          — a named set of the above (SuiteSparse stand-in)

All return host-side CSR with sorted, deduplicated indices.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from cask_tpu_torch.formats.convert import (coo_from_arrays, coo_to_csr,
                                            csr_to_bsr, csr_to_coo)
from cask_tpu_torch.formats.matrix import CSR


def _rng(seed):
    return np.random.default_rng(seed)


def _finish(data, row, col, shape, spd_shift: float = 0.0) -> CSR:
    csr = coo_to_csr(coo_from_arrays(data, row, col, shape))
    if spd_shift:
        csr = _diag_shift(csr, spd_shift)
    return csr


def _diag_shift(a: CSR, shift: float) -> CSR:
    """Add ``shift * (max |row sum|)``-scaled identity to make the matrix
    comfortably diagonally dominant (for solver tests)."""
    coo = csr_to_coo(a)
    n = min(a.shape)
    d = np.arange(n, dtype=np.int32)
    absrow = np.zeros(a.shape[0], dtype=np.float64)
    np.add.at(absrow, coo.row, np.abs(coo.data.astype(np.float64)))
    val = shift * max(float(absrow.max(initial=0.0)), 1.0)
    data = np.concatenate([coo.data, np.full(n, val, dtype=coo.data.dtype)])
    row = np.concatenate([coo.row, d])
    col = np.concatenate([coo.col, d])
    return coo_to_csr(coo_from_arrays(data, row, col, a.shape))


def banded(n: int, bandwidth: int, *, density: float = 1.0, dtype=np.float64, seed=0,
           spd: bool = False) -> CSR:
    """Matrix with entries within ``|i-j| <= bandwidth``, optionally thinned."""
    rng = _rng(seed)
    offs = np.arange(-bandwidth, bandwidth + 1)
    rows, cols = [], []
    for off in offs:
        i = np.arange(max(0, -off), min(n, n - off))
        j = i + off
        if density < 1.0 and off != 0:
            keep = rng.random(i.shape[0]) < density
            i, j = i[keep], j[keep]
        rows.append(i)
        cols.append(j)
    row = np.concatenate(rows)
    col = np.concatenate(cols)
    data = rng.standard_normal(row.shape[0]).astype(dtype)
    return _finish(data, row, col, (n, n), spd_shift=1.1 if spd else 0.0)


def stencil_2d(nx: int, ny: Optional[int] = None, *, points: int = 5, dtype=np.float64) -> CSR:
    """(Negative) Laplacian on an nx×ny grid; 5- or 9-point stencil.  SPD."""
    ny = ny or nx
    n = nx * ny
    idx = np.arange(n).reshape(nx, ny)
    rows = [idx.ravel()]
    cols = [idx.ravel()]
    vals = [np.full(n, 4.0 if points == 5 else 8.0)]

    def link(src, dst, w):
        rows.append(src.ravel())
        cols.append(dst.ravel())
        vals.append(np.full(src.size, w))
        rows.append(dst.ravel())
        cols.append(src.ravel())
        vals.append(np.full(src.size, w))

    link(idx[:-1, :], idx[1:, :], -1.0)
    link(idx[:, :-1], idx[:, 1:], -1.0)
    if points == 9:
        link(idx[:-1, :-1], idx[1:, 1:], -1.0)
        link(idx[:-1, 1:], idx[1:, :-1], -1.0)
    data = np.concatenate(vals).astype(dtype)
    return _finish(data, np.concatenate(rows), np.concatenate(cols), (n, n))


def stencil_3d(nx: int, ny: Optional[int] = None, nz: Optional[int] = None, *,
               dtype=np.float64) -> CSR:
    """7-point Laplacian on an nx×ny×nz grid.  SPD."""
    ny = ny or nx
    nz = nz or nx
    n = nx * ny * nz
    idx = np.arange(n).reshape(nx, ny, nz)
    rows = [idx.ravel()]
    cols = [idx.ravel()]
    vals = [np.full(n, 6.0)]

    def link(src, dst):
        rows.extend([src.ravel(), dst.ravel()])
        cols.extend([dst.ravel(), src.ravel()])
        vals.extend([np.full(src.size, -1.0)] * 2)

    link(idx[:-1, :, :], idx[1:, :, :])
    link(idx[:, :-1, :], idx[:, 1:, :])
    link(idx[:, :, :-1], idx[:, :, 1:])
    data = np.concatenate(vals).astype(dtype)
    return _finish(data, np.concatenate(rows), np.concatenate(cols), (n, n))


def fem_blocks(nx: int, ny: Optional[int] = None, *, dof: int = 4, dtype=np.float64,
               seed=0, return_bsr: bool = False):
    """Stencil connectivity with dense dof×dof node blocks — multi-dof FEM.

    The natural BSR workload: the block structure is real, not imposed.
    """
    base = stencil_2d(nx, ny, dtype=np.float64)
    rng = _rng(seed)
    coo = csr_to_coo(base)
    r = coo.row.astype(np.int64)
    c = coo.col.astype(np.int64)
    nb = r.shape[0]
    # expand every graph edge into a dense dof×dof block
    rr = np.broadcast_to(
        r[:, None, None] * dof + np.arange(dof)[None, :, None], (nb, dof, dof)
    ).ravel()
    cc = np.broadcast_to(
        c[:, None, None] * dof + np.arange(dof)[None, None, :], (nb, dof, dof)
    ).ravel()
    blocks = rng.standard_normal((nb, dof, dof))
    diag = r == c
    blocks[diag] += np.eye(dof) * (4.0 * dof)  # keep it well-conditioned
    data = blocks.ravel().astype(dtype)
    n = base.shape[0] * dof
    csr = _finish(data, rr, cc, (n, n))
    if return_bsr:
        return csr_to_bsr(csr, (dof, dof))
    return csr


def power_law(n: int, *, avg_degree: int = 8, exponent: float = 2.1, dtype=np.float64,
              seed=0, symmetric: bool = True) -> CSR:
    """Scale-free graph adjacency-like matrix (heavy-tailed degrees)."""
    rng = _rng(seed)
    # degree ∝ zipf-ish weights, scaled to hit avg_degree
    w = (np.arange(1, n + 1, dtype=np.float64)) ** (-1.0 / (exponent - 1.0))
    rng.shuffle(w)
    p = w / w.sum()
    m = n * avg_degree
    src = rng.choice(n, size=m, p=p).astype(np.int64)
    dst = rng.integers(0, n, size=m).astype(np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    if symmetric:
        src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    data = rng.standard_normal(src.shape[0]).astype(dtype)
    return _finish(data, src, dst, (n, n))


def random_uniform(m: int, n: Optional[int] = None, *, density: float = 0.01,
                   dtype=np.float64, seed=0) -> CSR:
    """Erdős–Rényi uniform random sparsity."""
    n = n or m
    rng = _rng(seed)
    nnz = max(1, int(round(m * n * density)))
    row = rng.integers(0, m, size=nnz).astype(np.int64)
    col = rng.integers(0, n, size=nnz).astype(np.int64)
    data = rng.standard_normal(nnz).astype(dtype)
    return _finish(data, row, col, (m, n))


def suite(size: str = "small"):
    """A named matrix suite for tests/benchmarks (SuiteSparse stand-in).

    Returns ``{name: CSR}``.  Sizes: small (~2k rows), medium (~100k rows).
    """
    if size == "small":
        return {
            "bcsstk_like": banded(2003, 40, density=0.35, seed=1, spd=True),
            "stencil5_45x45": stencil_2d(45),
            "fem_dof4_23x23": fem_blocks(23, dof=4),
            "powerlaw_2k": power_law(2000, avg_degree=8, seed=2),
            "rand_2k": random_uniform(2000, density=0.005, seed=3),
        }
    if size == "medium":
        return {
            "stencil5_317x317": stencil_2d(317),  # ~100k rows
            "stencil9_317x317": stencil_2d(317, points=9),
            "stencil7_47": stencil_3d(47),  # ~104k rows
            "fem_dof4_158x158": fem_blocks(158, dof=4),  # ~100k rows
            "powerlaw_100k": power_law(100_000, avg_degree=16, seed=5),
        }
    raise ValueError(f"unknown suite size {size!r}")
