"""Host-side matrix partitioning for multi-device execution.

The PyTorch counterpart of :mod:`cask_tpu.parallel.partition`, in numpy on
the host: every array of every partition equals the JAX package's (same
dtype, shape and values), but for the remainder of ``partition_dia`` with
``align > 1``, which the port splits like the band (the reference's split
differs from the band's, and its executor cannot add the two).  A partition holds all ``P`` shards stacked on a
leading axis; :class:`~cask_tpu_torch.parallel.dist.DistSpmv` on rank ``p``
moves shard ``p`` of each array to that rank's device.

Partitioning contract (shape-uniform, as in the reference): ``P``
contiguous row blocks of identical padded size ``mloc``; per-shard index
arrays padded to the max across shards with structural zeros (row 0 /
col 0 / value 0, harmless in a sum).

- :class:`CooPartition`: any matrix.  Each shard's entries are split into
  *interior* (column owned locally) and *exterior* (column elsewhere,
  indexing the all-gathered x), so the interior product does not wait on
  the collective.
- :class:`DiaPartition`: banded matrices.  Each shard holds its slice of
  every packed diagonal; only ``lo``/``hi`` edge elements come from the
  ring neighbours.
- :class:`BdiaPartition`: block-banded matrices, the same at block
  granularity, with host-extracted edge windows for the halo fix-ups.
- :class:`PohPartition`: unstructured matrices as per-shard panel one-hot
  packs (interior and exterior), by default in ``poh_plan``'s tile and
  window rather than the reference's (:func:`partition_poh`).  The reference also stacks each pack's
  ``rloc`` transposed per tile (``rloc_t``), a TPU layout the Hopper
  kernels never read; the port's packs leave it out, as
  :class:`~cask_tpu_torch.ops.poh.PohMatrix` does.
- :class:`Coo2DPartition`: a 2-D block partition over a ``pr × pc`` grid.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from cask_tpu_torch.formats.matrix import BSR, CSR, host

_INT = np.int32


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _coo_arrays(a: CSR):
    """(data, rows, cols) of a CSR on the host, rows and cols as int64."""
    indptr = host(a.indptr).astype(np.int64)
    indices = host(a.indices).astype(np.int64)
    rows = np.repeat(np.arange(a.shape[0], dtype=np.int64), np.diff(indptr))
    return host(a.data), rows, indices


@dataclasses.dataclass(frozen=True, eq=False)
class CooPartition:
    """Row-partitioned COO with interior/exterior split (general matrices)."""

    # interior: columns local to the shard (remapped to local indices)
    int_data: np.ndarray  # (P, Ei)
    int_row: np.ndarray  # (P, Ei) local row
    int_col: np.ndarray  # (P, Ei) local col
    # exterior: columns owned by other shards (indices into the padded
    # gathered vector of length P*mloc)
    ext_data: np.ndarray  # (P, Ee)
    ext_row: np.ndarray  # (P, Ee) local row
    ext_col: np.ndarray  # (P, Ee) padded-global col
    shape: Tuple[int, int]
    nshards: int
    mloc: int


@dataclasses.dataclass(frozen=True, eq=False)
class DiaPartition:
    """Row-partitioned diagonal pack + ring halo (banded matrices).

    ``vals[p, d, r]`` is ``A[p*mloc + r, p*mloc + r + offsets[d]]``.
    Entries outside the band go into an embedded :class:`CooPartition`
    remainder (may be None).
    """

    vals: np.ndarray  # (P, D, mloc)
    remainder: Optional[CooPartition]
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]
    nshards: int
    mloc: int

    @property
    def halo_lo(self) -> int:
        return -min(min(self.offsets), 0)

    @property
    def halo_hi(self) -> int:
        return max(max(self.offsets), 0)


def _pad_rows(groups, P, width, fill=0, dtype=_INT):
    out = np.full((P, width), fill, dtype=dtype)
    for p, g in enumerate(groups):
        out[p, : g.shape[0]] = g
    return out


def partition_coo(a: CSR, nshards: int, *, mloc: Optional[int] = None) -> CooPartition:
    """Row-partition any CSR into the interior/exterior COO plan.

    ``mloc`` overrides the per-shard row count (the remainder of a block
    partition must match the block plan's scalar row split)."""
    m, n = a.shape
    P = nshards
    mloc = mloc if mloc is not None else _ceil_div(m, P)
    if mloc * P < m:
        raise ValueError(f"mloc ({mloc}) too small for {m} rows / {P} shards")
    if n > P * mloc:
        # x is partitioned like the rows; a wider matrix would index the
        # gathered vector out of range
        raise ValueError(
            f"partition_coo requires n ({n}) <= nshards*mloc ({P * mloc}); "
            "pad the matrix columns or partition the transpose")
    data, rows, indices = _coo_arrays(a)
    owner_row = rows // mloc
    interior = owner_row == indices // mloc

    gi, ge = [], []
    for p in range(P):
        mine = owner_row == p
        mi = mine & interior
        me = mine & ~interior
        gi.append((data[mi], rows[mi] - p * mloc, indices[mi] - p * mloc))
        ge.append((data[me], rows[me] - p * mloc, indices[me]))

    Ei = max((g[0].shape[0] for g in gi), default=0) or 1
    Ee = max((g[0].shape[0] for g in ge), default=0) or 1
    return CooPartition(
        int_data=_pad_rows([g[0] for g in gi], P, Ei, 0.0, data.dtype),
        int_row=_pad_rows([g[1] for g in gi], P, Ei),
        int_col=_pad_rows([g[2] for g in gi], P, Ei),
        ext_data=_pad_rows([g[0] for g in ge], P, Ee, 0.0, data.dtype),
        ext_row=_pad_rows([g[1] for g in ge], P, Ee),
        ext_col=_pad_rows([g[2] for g in ge], P, Ee),
        shape=(m, n), nshards=P, mloc=mloc)


def _remainder(data, rows, cols, shape, P, mloc=None) -> CooPartition:
    """The spilled entries as a :class:`CooPartition` over the same split."""
    from cask_tpu_torch.formats.convert import coo_from_arrays, coo_to_csr

    return partition_coo(coo_to_csr(coo_from_arrays(data, rows, cols, shape)), P, mloc=mloc)


def partition_dia(a: CSR, nshards: int, *, min_density: float = 0.10,
                  max_diags: int = 256, max_halo: Optional[int] = None,
                  align: int = 1) -> DiaPartition:
    """Row-partition a banded CSR into per-shard diagonal slices.

    Diagonals whose |offset| exceeds ``max_halo`` (default ``mloc``) spill
    to the remainder: a halo wider than a whole shard would need a
    multi-hop exchange, which the all-gather remainder already covers.
    ``align`` rounds the per-shard row count up to a multiple (the DIA
    kernel interior needs 8192).
    """
    m, n = a.shape
    if m != n:
        raise ValueError("DiaPartition requires a square matrix")
    P = nshards
    mloc = _ceil_div(_ceil_div(m, P), align) * align
    max_halo = max_halo if max_halo is not None else mloc

    data, rows, indices = _coo_arrays(a)
    offs = indices - rows
    uniq, counts = np.unique(offs, return_counts=True)
    diag_len = np.minimum(np.minimum(m, n - uniq), np.minimum(n, m + uniq))
    density = counts / np.maximum(diag_len, 1)
    keep = (density >= min_density) & (np.abs(uniq) <= max_halo)
    if keep.sum() > max_diags:
        keep &= counts >= np.sort(counts[keep])[-max_diags]
    kept = uniq[keep]
    if kept.size == 0:
        kept = np.array([0], dtype=np.int64)

    in_dia = np.isin(offs, kept)
    vals = np.zeros((P, kept.size, mloc), dtype=data.dtype)
    d_ids = np.searchsorted(kept, offs[in_dia])
    r = rows[in_dia]
    vals[r // mloc, d_ids, r % mloc] = data[in_dia]

    rem = None
    if int((~in_dia).sum()):
        # split like the band (the reference splits it by ceil(m / P), which
        # differs from an aligned mloc: its executor then cannot add the two)
        rem = _remainder(data[~in_dia], rows[~in_dia], indices[~in_dia], (m, n), P, mloc=mloc)
    return DiaPartition(vals=vals, remainder=rem, offsets=tuple(int(o) for o in kept),
                        shape=(m, n), nshards=P, mloc=mloc)


def _stencil_offset_mask(g, off: int, ny: int, n: int):
    """Which (global, padded) rows carry a neighbour at offset ``off`` in
    the 5-point grid of ``n`` points and row length ``ny``."""
    in_range = g < n
    col = g % ny
    if off == 0:
        return in_range
    if off == 1:
        return in_range & (g + 1 < n) & (col != ny - 1)
    if off == -1:
        return in_range & (g >= 1) & (col != 0)
    if off == ny:
        return in_range & (g + ny < n)
    return in_range & (g >= ny)


def stencil_dia_partition(nx: int, ny: Optional[int] = None, *, nshards: int,
                          align: int = 8192, dtype=np.float32) -> DiaPartition:
    """Formulaic DiaPartition of the 5-point Laplacian, with no CSR build
    (equal to ``partition_dia(generate.stencil_2d(nx, ny), nshards,
    align=align)``)."""
    ny = ny or nx
    n = nx * ny
    P = nshards
    mloc = _ceil_div(_ceil_div(n, P), align) * align
    offsets = tuple(sorted({-ny, -1, 0, 1, ny}))
    g = np.arange(P * mloc, dtype=np.int64)  # global row ids (padded)
    vals = np.zeros((len(offsets), P * mloc), dtype=dtype)
    for d, off in enumerate(offsets):
        vals[d, _stencil_offset_mask(g, off, ny, n)] = 4.0 if off == 0 else -1.0
    return DiaPartition(
        vals=np.ascontiguousarray(vals.reshape(len(offsets), P, mloc).transpose(1, 0, 2)),
        remainder=None, offsets=offsets, shape=(n, n), nshards=P, mloc=mloc)


@dataclasses.dataclass(frozen=True, eq=False)
class BdiaPartition:
    """Block-row-partitioned BDIA pack + ring halo.

    Shard ``p`` owns block rows ``[p·nbloc, (p+1)·nbloc)`` of the global
    block matrix as a shape-uniform BDIA pack (shared kept offsets, tile
    geometry ``ts``/``T`` across shards; trailing shards zero-padded).  The
    halo is ``lo_b``/``hi_b`` *block* offsets of x exchanged with the ring
    neighbours; the interior reads only local x (structural-zero pads).

    ``head_vals``/``tail_vals`` are host-extracted edge value windows
    (zeroed where the term is interior) that make the post-halo fix-ups
    regular component-plane FMAs: for pair ``j = (c, d)``

        head[r, i]  += head_vals[r, j, i] · left_c[i + d + lo_b]   (d < 0)
        tail[r, ih] += tail_vals[r, j, ih] · right_c[ih − (hi_b − d)] (d > 0)

    with ``i`` over the first ``lo_b`` block rows and ``ih`` over the last
    ``hi_b``.  Block diagonals wider than one shard spill to the embedded
    :class:`CooPartition` remainder.
    """

    vals: np.ndarray  # (P, br, T, npairs, TS, 128)
    head_vals: np.ndarray  # (P, br, npairs, max(lo_b, 1))
    tail_vals: np.ndarray  # (P, br, npairs, max(hi_b, 1))
    remainder: Optional[CooPartition]
    block_offsets: Tuple[int, ...]
    shape: Tuple[int, int]
    blocksize: Tuple[int, int]
    ts: int
    nshards: int
    mloc: int  # scalar rows per shard
    nbloc: int  # block rows per shard

    @property
    def halo_lo_b(self) -> int:
        return -min(min(self.block_offsets), 0)

    @property
    def halo_hi_b(self) -> int:
        return max(max(self.block_offsets), 0)

    @property
    def npairs(self) -> int:
        return int(self.vals.shape[3])

    @property
    def pairs(self) -> Tuple[Tuple[int, int], ...]:
        bc = self.blocksize[1]
        return tuple((c, d) for d in self.block_offsets for c in range(bc))


def _bdia_edge_windows(vals: np.ndarray, kept: np.ndarray, bc: int, nbloc: int, ts: int,
                       T: int):
    """Host-extract the (head_vals, tail_vals) fix-up windows from a packed
    ``(P, br, T, npairs, TS, 128)`` vals array (zeroed where the term is
    interior; see :class:`BdiaPartition`)."""
    P, br, npairs = vals.shape[0], vals.shape[1], vals.shape[3]
    dtype = vals.dtype
    lo_b = int(-min(kept.min(), 0))
    hi_b = int(max(kept.max(), 0))
    offs_per_pair = np.repeat(kept, bc)  # d of pair j
    wl, wh = max(lo_b, 1), max(hi_b, 1)
    t_head = min(_ceil_div(max(lo_b, 1), ts * 128), T)
    head_flat = np.ascontiguousarray(
        vals[:, :, :t_head].transpose(0, 1, 3, 2, 4, 5)).reshape(P, br, npairs, -1)
    head_vals = np.zeros((P, br, npairs, wl), dtype=dtype)
    w = min(lo_b, head_flat.shape[-1])
    head_vals[..., :w] = head_flat[..., :w]
    head_vals *= (np.arange(wl)[None, :] < -offs_per_pair[:, None]).astype(dtype)

    t0_tail = max((nbloc - hi_b) // (ts * 128), 0) if hi_b else T - 1
    tail_flat = np.ascontiguousarray(
        vals[:, :, t0_tail:].transpose(0, 1, 3, 2, 4, 5)).reshape(P, br, npairs, -1)
    tail_vals = np.zeros((P, br, npairs, wh), dtype=dtype)
    if hi_b:
        off0 = (nbloc - hi_b) - t0_tail * ts * 128
        tail_vals[:] = tail_flat[..., off0 : off0 + hi_b]
        tail_vals *= (np.arange(wh)[None, :] >= (hi_b - offs_per_pair)[:, None]).astype(dtype)
    return head_vals, tail_vals


def partition_bdia(a, nshards: int, blocksize: Optional[Tuple[int, int]] = None, *,
                   min_density: float = 0.10, max_block_diags: int = 64,
                   align_b: int = 1) -> BdiaPartition:
    """Block-row-partition a BSR/CSR matrix into per-shard BDIA packs.

    Square blocks only (x is partitioned like the rows).  Kept block
    diagonals are chosen globally (one shape-uniform shard program);
    everything else (sparse block diagonals, blocks beyond the single-hop
    halo) spills to the scalar COO remainder.  ``align_b`` rounds the
    per-shard block-row count up to a multiple.  The CUDA interior takes
    any shard size.
    """
    from cask_tpu_torch.ops.bdia import _pick_ts

    if isinstance(a, CSR):
        if blocksize is None:
            raise ValueError("partition_bdia on CSR needs an explicit blocksize")
        from cask_tpu_torch.formats.convert import csr_to_bsr

        a = csr_to_bsr(a, blocksize)
    if not isinstance(a, BSR):
        raise TypeError(f"partition_bdia takes a BSR or CSR, got {type(a).__name__}")
    br, bc = a.blocksize
    if br != bc:
        raise ValueError("partition_bdia needs square blocks (row partition owns x like "
                         "the rows)")
    m, n = a.shape
    if m != n:
        raise ValueError("partition_bdia requires a square matrix")
    P = nshards
    nbr = a.n_block_rows
    nbloc = _ceil_div(_ceil_div(nbr, P), align_b) * align_b
    if (P - 1) * nbloc >= nbr:
        # align_b rounding left at least one shard all padding; refuse
        raise ValueError(
            f"align_b={align_b} rounds the shard size to {nbloc} block rows, but the "
            f"matrix has only {nbr} block rows across {P} shards — shard {P - 1} would "
            f"hold no real rows. Use a smaller align_b or fewer shards "
            f"(need (P-1)*nbloc < nbr).")
    mloc = nbloc * br

    indptr = host(a.indptr).astype(np.int64)
    indices = host(a.indices).astype(np.int64)
    data = host(a.data)
    ib = np.repeat(np.arange(nbr, dtype=np.int64), np.diff(indptr))
    d = indices - ib

    # global kept-offset choice (the rule of bdia_plan) + halo guard
    uniq, counts = np.unique(d, return_counts=True)
    diag_len = np.minimum(np.minimum(nbr, nbr - uniq), np.minimum(nbr, nbr + uniq))
    density = counts / np.maximum(diag_len, 1)
    keep = (density >= min_density) & (np.abs(uniq) <= nbloc)
    if keep.sum() > max_block_diags:
        keep &= counts >= np.sort(counts[keep])[-max_block_diags]
    kept = uniq[keep]
    if kept.size == 0:
        kept = np.array([0], dtype=np.int64)
    in_dia = np.isin(d, kept)

    ts = _pick_ts(nbloc)
    T = _ceil_div(nbloc, ts * 128)
    npairs = kept.size * bc
    vals = np.zeros((P, br, T, npairs, ts, 128), dtype=data.dtype)
    kb = np.nonzero(in_dia)[0]
    if kb.size:
        i = ib[kb]
        iloc = i % nbloc
        dpos = np.searchsorted(kept, d[kb])
        rem_i = iloc % (ts * 128)
        c_rng = np.arange(bc)
        vals[(i // nbloc)[:, None], :, (iloc // (ts * 128))[:, None],
             dpos[:, None] * bc + c_rng[None, :], (rem_i // 128)[:, None],
             (rem_i % 128)[:, None]] = data[kb].transpose(0, 2, 1)

    head_vals, tail_vals = _bdia_edge_windows(vals, kept, bc, nbloc, ts, T)

    # remainder: spilled blocks as scalar COO over the same row split
    rem = None
    rb = np.nonzero(~in_dia)[0]
    if rb.size:
        rr = ib[rb][:, None, None] * br + np.arange(br)[None, :, None]
        rc = indices[rb][:, None, None] * bc + np.arange(bc)[None, None, :]
        rr = np.broadcast_to(rr, (rb.size, br, bc)).ravel()
        rc = np.broadcast_to(rc, (rb.size, br, bc)).ravel()
        rv = data[rb].ravel()
        inside = (rr < m) & (rc < n) & (rv != 0)
        rem = _remainder(rv[inside], rr[inside], rc[inside], (m, n), P, mloc=mloc)

    return BdiaPartition(vals=vals, head_vals=head_vals, tail_vals=tail_vals, remainder=rem,
                         block_offsets=tuple(int(o) for o in kept), shape=(m, n),
                         blocksize=(br, bc), ts=ts, nshards=P, mloc=mloc, nbloc=nbloc)


def _fem_formula_val(i, dpos, r, c, dof: int):
    """Deterministic pseudo-values for the formulaic FEM builder: cheap,
    vectorized over block rows ``i``, identical in the direct pack and the
    small-size reference BSR."""
    h = (i.astype(np.int64) * 1000003 + int(dpos) * 7919 + int(r) * 211 + int(c) * 37) % 2003
    return h.astype(np.float64) / 2003.0 - 0.5


def fem_bdia_partition(nx: int, ny: Optional[int] = None, *, dof: int = 4, nshards: int,
                       dtype=np.float32, align_b: int = 1) -> BdiaPartition:
    """Formulaic BdiaPartition of the dof-block 5-point FEM matrix, with no
    CSR/BSR build (the BDIA analog of :func:`stencil_dia_partition`).

    Structurally identical to ``partition_bdia`` of :func:`fem_formula_bsr`
    with deterministic pseudo-values; each diagonal block gets ``+4·dof`` on
    its main diagonal, so the matrix is strictly diagonally dominant."""
    from cask_tpu_torch.ops.bdia import _pick_ts

    ny = ny or nx
    nbr = nx * ny
    P = nshards
    nbloc = _ceil_div(_ceil_div(nbr, P), align_b) * align_b
    offsets = tuple(sorted({-ny, -1, 0, 1, ny}))
    kept = np.asarray(offsets, dtype=np.int64)
    if np.abs(kept).max() > nbloc:
        raise ValueError(f"grid row length {ny} exceeds the {nbloc}-block shard — halo would "
                         "be multi-hop; use partition_bdia for this shape")
    ts = _pick_ts(nbloc)
    T = _ceil_div(nbloc, ts * 128)
    npairs = len(offsets) * dof

    g = np.arange(P * nbloc, dtype=np.int64)
    nb_pad = T * ts * 128  # per-shard padded block rows (tile aligned)
    vflat = np.zeros((dof, npairs, P, nb_pad), dtype=dtype)
    for dpos, off in enumerate(offsets):
        ok = _stencil_offset_mask(g, off, ny, nbr)
        for r in range(dof):
            for c in range(dof):
                v = _fem_formula_val(g, dpos, r, c, dof)
                if off == 0 and r == c:
                    v = v + 4.0 * dof
                vflat[r, dpos * dof + c, :, :nbloc] = \
                    np.where(ok, v, 0.0).astype(dtype).reshape(P, nbloc)
    vals = np.ascontiguousarray(
        vflat.reshape(dof, npairs, P, T, ts, 128).transpose(2, 0, 3, 1, 4, 5))
    del vflat
    head_vals, tail_vals = _bdia_edge_windows(vals, kept, dof, nbloc, ts, T)
    n = nbr * dof
    return BdiaPartition(vals=vals, head_vals=head_vals, tail_vals=tail_vals, remainder=None,
                         block_offsets=offsets, shape=(n, n), blocksize=(dof, dof), ts=ts,
                         nshards=P, mloc=nbloc * dof, nbloc=nbloc)


def fem_formula_bsr(nx: int, ny: Optional[int] = None, *, dof: int = 4,
                    dtype=np.float64) -> BSR:
    """The matrix :func:`fem_bdia_partition` encodes, as a host BSR (the
    small-size reference; build cost O(nnz))."""
    from cask_tpu_torch.formats.convert import coo_from_arrays, coo_to_csr, csr_to_bsr

    ny = ny or nx
    nbr = nx * ny
    offsets = tuple(sorted({-ny, -1, 0, 1, ny}))
    g = np.arange(nbr, dtype=np.int64)
    rows, cols, vals = [], [], []
    for dpos, off in enumerate(offsets):
        gi = g[_stencil_offset_mask(g, off, ny, nbr)]
        for r in range(dof):
            for c in range(dof):
                v = _fem_formula_val(gi, dpos, r, c, dof)
                if off == 0 and r == c:
                    v = v + 4.0 * dof
                rows.append(gi * dof + r)
                cols.append((gi + off) * dof + c)
                vals.append(v.astype(dtype))
    n = nbr * dof
    csr = coo_to_csr(coo_from_arrays(np.concatenate(vals), np.concatenate(rows),
                                     np.concatenate(cols), (n, n)))
    return csr_to_bsr(csr, (dof, dof))


_POH_FIELDS = ("vals", "cloc", "rloc", "wlo", "whi", "panel", "first", "last")


@dataclasses.dataclass(frozen=True, eq=False)
class PohPartition:
    """Row-partitioned panel one-hot packs (unstructured matrices).

    Per shard, two packs stacked over the leading shard axis: *interior*
    (columns local to the shard, computable before any collective lands)
    and *exterior* (columns indexing the all-gathered padded-global x).
    Shards with fewer tiles are padded with zero tiles assigned to the last
    row panel (they accumulate 0).
    """

    int_vals: np.ndarray  # (P, T_i, S, 128)
    int_cloc: np.ndarray
    int_rloc: np.ndarray
    int_wlo: np.ndarray  # (P, T_i)
    int_whi: np.ndarray
    int_panel: np.ndarray
    int_first: np.ndarray
    int_last: np.ndarray
    ext_vals: np.ndarray  # (P, T_e, S, 128)
    ext_cloc: np.ndarray
    ext_rloc: np.ndarray
    ext_wlo: np.ndarray
    ext_whi: np.ndarray
    ext_panel: np.ndarray
    ext_first: np.ndarray
    ext_last: np.ndarray
    shape: Tuple[int, int]
    nshards: int
    mloc: int
    row_panel: int
    col_window: int


def _stack_poh(plans) -> dict:
    """Stack same-geometry PohMatrix packs (host arrays), padding tile counts."""
    ntmax = max(p.ntiles for p in plans)
    npanels = plans[0].n_panels
    out = {}
    for f in _POH_FIELDS:
        fill = npanels - 1 if f == "panel" else 0
        arrs = []
        for p in plans:
            a = host(getattr(p, f))
            w = ntmax - a.shape[0]
            if w:
                a = np.concatenate([a, np.full((w,) + a.shape[1:], fill, dtype=a.dtype)])
            arrs.append(a)
        out[f] = np.stack(arrs)
    return out


def partition_poh(a: CSR, nshards: int, *, row_panel: int = 4096, col_window="auto",
                  tile_slots: int = 2048) -> PohPartition:
    """Row-partition an unstructured CSR into per-shard POH packs (each shard
    packed on the host by :func:`cask_tpu_torch.ops.poh.poh_plan`).

    The defaults are :func:`~cask_tpu_torch.ops.poh.poh_plan`'s, not the
    reference's (``col_window=1024, tile_slots=4096``, which give the same
    arrays as the reference's partition when passed): ``"auto"`` sizes one
    window for every shard from the whole matrix, so one shard's pack is
    ``poh_plan(a)``'s.  The reference's defaults pack a large power law
    into far more tiles, most of them nearly empty."""
    from cask_tpu_torch.formats.convert import coo_from_arrays, coo_to_csr
    from cask_tpu_torch.ops.poh import auto_col_window, poh_plan

    m, n = a.shape
    P = nshards
    mloc = _ceil_div(m, P)
    if n > P * mloc:
        raise ValueError(f"partition_poh requires n ({n}) <= nshards*mloc ({P * mloc})")
    data, rows, indices = _coo_arrays(a)
    owner_row = rows // mloc
    interior = (indices // mloc) == owner_row
    if col_window == "auto":
        col_window = auto_col_window(a.nnz, m, n, row_panel=row_panel,
                                     tile_slots=tile_slots)

    kw = dict(row_panel=row_panel, col_window=col_window, tile_slots=tile_slots, device="cpu")
    ints, exts = [], []
    for p in range(P):
        mine = owner_row == p
        mi = mine & interior
        me = mine & ~interior
        int_csr = coo_to_csr(coo_from_arrays(data[mi], rows[mi] - p * mloc,
                                             indices[mi] - p * mloc, (mloc, mloc)),
                             sum_duplicates=False)
        ext_csr = coo_to_csr(coo_from_arrays(data[me], rows[me] - p * mloc, indices[me],
                                             (mloc, P * mloc)), sum_duplicates=False)
        ints.append(poh_plan(int_csr, **kw))
        exts.append(poh_plan(ext_csr, **kw))

    si, se = _stack_poh(ints), _stack_poh(exts)
    return PohPartition(**{f"int_{k}": v for k, v in si.items()},
                        **{f"ext_{k}": v for k, v in se.items()},
                        shape=(m, n), nshards=P, mloc=mloc, row_panel=ints[0].row_panel,
                        col_window=ints[0].col_window)


@dataclasses.dataclass(frozen=True, eq=False)
class Coo2DPartition:
    """2-D block partition over a ``pr × pc`` grid (SUMMA-style SpMV).

    Rank ``(i, j)`` (``i·pc + j``) owns block ``A[i·mr:(i+1)·mr,
    j·mc:(j+1)·mc]`` as local COO.  x is split over the grid's columns
    (each rank holds n/pc entries), the partial products ``A_ij @ x_j`` are
    summed over the ranks of a grid row, and y lands split over the rows.
    """

    data: np.ndarray  # (pr*pc, E)
    row: np.ndarray  # (pr*pc, E) block-local row
    col: np.ndarray  # (pr*pc, E) block-local col
    shape: Tuple[int, int]
    pr: int
    pc: int
    mr: int
    mc: int


def partition_2d(a: CSR, pr: int, pc: int) -> Coo2DPartition:
    """Block-partition a CSR over a pr × pc grid of ranks."""
    m, n = a.shape
    mr = _ceil_div(m, pr)
    mc = _ceil_div(n, pc)
    data, rows, indices = _coo_arrays(a)
    bi = rows // mr
    bj = indices // mc

    groups_d, groups_r, groups_c = [], [], []
    for i in range(pr):
        for j in range(pc):
            sel = (bi == i) & (bj == j)
            groups_d.append(data[sel])
            groups_r.append(rows[sel] - i * mr)
            groups_c.append(indices[sel] - j * mc)
    E = max((g.shape[0] for g in groups_d), default=0) or 1
    P = pr * pc
    return Coo2DPartition(data=_pad_rows(groups_d, P, E, 0.0, data.dtype),
                          row=_pad_rows(groups_r, P, E), col=_pad_rows(groups_c, P, E),
                          shape=(m, n), pr=pr, pc=pc, mr=mr, mc=mc)
