"""Block-diagonal-packed (BDIA) SpMV — the fast BSR SpMV path.

The PyTorch counterpart of :mod:`cask_tpu.ops.bdia`.  A ``b×b``-blocked
band is packed by block diagonal: for every kept block offset ``d`` and
block element ``(r, c)``, one full-density diagonal over the block index,
``y[i·br + r] += A_d[i][r, c] · x[(i + d)·bc + c]``.  The value stream is
exactly the stored blocks; blocks on sparse block diagonals spill to a
scalar COO remainder (HYB discipline).

Planning (:func:`bdia_plan`) is host numpy and packs ``vals`` exactly as
the JAX package does, ``(br, T, npairs, ts, 128)``; the plan's tensors then
live on the device the caller names.  The scalar-DIA plan that ``spmm``
multiplies with is derived from the pack on that device
(:func:`scalar_dia_from_pack`).  The product runs in the CUDA kernel
of :mod:`cask_tpu_torch.ops.kernels.bdia_kernels` on a CUDA device, or in
its plain twin on the CPU.  The TPU-only layouts (``to_resident``,
``to_bdia`` and the MXU permutation helpers) have no counterpart: the
Hopper kernel reads natural-order x directly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from cask_tpu_torch.formats.matrix import BSR, COO, CSR, host, to_device, torch_dtype, value_dtype
from cask_tpu_torch.ops.dia import _ROW_TILE, DiaMatrix, kept_offsets, remainder_spmm
from cask_tpu_torch.ops.kernels.bdia_kernels import (bdia_kernel_ok, bdia_spmv,
                                                     bdia_spmv_reference)
from cask_tpu_torch.utils.platform import plan_device
from cask_tpu_torch.utils.profiling import annotate

_LANE = 128
_COUNT_SLOTS = 1 << 24  # pack slots a chunk of the scalar-DIA count reads at once
_TS_CHOICES = (64, 32, 16, 8)  # value-tile sublanes (largest with low pad waste)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pick_ts(nbr: int) -> int:
    """Largest tile that keeps block-row padding waste ≤ 8 %."""
    for ts in _TS_CHOICES:
        pad = _round_up(max(nbr, 1), ts * _LANE)
        if (pad - nbr) / max(nbr, 1) <= 0.08:
            return ts
    return _TS_CHOICES[-1]


@dataclasses.dataclass(frozen=True, eq=False)
class BdiaMatrix:
    """Block-diagonal-packed matrix plus scalar COO remainder.

    ``vals[r, t, j, s, l]`` is the ``(r, c)`` element of the block at
    block row ``i = (t·TS + s)·128 + l`` on block offset ``d``, where
    ``j = dpos·bc + c`` enumerates the static ``pairs`` (block offset ×
    column component).  All four arrays are tensors on one device.
    """

    vals: torch.Tensor  # (br, T, npairs, TS, 128)
    rem_data: torch.Tensor  # scalar COO remainder (may be size 0)
    rem_row: torch.Tensor  # int32
    rem_col: torch.Tensor  # int32
    block_offsets: Tuple[int, ...]
    shape: Tuple[int, int]
    blocksize: Tuple[int, int]
    ts: int

    # -- geometry ---------------------------------------------------------

    @property
    def nbr(self) -> int:
        return -(-self.shape[0] // self.blocksize[0])

    @property
    def nbc(self) -> int:
        return -(-self.shape[1] // self.blocksize[1])

    @property
    def nb_pad(self) -> int:
        return self.n_tiles * self.ts * _LANE

    @property
    def n_tiles(self) -> int:
        return int(self.vals.shape[1])

    @property
    def npairs(self) -> int:
        return int(self.vals.shape[2])

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def lo(self) -> int:
        return -min(min(self.block_offsets), 0)

    @property
    def hi(self) -> int:
        return max(max(self.block_offsets), 0)

    @property
    def pairs(self) -> Tuple[Tuple[int, int], ...]:
        """Static (c, d) per vals slot j — the FMA schedule."""
        bc = self.blocksize[1]
        return tuple((c, d) for d in self.block_offsets for c in range(bc))

    @property
    def traffic_bytes(self) -> int:
        db = self.vals.element_size()
        return int(self.vals.numel() * db + self.rem_data.shape[0] * (db + 8))

    def to(self, device) -> "BdiaMatrix":
        return dataclasses.replace(
            self, vals=self.vals.to(device), rem_data=self.rem_data.to(device),
            rem_row=self.rem_row.to(device), rem_col=self.rem_col.to(device))

    def astype(self, dtype) -> "BdiaMatrix":
        dt = torch_dtype(dtype)
        return dataclasses.replace(self, vals=self.vals.to(dt),
                                   rem_data=self.rem_data.to(dt))

    # -- compute ----------------------------------------------------------

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        """``A·x``: the kernel on a CUDA device (raises on what it does not
        take), the plain twin on the CPU; the remainder added after."""
        return self._with_remainder(bdia_spmv(self, x), x)

    def _spmv_reference(self, x: torch.Tensor) -> torch.Tensor:
        """The same math in plain PyTorch on any device (the port of
        ``_spmv_xla``)."""
        return self._with_remainder(bdia_spmv_reference(self, x), x)

    def _with_remainder(self, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        if not self.rem_data.shape[0]:
            return y
        return y + remainder_spmm(self.rem_data, self.rem_row, self.rem_col, self.shape[0], x,
                                  y.dtype)


class BdiaOperator:
    """Solver-facing SpMV operator on a BDIA plan.

    The counterpart of the JAX package's resident-layout operator: every
    Krylov vector stays in one layout, so iterations pay no relayout.  On
    Hopper that layout is natural order (``to_padded``/``from_padded`` are
    identities), and ``__call__`` launches the same kernel as
    :meth:`BdiaMatrix.spmv`.  ``mode`` is ``"kernel"`` for a plan on a CUDA
    device and ``"reference"`` (the plain twin) for a plan on the CPU.
    """

    def __init__(self, a, blocksize: Optional[Tuple[int, int]] = None, *,
                 device=None):
        if not isinstance(a, BdiaMatrix):
            a = bdia_plan(a, blocksize, device=device)
        if a.vals.is_cuda and not bdia_kernel_ok(a):
            raise ValueError(f"the CUDA BDIA kernel cannot take this plan "
                             f"({a.npairs} pairs, {a.dtype})")
        self.bdia = a
        self.mode = "kernel" if a.vals.is_cuda else "reference"

    @property
    def device(self) -> torch.device:
        return self.bdia.device

    def to_padded(self, v) -> torch.Tensor:
        return torch.as_tensor(v, device=self.device)

    def from_padded(self, v: torch.Tensor) -> torch.Tensor:
        return v

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return self.bdia.spmv(v)


def bdia_plan(a: Union[BSR, CSR], blocksize: Optional[Tuple[int, int]] = None,
              *, min_density: float = 0.10, max_block_diags: int = 64,
              device=None) -> BdiaMatrix:
    """Pack a block matrix's dense-enough block diagonals; spill the rest
    to a scalar COO remainder.  Host numpy planning, exactly as the JAX
    package packs; the plan's tensors go to ``device`` (default: where the
    matrix's tensors are, the CUDA device for host numpy arrays)."""
    device = plan_device(a.data, device)
    vdt = value_dtype(a.data)  # bf16 values are planned as their exact f32
    if isinstance(a, CSR):
        if blocksize is None:
            raise ValueError("bdia_plan on CSR needs an explicit blocksize")
        from cask_tpu_torch.formats.convert import csr_to_bsr

        a = csr_to_bsr(a, blocksize)
    br, bc = a.blocksize
    m, n = a.shape
    nbr, nbc = a.n_block_rows, a.n_block_cols
    indptr = host(a.indptr).astype(np.int64)
    indices = host(a.indices).astype(np.int64)
    data = host(a.data)
    ib = np.repeat(np.arange(nbr, dtype=np.int64), np.diff(indptr))
    d = indices - ib

    uniq, counts = np.unique(d, return_counts=True)
    diag_len = np.minimum(np.minimum(nbr, nbc - uniq), np.minimum(nbc, nbr + uniq))
    density = counts / np.maximum(diag_len, 1)
    keep = density >= min_density
    if keep.sum() > max_block_diags:
        top = np.argsort(-counts)[:max_block_diags]
        keep = np.zeros_like(keep)
        keep[top] = True
    kept = uniq[keep]
    if len(kept) == 0:
        kept = np.array([0], dtype=np.int64)
    in_dia = np.isin(d, kept)

    ts = _pick_ts(nbr)
    nb_pad = _round_up(max(nbr, 1), ts * _LANE)
    T = nb_pad // (ts * _LANE)
    npairs = len(kept) * bc
    vals = np.zeros((br, T, npairs, ts, _LANE), dtype=data.dtype)

    kb = np.nonzero(in_dia)[0]
    if kb.size:
        i = ib[kb]
        dpos = np.searchsorted(kept, d[kb])
        t_idx = i // (ts * _LANE)
        rem_i = i % (ts * _LANE)
        s_idx = rem_i // _LANE
        l_idx = rem_i % _LANE
        c_rng = np.arange(bc)
        vals[
            :,
            t_idx[:, None],
            dpos[:, None] * bc + c_rng[None, :],
            s_idx[:, None],
            l_idx[:, None],
        ] = data[kb].transpose(1, 0, 2)

    # spill remainder blocks to scalar COO triples
    rb = np.nonzero(~in_dia)[0]
    if rb.size:
        ri = ib[rb]
        rj = indices[rb]
        rr = (ri[:, None, None] * br + np.arange(br)[None, :, None])
        rc = (rj[:, None, None] * bc + np.arange(bc)[None, None, :])
        rr = np.broadcast_to(rr, (rb.size, br, bc)).ravel()
        rc = np.broadcast_to(rc, (rb.size, br, bc)).ravel()
        rv = data[rb].ravel()
        inside = (rr < m) & (rc < n) & (rv != 0)
        rem_data, rem_row, rem_col = rv[inside], rr[inside], rc[inside]
    else:
        rem_data = np.zeros((0,), data.dtype)
        rem_row = np.zeros((0,), np.int32)
        rem_col = np.zeros((0,), np.int32)

    return BdiaMatrix(
        vals=to_device(vals, device, vdt),
        rem_data=to_device(rem_data, device, vdt),
        rem_row=to_device(rem_row.astype(np.int32), device),
        rem_col=to_device(rem_col.astype(np.int32), device),
        block_offsets=tuple(int(o) for o in kept),
        shape=(m, n),
        blocksize=(br, bc),
        ts=ts,
    )


def bdia_to_coo(a: BdiaMatrix) -> COO:
    """Host-side scalar triples of the packed matrix (plan introspection
    and transpose builds).  Structural zeros in stored blocks drop out —
    they carry no value and re-form at the next ``bdia_plan``."""
    br, bc = a.blocksize
    m, n = a.shape
    vflat = np.moveaxis(host(a.vals), 2, 1).reshape(br, a.npairs, -1)
    vflat = vflat[:, :, : a.nbr]
    r_i, j_i, i_i = np.nonzero(vflat)
    offs = np.asarray(a.block_offsets, dtype=np.int64)
    d = offs[j_i // bc]
    rows = i_i * br + r_i
    cols = (i_i + d) * bc + (j_i % bc)
    vals = vflat[r_i, j_i, i_i]
    ok = (rows < m) & (cols >= 0) & (cols < n)
    rows = np.concatenate([rows[ok], host(a.rem_row).astype(np.int64)])
    cols = np.concatenate([cols[ok], host(a.rem_col).astype(np.int64)])
    vals = np.concatenate([vals[ok], host(a.rem_data)])
    return COO(data=vals, row=rows.astype(np.int32),
               col=cols.astype(np.int32), shape=(m, n))


def _ordered_sums(keys: torch.Tensor, vals: torch.Tensor):
    """``(unique keys ascending, their sums)``: each key's values added to
    a zero in their order in ``keys`` (a stable sort), one rounding an
    add, as ``coo_to_csr`` sums duplicates with ``np.add.at``.  One pass
    per duplicate rank, so no two adds of a pass meet one sum."""
    if not keys.numel():
        return keys, vals
    keys, order = torch.sort(keys, stable=True)
    vals = vals[order]
    first = torch.ones_like(keys, dtype=torch.bool)
    first[1:] = keys[1:] != keys[:-1]
    seg = first.cumsum(0) - 1
    rank = torch.arange(keys.numel(), device=keys.device) - first.nonzero()[:, 0][seg]
    sums = vals.new_zeros(int(seg[-1]) + 1)
    for q in range(int(rank.max()) + 1):
        at = rank == q
        sums[seg[at]] += vals[at]
    return keys[first], sums


def scalar_dia_from_pack(a: BdiaMatrix) -> DiaMatrix:
    """``dia_plan(coo_to_csr(bdia_to_coo(a)), device=a.device).astype(a.dtype)``,
    bit for bit, derived from the pack with tensor ops on the plan's own
    device: no host pass over the slots, and with square blocks no sort.

    Slot ``(r, j = dpos·bc + c)`` of block row ``i`` is scalar entry
    ``(i·br + r, (i + D[dpos])·bc + c)``, on scalar diagonal
    ``D[dpos]·bc + c − r + i·(bc − br)``.  Its in-bounds block rows are one
    range ``[lo, hi)``.  With square blocks the diagonal is the same for
    every ``i``, so each slot pair ``(r, j)`` is a lane: one strided copy
    into its diagonal's row of the DIA values.  Other blocks scatter a pair
    over many diagonals, and their nonzero slots are taken as entries, as
    the remainder's are.  Three steps, each a span:

    - ``plan.scalar_dia.count``: the nonzero slots of each lane's range
      (NaN counts, −0.0 does not, as ``np.nonzero``), and each position of
      the entries not already counted, by scalar diagonal; the keep rule
      (:func:`cask_tpu_torch.ops.dia.kept_offsets`) runs on the host over
      those per-diagonal counts alone;
    - ``plan.scalar_dia.fill``: the kept lanes' copies, −0.0 made +0.0 on
      the way (the host route drops −0.0 and leaves the pad's +0.0);
    - ``plan.scalar_dia.remainder``: the nonzero slots of spilled lanes and
      the entries (the remainder's all, zeros too, as ``bdia_to_coo`` keeps
      them), summed by position in CSR order, the pack's value first; sums
      on a kept diagonal overwrite its DIA value, the rest is the plan's
      remainder.  bf16 values are summed as their exact f32 and rounded
      once, as the host route plans them.
    """
    br, bc = a.blocksize
    m, n = a.shape
    dev, dt = a.device, a.dtype
    acc = torch.float32 if dt == torch.bfloat16 else dt
    lanes = br == bc
    vflat = a.vals.movedim(2, 1)  # (br, npairs, T, ts, 128): [r, j] walks block rows in order
    r = np.arange(br)[:, None]
    j = np.arange(a.npairs)[None, :]
    c = j % bc
    d = np.asarray(a.block_offsets, dtype=np.int64)[j // bc]
    offs = d * bc + c - r  # (br, npairs): each lane's diagonal
    # in bounds: i < nbr, i·br + r < m and 0 <= (i + D)·bc + c < n
    lo = np.broadcast_to(np.maximum(-d, 0), (br, a.npairs))
    hi = np.maximum(np.minimum(np.minimum(a.nbr, -(-(m - r) // br)), -(-(n - c) // bc) - d), lo)
    keys = [torch.zeros(0, dtype=torch.long, device=dev)]  # entries: positions and values,
    sums = [torch.zeros(0, dtype=acc, device=dev)]  # the pack's ahead of the remainder's

    with annotate("plan.scalar_dia.count"):
        pair_nnz = torch.zeros((br, a.npairs), dtype=torch.long, device=dev)
        lo_t, hi_t = (torch.tensor(t, device=dev)[:, :, None, None, None] for t in (lo, hi))
        tile = a.ts * _LANE
        step = max(1, _COUNT_SLOTS // (br * a.npairs * tile))  # tiles a chunk
        for t0 in range(0, a.n_tiles, step):  # in chunks: a sum widens its mask to int64
            v = vflat[:, :, t0:t0 + step]
            i = torch.arange(t0 * tile, t0 * tile + v[0, 0].numel(), device=dev)
            i = i.view(-1, a.ts, _LANE)
            nz = v != 0
            nz &= i >= lo_t
            nz &= i < hi_t
            if lanes:
                pair_nnz += nz.sum((2, 3, 4))
                continue
            pr, pj, pt, ps, pl = nz.nonzero().unbind(1)
            ib = ((pt + t0) * a.ts + ps) * _LANE + pl
            keys.append((ib * br + pr) * n
                        + (ib + torch.tensor(d[0], device=dev)[pj]) * bc + pj % bc)
            sums.append(v[nz].to(acc))
        pair_nnz = pair_nnz.cpu().numpy()
        uncounted = list(keys)  # positions the lanes' counts missed
        if a.rem_data.shape[0]:
            rrow, rcol = a.rem_row.long(), a.rem_col.long()
            rkey = rrow * n + rcol
            # the lane slot at each remainder position, where its block offset is packed
            bo, perm = torch.sort(torch.tensor(a.block_offsets, device=dev))
            dblk = rcol // bc - rrow // br
            at = torch.searchsorted(bo, dblk).clamp_(max=bo.numel() - 1)
            on_lane = (bo[at] == dblk) & lanes
            ib = rrow // br
            slot = a.vals[rrow % br, ib // tile, perm[at] * bc + rcol % bc,
                          ib // _LANE % a.ts, ib % _LANE]
            slot = torch.where(on_lane, slot, torch.zeros_like(slot))
            uncounted.append(rkey[~(on_lane & (slot != 0))])
        new = torch.unique(torch.cat(uncounted))
        extra = [t.cpu().numpy() for t in torch.unique(new % n - new // n, return_counts=True)]
        uniq, inv = np.unique(np.concatenate([offs.ravel(), extra[0]]), return_inverse=True)
        counts = np.zeros(uniq.shape, np.int64)
        np.add.at(counts, inv, np.concatenate([pair_nnz.ravel(), extra[1]]))
        kept = kept_offsets(uniq[counts > 0], counts[counts > 0], (m, n))

    row_of = {int(o): k for k, o in enumerate(kept)}
    spilled = []
    with annotate("plan.scalar_dia.fill"):
        vals = torch.zeros((max(len(kept), 1), -(-max(m, 1) // _ROW_TILE) * _ROW_TILE),
                           dtype=dt, device=dev)
        for pr, pj in zip(*np.nonzero(pair_nnz)):
            k, p0, p1 = row_of.get(int(offs[pr, pj])), int(lo[pr, pj]), int(hi[pr, pj])
            if k is None:
                spilled.append((pr, pj, p0, p1))
                continue
            lane = torch.add(vflat[pr, pj], 0.0).view(-1)[p0:p1]  # a copy; −0.0 + 0.0 = +0.0
            vals[k, p0 * br + pr:(p1 - 1) * br + pr + 1:br] = lane

    with annotate("plan.scalar_dia.remainder"):
        kept_dev = torch.as_tensor(kept, device=dev)
        for pr, pj, p0, p1 in spilled:  # the spilled lanes' nonzero slots
            lane = vflat[pr, pj].reshape(-1)[p0:p1]
            hit = lane.nonzero()[:, 0]
            ib = hit + p0
            keys.append((ib * br + pr) * n + (ib + int(d[0, pj])) * bc + int(c[0, pj]))
            sums.append(lane[hit].to(acc))
        if a.rem_data.shape[0]:
            # a remainder position on a kept lane's slot: the slot's value, once
            on_kept = on_lane & torch.isin(rcol - rrow, kept_dev)
            pos, inv = torch.unique(rkey[on_kept], return_inverse=True)
            keys += [pos, rkey]
            sums += [slot.new_zeros(pos.shape).scatter_(0, inv, slot[on_kept]).to(acc),
                     a.rem_data.to(acc)]
        key, total = _ordered_sums(torch.cat(keys), torch.cat(sums))
        row, col = key // n, key % n
        to_dia = torch.isin(col - row, kept_dev)
        vals[torch.searchsorted(kept_dev, (col - row)[to_dia]), row[to_dia]] = total[to_dia].to(dt)
        rest = ~to_dia

    return DiaMatrix(
        vals=vals, rem_data=total[rest].to(dt), rem_row=row[rest].int(), rem_col=col[rest].int(),
        vals_t=None, offsets=tuple(int(o) for o in kept) or (0,), shape=(m, n))


def bdia_scalar_dia(a: BdiaMatrix) -> DiaMatrix:
    """The scalar-DIA plan of the plan's expanded block structure,
    ``dia_plan(coo_to_csr(bdia_to_coo(a)))`` on the plan's device: what
    ``spmm`` on a BDIA plan multiplies with.  Derived on that device by
    :func:`scalar_dia_from_pack`, once per plan, and held in the one plan
    cache (:data:`cask_tpu_torch.ops.spmv.default_plan_cache`), so a solver
    loop pays it once."""
    from cask_tpu_torch.ops.spmv import default_plan_cache  # spmv imports this module

    return default_plan_cache.get(a)


def transpose_plan(a: BdiaMatrix, *, min_density: float = 0.10,
                   max_block_diags: int = 64) -> BdiaMatrix:
    """Plan for ``Aᵀ``: block offsets negate, blocks transpose, the
    blocksize swaps.  A host-side one-time rebuild onto the plan's device;
    iterating callers should hold both plans, not transpose per op."""
    from cask_tpu_torch.formats.convert import coo_to_csr

    coo = bdia_to_coo(a)
    coo_t = COO(data=coo.data, row=coo.col, col=coo.row,
                shape=(coo.shape[1], coo.shape[0]))
    br, bc = a.blocksize
    return bdia_plan(coo_to_csr(coo_t), (bc, br), min_density=min_density,
                     max_block_diags=max_block_diags, device=a.device).astype(a.dtype)


def estimate_bdia_traffic(a: CSR, b: int) -> Optional[Tuple[float, float]]:
    """Analytic tuner prefilter: (streamed entries, block fill fraction)
    under a (b, b) BDIA split, or None when clearly unprofitable.

    O(nnz) numpy; mirrors :func:`cask_tpu_torch.ops.dia.estimate_dia_traffic`
    but at block granularity (block presence deduplicated per block).  The
    entries per block are counted over runs of one block first (a CSR row's
    sorted columns), which gives the reference's counts from a smaller
    sort."""
    m, n = a.shape
    nbr, nbc = -(-m // b), -(-n // b)
    indptr = host(a.indptr).astype(np.int64)
    indices = host(a.indices).astype(np.int64)
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(indptr))
    keys = (rows // b) * nbc + (indices // b)
    starts = np.flatnonzero(np.concatenate(([True], keys[1:] != keys[:-1]))) if keys.size \
        else np.zeros(0, np.int64)
    run_len = np.diff(np.append(starts, keys.size))
    ukeys, inv = np.unique(keys[starts], return_inverse=True)
    kcounts = np.bincount(inv.ravel(), weights=run_len, minlength=ukeys.size)
    d = (ukeys % nbc) - (ukeys // nbc)
    uniq, idx = np.unique(d, return_inverse=True)
    counts = np.bincount(idx)  # blocks per block diagonal
    scalar_per_diag = np.bincount(idx, weights=kcounts)  # true entries
    diag_len = np.minimum(np.minimum(nbr, nbc - uniq), np.minimum(nbc, nbr + uniq))
    density = counts / np.maximum(diag_len, 1)
    keep = density >= 0.10
    if keep.sum() > 64:
        keep &= counts >= np.sort(counts[keep])[-64]
    covered = scalar_per_diag[keep].sum() / max(a.nnz, 1)
    if covered < 0.5 or not keep.any():
        return None
    streamed = float(keep.sum()) * b * b * nbr
    rem = float(scalar_per_diag[~keep].sum())
    fill = scalar_per_diag[keep].sum() / max(streamed, 1.0)
    if fill < 0.25:  # block diagonals exist but blocks are mostly empty
        return None
    return streamed + rem * 3.0, float(fill)
