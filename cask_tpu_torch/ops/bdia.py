"""Block-diagonal-packed (BDIA) SpMV — the fast BSR SpMV path.

The PyTorch counterpart of :mod:`cask_tpu.ops.bdia`.  A ``b×b``-blocked
band is packed by block diagonal: for every kept block offset ``d`` and
block element ``(r, c)``, one full-density diagonal over the block index,
``y[i·br + r] += A_d[i][r, c] · x[(i + d)·bc + c]``.  The value stream is
exactly the stored blocks; blocks on sparse block diagonals spill to a
scalar COO remainder (HYB discipline).

Planning (:func:`bdia_plan`) is host numpy and packs ``vals`` exactly as
the JAX package does, ``(br, T, npairs, ts, 128)``; the plan's tensors then
live on the device the caller names.  The product runs in the CUDA kernel
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

from cask_tpu_torch.formats.matrix import BSR, COO, CSR, host, to_device, torch_dtype
from cask_tpu_torch.ops.kernels.bdia_kernels import (bdia_kernel_ok, bdia_spmv,
                                                     bdia_spmv_reference)

_LANE = 128
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
        y = bdia_spmv(self, x)
        if self.rem_data.shape[0]:
            y = y + self._remainder_spmv(x)
        return y

    def _spmv_reference(self, x: torch.Tensor) -> torch.Tensor:
        """The same math in plain PyTorch on any device (the port of
        ``_spmv_xla``)."""
        y = bdia_spmv_reference(self, x)
        if self.rem_data.shape[0]:
            y = y + self._remainder_spmv(x)
        return y

    def _remainder_spmv(self, x: torch.Tensor) -> torch.Tensor:
        prod = self.rem_data * x[self.rem_col.long()]
        return prod.new_zeros(self.shape[0]).index_add_(0, self.rem_row.long(), prod)


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

    def to_padded(self, v) -> torch.Tensor:
        return torch.as_tensor(v, device=self.bdia.device)

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
    matrix's arrays are, the CPU for numpy)."""
    if device is None:
        device = a.data.device if isinstance(a.data, torch.Tensor) else "cpu"
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
        vals=to_device(vals, device),
        rem_data=to_device(rem_data, device),
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
                     max_block_diags=max_block_diags, device=a.device)
