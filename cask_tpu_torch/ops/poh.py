"""Panel one-hot ("POH") packed SpMV and SpMM — the unstructured-matrix path.

The PyTorch counterpart of the plan half of
:mod:`cask_tpu.ops.pallas.poh_kernels`.  Rows are grouped into row panels
of ``R`` rows; within a panel the entries are sorted by column and packed
densely into tiles of ``T`` slots, each tile cut where it is full or where
its columns would leave a ``2C``-wide window starting at segment ``wlo``.
Columns and rows are stored window- and panel-relative (``cloc``,
``rloc``); padding slots hold value 0 at local coordinate 0.

:func:`poh_plan` packs on the host exactly as the JAX package does, and the
plan's tensors then live on the device the caller names (by default the
CUDA device).  The reference also stores ``rloc`` transposed per tile
(``rloc_t``) so that every one-hot product on the TPU's matrix unit is NN;
the Hopper kernels gather and scatter directly and never read it, so the
port's plan leaves it out.  ``panel_ptr`` (the first tile of each panel,
built once with the plan on its device) is the port's own addition, and
so are the kernels' tables built from it and the pack, once with the plan:
``spmv_pieces`` and ``spmm_pieces``, the SpMV and SpMM kernels' work pieces
(panels cut into runs of at most about ntiles / (16 · 132) tiles, and of
about the mean tile count), and ``heavy_row``, each panel's two rows with
the most live slots, which the SpMV kernel sums in registers.

The products run in the CUDA kernels of
:mod:`cask_tpu_torch.ops.kernels.poh_kernels` on a CUDA device, or in
their plain twins on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from cask_tpu_torch.formats.convert import coo_to_csr
from cask_tpu_torch.formats.matrix import COO, CSR, host, to_device, torch_dtype, value_dtype
from cask_tpu_torch.ops.kernels.poh_kernels import (heavy_rows, poh_spmm, poh_spmv,
                                                    spmm_pieces, spmv_pieces)
from cask_tpu_torch.utils.platform import plan_device

_LANE = 128
_PRECISIONS = ("split", "fast", "highest")


def _check_precision(precision: str) -> None:
    """The reference's modes pick how its one-hot products round on the
    TPU's matrix unit; the Hopper kernels use plain FP32/FP64 FMAs, so every
    mode gives the same exact-class result.  An unknown mode still raises,
    as in the reference."""
    if precision not in _PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")


@dataclasses.dataclass(frozen=True, eq=False)
class PohMatrix:
    """Panel one-hot packed sparse matrix (see the module docstring).  All
    tensors live on one device."""

    vals: torch.Tensor  # (ntiles, S, 128)
    cloc: torch.Tensor  # (ntiles, S, 128) int32, col - wlo·C ∈ [0, 2C)
    rloc: torch.Tensor  # (ntiles, S, 128) int32, row - panel·R ∈ [0, R)
    wlo: torch.Tensor  # (ntiles,) int32 x-window segment index
    whi: torch.Tensor  # (ntiles,) int32 min(wlo + 1, nseg - 1)
    panel: torch.Tensor  # (ntiles,) int32 row-panel index, non-decreasing
    first: torch.Tensor  # (ntiles,) int32 1 = first tile of its panel
    last: torch.Tensor  # (ntiles,) int32 1 = last tile of its panel
    shape: Tuple[int, int]
    row_panel: int
    col_window: int
    # (n_panels + 1,) int32: panel I owns tiles panel_ptr[I] .. panel_ptr[I+1]
    panel_ptr: torch.Tensor = dataclasses.field(init=False, repr=False)
    # (P, 4) int32 (panel, first tile, end tile, cut): see spmm_pieces
    spmm_pieces: torch.Tensor = dataclasses.field(init=False, repr=False)
    # (P', 4) int32, the same for the SpMV kernel: see spmv_pieces
    spmv_pieces: torch.Tensor = dataclasses.field(init=False, repr=False)
    # (n_panels, 2) int32 rloc of each panel's two rows with most live slots, -1: none
    heavy_row: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        bounds = torch.arange(self.n_panels + 1, dtype=self.panel.dtype,
                              device=self.panel.device)
        object.__setattr__(self, "panel_ptr", torch.searchsorted(
            self.panel.contiguous(), bounds, out_int32=True))
        object.__setattr__(self, "spmm_pieces", spmm_pieces(self.panel_ptr))
        object.__setattr__(self, "spmv_pieces", spmv_pieces(self.panel_ptr))
        object.__setattr__(self, "heavy_row", heavy_rows(self.vals, self.rloc, self.panel,
                                                         self.n_panels, self.row_panel))

    @property
    def ntiles(self) -> int:
        return int(self.vals.shape[0])

    @property
    def slot_rows(self) -> int:
        return int(self.vals.shape[1])

    @property
    def n_panels(self) -> int:
        return -(-max(self.shape[0], 1) // self.row_panel)

    @property
    def nseg(self) -> int:
        return -(-max(self.shape[1], 1) // self.col_window)

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def traffic_bytes(self) -> int:
        """Device-memory bytes one SpMV must move on the port's kernel: the
        slot arrays ``vals``, ``cloc`` and ``rloc`` once, ``wlo`` per tile,
        x and y once.  (The reference's count adds its ``rloc_t``.)"""
        db = self.vals.element_size()
        m, n = self.shape
        return int(self.vals.numel() * (db + 8) + self.ntiles * 4 + (m + n) * db)

    def fill(self) -> float:
        true_nnz = int(torch.count_nonzero(self.vals))
        return true_nnz / max(self.vals.numel(), 1)

    def astype(self, dtype) -> "PohMatrix":
        """The plan with its values cast to ``dtype`` (the slot layout stays)."""
        return dataclasses.replace(self, vals=self.vals.to(torch_dtype(dtype)))

    def to(self, device) -> "PohMatrix":
        return PohMatrix(vals=self.vals.to(device), cloc=self.cloc.to(device),
                         rloc=self.rloc.to(device), wlo=self.wlo.to(device),
                         whi=self.whi.to(device), panel=self.panel.to(device),
                         first=self.first.to(device), last=self.last.to(device),
                         shape=self.shape, row_panel=self.row_panel,
                         col_window=self.col_window)

    def spmv(self, x: torch.Tensor, *, precision: str = "split") -> torch.Tensor:
        """``A·x``: the kernel on a CUDA device (raises on what it does not
        take), the plain twin on the CPU.  ``precision`` as the reference's
        (see :func:`_check_precision`)."""
        _check_precision(precision)
        return poh_spmv(self, x)

    def spmm(self, x: torch.Tensor, *, precision: str = "split") -> torch.Tensor:
        """``A·X`` for a dense row-major ``X (n, k)``, any k in one launch
        (the reference chunks k above 64, a TPU memory bound)."""
        _check_precision(precision)
        return poh_spmm(self, x)


def poh_plan(a: CSR, *, row_panel: int = 4096, col_window="auto",
             tile_slots: int = 2048, device=None) -> PohMatrix:
    """Pack a CSR matrix into panel one-hot tiles (host numpy, as the JAX
    package packs); the plan's tensors go to ``device`` (default: where
    ``a``'s tensors are, the CUDA device for host numpy arrays).

    ``row_panel`` (R): rows per panel.  ``col_window`` (C): x window
    granularity, the tile's window being 2C; ``"auto"`` sizes C to the
    expected column span of one tile's column-sorted slots.  ``tile_slots``
    (T): slots per tile, a multiple of 128.  R and C are at least 1024, the
    reference's floor (a TPU block-shape rule kept so plans coincide).
    """
    device = plan_device(a.data, device)
    vdt = value_dtype(a.data)  # bf16 values are planned as their exact f32
    m, n = a.shape
    if tile_slots % _LANE:
        raise ValueError("tile_slots must be a multiple of 128")
    _MINW = 8 * _LANE
    R = max(-(-row_panel // _LANE) * _LANE, _LANE)
    R = max(min(R, max(-(-m // _LANE) * _LANE, _LANE)), _MINW)
    if col_window == "auto":
        nnz_per_panel = max(a.nnz * R / max(m, 1), 1.0)
        span = tile_slots * max(n, 1) / nnz_per_panel
        col_window = 128
        while col_window < min(span, 8192):
            col_window *= 2
    C = max(-(-int(col_window) // _LANE) * _LANE, _MINW)
    S = tile_slots // _LANE
    T = tile_slots
    nseg = -(-max(n, 1) // C)
    npanels = -(-max(m, 1) // R)

    indptr = host(a.indptr).astype(np.int64)
    indices = host(a.indices).astype(np.int64)
    data = host(a.data)
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(indptr))

    tiles = []  # (panel, wlo, vals_slots, cloc_slots, rloc_slots)
    for I in range(npanels):
        lo, hi = I * R, min((I + 1) * R, m)
        s, e = int(indptr[lo]), int(indptr[hi])
        cols_p = indices[s:e]
        order = np.argsort(cols_p, kind="stable")
        cols_s = cols_p[order]
        vals_s = data[s:e][order]
        rows_s = rows[s:e][order] - lo
        P = cols_s.shape[0]
        start = 0
        emitted = 0
        while start < P:
            w0 = int(cols_s[start] // C)
            end_w = int(np.searchsorted(cols_s, (w0 + 2) * C, side="left"))
            end = min(start + T, end_w)
            tiles.append((I, w0, vals_s[start:end],
                          (cols_s[start:end] - w0 * C).astype(np.int32),
                          rows_s[start:end].astype(np.int32)))
            start = end
            emitted += 1
        if emitted == 0:  # an empty panel still gets a tile, as in the reference
            tiles.append((I, 0, data[:0], np.zeros(0, np.int32), np.zeros(0, np.int32)))

    ntiles = len(tiles)
    vals = np.zeros((ntiles, S, _LANE), dtype=data.dtype)
    cloc = np.zeros((ntiles, S, _LANE), dtype=np.int32)
    rloc = np.zeros((ntiles, S, _LANE), dtype=np.int32)
    wlo = np.zeros(ntiles, np.int32)
    panel = np.zeros(ntiles, np.int32)
    for t, (I, w0, v, c, r) in enumerate(tiles):
        k = v.shape[0]
        vals[t].reshape(-1)[:k] = v
        cloc[t].reshape(-1)[:k] = c
        rloc[t].reshape(-1)[:k] = r
        wlo[t] = w0
        panel[t] = I
    first = np.ones(ntiles, np.int32)
    first[1:] = (panel[1:] != panel[:-1]).astype(np.int32)
    last = np.ones(ntiles, np.int32)
    last[:-1] = (panel[1:] != panel[:-1]).astype(np.int32)

    return PohMatrix(
        vals=to_device(vals, device, vdt), cloc=to_device(cloc, device),
        rloc=to_device(rloc, device), wlo=to_device(wlo, device),
        whi=to_device(np.minimum(wlo + 1, nseg - 1).astype(np.int32), device),
        panel=to_device(panel, device), first=to_device(first, device),
        last=to_device(last, device), shape=(m, n), row_panel=R, col_window=C,
    )


def poh_to_coo(p: PohMatrix) -> COO:
    """Host-side scalar triples recovered from a pack (zero slots are
    structural padding and drop out)."""
    v = host(p.vals).reshape(p.ntiles, -1)
    r = host(p.rloc).reshape(p.ntiles, -1)
    c = host(p.cloc).reshape(p.ntiles, -1)
    ti, si = np.nonzero(v)
    rows = host(p.panel).astype(np.int64)[ti] * p.row_panel + r[ti, si]
    cols = host(p.wlo).astype(np.int64)[ti] * p.col_window + c[ti, si]
    return COO(data=v[ti, si], row=rows.astype(np.int32), col=cols.astype(np.int32),
               shape=p.shape)


def poh_transpose_plan(p: PohMatrix, **plan_kw) -> PohMatrix:
    """Pack for ``Aᵀ`` on the plan's device, in the plan's value type: a
    host-side one-time repack (the slot layout has no cheap in-place
    transpose).  Build once and reuse."""
    coo = poh_to_coo(p)
    coo_t = COO(data=coo.data, row=coo.col, col=coo.row, shape=(p.shape[1], p.shape[0]))
    plan_kw.setdefault("tile_slots", p.slot_rows * _LANE)
    plan_kw.setdefault("device", p.device)
    return poh_plan(coo_to_csr(coo_t), **plan_kw).astype(p.dtype)
