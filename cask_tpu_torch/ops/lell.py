"""Grouped lane-bucketed ELL ("LELL") SpMV — the unstructured-matrix path.

The PyTorch counterpart of the plan half of
:mod:`cask_tpu.ops.pallas.lell_kernels`.  Lane ``l = g·B + b`` of a
128-lane slot row serves output-row group ``g`` (rows ``i`` with
``i % G == g``) and x bucket ``b`` (columns ``c`` with ``c % B == b``),
``G·B = 128``: entry ``(i, c)`` lives in slot row ``i // G``, lane
``(i % G)·B + c % B``, and stores ``c // B`` as its index.  Entries that
collide stack into layers; rows past ``max_layers`` spill to a COO
remainder (HYB).  :func:`lell_plan_hyb` sends rows heavy enough to overflow
the layer budget to a hub tier instead (:class:`ChunkedLell`: each hub row
owns several slot rows, all 128 lanes feeding it, folded by a segment sum).

Planning is host numpy and packs exactly as the JAX package does; the
plan's tensors then live on the device the caller names (by default the
CUDA device).  The packed sums run in the CUDA kernel of
:mod:`cask_tpu_torch.ops.kernels.lell_kernels` on a CUDA device, or its
plain twin on the CPU; the hub tier's segment sum and the remainder are
plain PyTorch (``index_add_``), as they are XLA outside the reference's
kernel.  The reference's kernel refuses a matrix wider than 4096·B columns
(``_SB_CAP``); the port takes any width.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from cask_tpu_torch.formats.convert import coo_from_arrays, coo_to_csr
from cask_tpu_torch.formats.matrix import CSR, host, to_device
from cask_tpu_torch.ops.kernels.lell_kernels import lell_lane_sums, lell_lane_sums_reference
from cask_tpu_torch.utils.platform import plan_device

_LANE = 128
_ROWS = 64  # slot rows are padded to a multiple of this (the reference's tile)


@dataclasses.dataclass(frozen=True, eq=False)
class LellMatrix:
    """Layered grouped lane-bucketed ELL + COO remainder.  All tensors live
    on one device."""

    vals: torch.Tensor  # (L, S_pad, 128)
    idx: torch.Tensor  # (L, S_pad, 128) int32 column // B (padding: 0, value 0)
    rem_data: torch.Tensor
    rem_row: torch.Tensor  # int32
    rem_col: torch.Tensor  # int32
    shape: Tuple[int, int]
    groups: int

    @property
    def layers(self) -> int:
        return int(self.vals.shape[0])

    @property
    def s_pad(self) -> int:
        return int(self.vals.shape[1])

    @property
    def bucket(self) -> int:
        return _LANE // self.groups

    @property
    def traffic_bytes(self) -> int:
        db = self.vals.element_size()
        return int(self.vals.numel() * (db + 4) + self.rem_data.shape[0] * (db + 8))

    def fill(self) -> float:
        return int(torch.count_nonzero(self.vals)) / max(self.vals.numel(), 1)

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        """``A·x``: the packed layers' group sums (kernel on a CUDA device,
        twin on the CPU), then the COO remainder."""
        return self._spmv(x, lell_lane_sums)

    def _spmv_reference(self, x: torch.Tensor) -> torch.Tensor:
        """The same math with the plain twin on any device."""
        return self._spmv(x, lell_lane_sums_reference)

    def _spmv(self, x, lane_sums):
        m = self.shape[0]
        y = lane_sums(self.vals, self.idx, x, self.groups).reshape(-1)[:m]
        if y.shape[0] < m:
            # trailing empty rows past the last packed slot row: the slot rows
            # stop there, so y is padded (the reference returns it short)
            y = torch.cat([y, y.new_zeros(m - y.shape[0])])
        if self.rem_data.shape[0]:
            prod = (self.rem_data * x[self.rem_col.long()]).to(y.dtype)
            y = y.index_add(0, self.rem_row.long(), prod)
        return y


def lell_plan(a: CSR, *, max_layers: int = 6, groups: int = 8, device=None) -> LellMatrix:
    """Pack a CSR into grouped lane-bucketed layers; overflow → COO.  The
    tensors go to ``device`` (default: where ``a``'s tensors are, the CUDA
    device for host numpy arrays)."""
    if _LANE % groups:
        raise ValueError("groups must divide 128")
    device = plan_device(a.data, device)
    B = _LANE // groups
    m, n = a.shape
    indptr = host(a.indptr).astype(np.int64)
    indices = host(a.indices).astype(np.int64)
    data = host(a.data)
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(indptr))

    lane = (rows % groups) * B + indices % B
    srow = rows // groups
    inlane = (indices // B).astype(np.int32)

    order = np.lexsort((inlane, lane, srow))
    s_s, l_s = srow[order], lane[order]
    key = s_s * _LANE + l_s
    new_grp = np.empty(key.shape, dtype=bool)
    if key.size:
        new_grp[0] = True
        np.not_equal(key[1:], key[:-1], out=new_grp[1:])
    grp_start = np.maximum.accumulate(np.where(new_grp, np.arange(key.size), 0))
    layer = np.arange(key.size) - grp_start

    keep = layer < max_layers
    L = int(layer[keep].max()) + 1 if np.any(keep) else 1
    s_pad = -(-max(int(srow.max(initial=0)) + 1, 1) // _ROWS) * _ROWS

    vals = np.zeros((L, s_pad, _LANE), dtype=data.dtype)
    idx = np.zeros((L, s_pad, _LANE), dtype=np.int32)
    vals[layer[keep], s_s[keep], l_s[keep]] = data[order][keep]
    idx[layer[keep], s_s[keep], l_s[keep]] = inlane[order][keep]

    spill = ~keep
    return LellMatrix(
        vals=to_device(vals, device), idx=to_device(idx, device),
        rem_data=to_device(data[order][spill], device),
        rem_row=to_device(rows[order][spill].astype(np.int32), device),
        rem_col=to_device(indices[order][spill].astype(np.int32), device),
        shape=(m, n), groups=groups,
    )


@dataclasses.dataclass(frozen=True, eq=False)
class ChunkedLell:
    """Hub-row tier: each heavy row owns degree-proportional *chunk* slot
    rows (all 128 lanes feed one output row), folded by a segment sum."""

    vals: torch.Tensor  # (L, S_pad, 128)
    idx: torch.Tensor  # (L, S_pad, 128) int32 column // 128
    slot2row: torch.Tensor  # (S_pad,) int32 original row id (padding → m)
    shape: Tuple[int, int]

    @property
    def layers(self) -> int:
        return int(self.vals.shape[0])

    @property
    def traffic_bytes(self) -> int:
        return int(self.vals.numel() * (self.vals.element_size() + 4))

    def fill(self) -> float:
        return int(torch.count_nonzero(self.vals)) / max(self.vals.numel(), 1)

    def spmv_partial(self, x: torch.Tensor) -> torch.Tensor:
        """Per-row partial sums (length m, zeros for non-hub rows)."""
        return self._partial(x, lell_lane_sums)

    def _partial(self, x, lane_sums):
        m = self.shape[0]
        sums = lane_sums(self.vals, self.idx, x, 1).reshape(-1)  # (S_pad,)
        return sums.new_zeros(m + 1).index_add_(0, self.slot2row.long(), sums)[:m]


@dataclasses.dataclass(frozen=True, eq=False)
class HybLell:
    """Degree-tiered pack: grouped LELL for the bulk, the chunked tier for
    hub rows, COO for residual overflow."""

    main: LellMatrix
    hub: ChunkedLell

    @property
    def shape(self):
        return self.main.shape

    @property
    def traffic_bytes(self) -> int:
        return self.main.traffic_bytes + self.hub.traffic_bytes

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        """``A·x``: the kernel on each tier on a CUDA device (the twin on the
        CPU), the hub rows' segment sum and the remainder in PyTorch."""
        y = self.main.spmv(x)
        if self.hub.vals.shape[1] > 0:
            y = y + self.hub.spmv_partial(x)
        return y

    def _spmv_reference(self, x: torch.Tensor) -> torch.Tensor:
        """The same math with the plain twin on any device."""
        y = self.main._spmv_reference(x)
        if self.hub.vals.shape[1] > 0:
            y = y + self.hub._partial(x, lell_lane_sums_reference)
        return y


def _pack_chunked_arrays(m, rows, indices, data, chunk_layers: int, dtype):
    """Chunk-pack hub entries: slot row = (row, chunk); every lane feeds
    that one output row.  Returns (vals, idx, slot2row) numpy arrays."""
    lane = indices % _LANE
    inlane = (indices // _LANE).astype(np.int32)
    if rows.size == 0:
        return (np.zeros((1, 0, _LANE), dtype=dtype), np.zeros((1, 0, _LANE), np.int32),
                np.zeros(0, np.int32))
    order = np.lexsort((inlane, lane, rows))
    r_s, l_s = rows[order], lane[order]
    key = r_s * _LANE + l_s
    new_grp = np.empty(key.shape, dtype=bool)
    new_grp[0] = True
    np.not_equal(key[1:], key[:-1], out=new_grp[1:])
    grp_start = np.maximum.accumulate(np.where(new_grp, np.arange(key.size), 0))
    k_in_lane = np.arange(key.size) - grp_start  # ordinal within (row, lane)
    chunk = k_in_lane // chunk_layers
    layer = k_in_lane % chunk_layers

    uniq_rows, row_comp = np.unique(r_s, return_inverse=True)
    nchunks = np.zeros(uniq_rows.shape[0], dtype=np.int64)
    np.maximum.at(nchunks, row_comp, chunk + 1)
    chunk_base = np.zeros(uniq_rows.shape[0] + 1, dtype=np.int64)
    np.cumsum(nchunks, out=chunk_base[1:])
    S = int(chunk_base[-1])
    S_pad = -(-max(S, 1) // _ROWS) * _ROWS

    slot = chunk_base[row_comp] + chunk
    L = int(layer.max()) + 1
    vals = np.zeros((L, S_pad, _LANE), dtype=dtype)
    idx = np.zeros((L, S_pad, _LANE), dtype=np.int32)
    vals[layer, slot, l_s] = data[order]
    idx[layer, slot, l_s] = inlane[order]
    slot2row = np.full(S_pad, m, dtype=np.int32)  # padding slots → the dropped segment
    slot2row[:S] = np.repeat(uniq_rows, nchunks).astype(np.int32)
    return vals, idx, slot2row


def lell_plan_hyb(a: CSR, *, groups: int = 8, max_layers: int = 6, chunk_layers: int = 4,
                  device=None) -> HybLell:
    """Tiered pack.  A row goes to the hub tier when its expected per-lane
    load in the grouped pack exceeds the layer budget.  The tensors go to
    ``device`` (default as :func:`lell_plan`)."""
    device = plan_device(a.data, device)
    m, n = a.shape
    lens = np.diff(host(a.indptr).astype(np.int64))
    B = _LANE // groups
    hub_mask = lens > (max_layers * B) // 2

    all_rows = np.repeat(np.arange(m, dtype=np.int64), lens)
    indices = host(a.indices).astype(np.int64)
    data = host(a.data)
    sel_hub = hub_mask[all_rows]

    main_csr = coo_to_csr(
        coo_from_arrays(data[~sel_hub], all_rows[~sel_hub], indices[~sel_hub], (m, n)),
        sum_duplicates=False,
    )
    main = lell_plan(main_csr, max_layers=max_layers, groups=groups, device=device)
    vals, idx, slot2row = _pack_chunked_arrays(m, all_rows[sel_hub], indices[sel_hub],
                                               data[sel_hub], chunk_layers, dtype=data.dtype)
    hub = ChunkedLell(vals=to_device(vals, device), idx=to_device(idx, device),
                      slot2row=to_device(slot2row, device), shape=(m, n))
    return HybLell(main=main, hub=hub)
