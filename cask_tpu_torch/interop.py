"""Build the port's objects from the JAX package's fields.

A matrix or plan of :mod:`cask_tpu` crosses over as its arrays (numpy,
e.g. ``np.asarray(plan.vals)``) plus its static metadata; nothing here
imports JAX.  The result's arrays are tensors on ``device``, but for the
partitions of :mod:`cask_tpu.parallel` (``*_partition_from_arrays``), whose
arrays stay host numpy: each rank of a distributed executor moves its own
shard to its device.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from cask_tpu_torch.formats.matrix import BSR, CSR, to_device
from cask_tpu_torch.ops.bdia import _LANE, BdiaMatrix
from cask_tpu_torch.ops.bdia_slab import BdiaSlabs
from cask_tpu_torch.ops.bsr_spmm import BsrSpmmKernel
from cask_tpu_torch.ops.dia import DiaMatrix
from cask_tpu_torch.ops.lell import ChunkedLell, HybLell, LellMatrix
from cask_tpu_torch.ops.add import AddPlan
from cask_tpu_torch.ops.ilu import ILU0Factors, ilu0_factors
from cask_tpu_torch.ops.poh import PohMatrix
from cask_tpu_torch.ops.spgemm import SpGEMMPlan
from cask_tpu_torch.ops.trisolve import TriSolvePlan
from cask_tpu_torch.parallel.partition import (_POH_FIELDS, BdiaPartition, Coo2DPartition,
                                               CooPartition, DiaPartition, PohPartition)


def _index(x, name: str) -> np.ndarray:
    a = np.asarray(x)
    if a.ndim != 1 or a.dtype.kind not in "iu":
        raise ValueError(f"{name} must be a 1-D integer array, got {a.dtype} {a.shape}")
    return a.astype(np.int32)


def csr_from_arrays(data, indices, indptr, shape: Tuple[int, int], *, device) -> CSR:
    m, n = (int(s) for s in shape)
    data = np.asarray(data)
    indices, indptr = _index(indices, "indices"), _index(indptr, "indptr")
    if data.shape != indices.shape or indptr.shape != (m + 1,):
        raise ValueError("CSR arrays disagree with each other or with the shape")
    return CSR(data=to_device(data, device), indices=to_device(indices, device),
               indptr=to_device(indptr, device), shape=(m, n))


def bsr_from_arrays(data, indices, indptr, shape: Tuple[int, int],
                    blocksize: Tuple[int, int], *, device) -> BSR:
    m, n = (int(s) for s in shape)
    br, bc = (int(b) for b in blocksize)
    data = np.asarray(data)
    indices, indptr = _index(indices, "indices"), _index(indptr, "indptr")
    if (data.ndim != 3 or data.shape[1:] != (br, bc) or data.shape[0] != indices.shape[0]
            or indptr.shape != (-(-m // br) + 1,)):
        raise ValueError("BSR arrays disagree with each other, the shape or the blocksize")
    return BSR(data=to_device(data, device), indices=to_device(indices, device),
               indptr=to_device(indptr, device), shape=(m, n), blocksize=(br, bc))


def bdia_from_arrays(vals, rem_data, rem_row, rem_col, *, block_offsets: Sequence[int],
                     shape: Tuple[int, int], blocksize: Tuple[int, int], ts: int,
                     device) -> BdiaMatrix:
    br, bc = (int(b) for b in blocksize)
    vals = np.asarray(vals)
    offsets = tuple(int(d) for d in block_offsets)
    if vals.ndim != 5 or vals.shape[0] != br or vals.shape[2] != len(offsets) * bc \
            or vals.shape[3:] != (ts, _LANE):
        raise ValueError(f"vals shape {vals.shape} is not (br, T, npairs, ts, 128) "
                         f"for blocksize {(br, bc)}, {len(offsets)} offsets, ts={ts}")
    rem_data = np.asarray(rem_data)
    rem_row, rem_col = _index(rem_row, "rem_row"), _index(rem_col, "rem_col")
    if not rem_data.shape == rem_row.shape == rem_col.shape:
        raise ValueError("remainder arrays must have equal length")
    return BdiaMatrix(vals=to_device(vals, device), rem_data=to_device(rem_data, device),
                      rem_row=to_device(rem_row, device), rem_col=to_device(rem_col, device),
                      block_offsets=offsets, shape=(int(shape[0]), int(shape[1])),
                      blocksize=(br, bc), ts=int(ts))


def dia_from_arrays(vals, rem_data, rem_row, rem_col, offsets: Sequence[int],
                    shape: Tuple[int, int], *, vals_t=None, device) -> DiaMatrix:
    m, n = (int(s) for s in shape)
    vals = np.asarray(vals)
    offsets = tuple(int(d) for d in offsets)
    if vals.ndim != 2 or vals.shape[0] != len(offsets) or vals.shape[1] < m:
        raise ValueError(f"vals shape {vals.shape} is not (ndiags, m_pad) for "
                         f"{len(offsets)} offsets and {m} rows")
    if vals_t is not None:
        vals_t = np.asarray(vals_t)
        if vals_t.shape != vals.shape[::-1]:
            raise ValueError(f"vals_t shape {vals_t.shape} is not vals' transpose")
        vals_t = to_device(vals_t, device)
    rem_data = np.asarray(rem_data)
    rem_row, rem_col = _index(rem_row, "rem_row"), _index(rem_col, "rem_col")
    if not rem_data.shape == rem_row.shape == rem_col.shape:
        raise ValueError("remainder arrays must have equal length")
    return DiaMatrix(vals=to_device(vals, device), rem_data=to_device(rem_data, device),
                     rem_row=to_device(rem_row, device), rem_col=to_device(rem_col, device),
                     vals_t=vals_t, offsets=offsets, shape=(m, n))


def slabs_from_arrays(slabs, *, g: int, blocksize: Tuple[int, int], shape: Tuple[int, int],
                      far_offsets: Sequence[int], nb_pad: int, rem_data=None, rem_row=None,
                      rem_col=None, device) -> BdiaSlabs:
    """A reference ``BdiaSlabs``.  It holds no remainder: pass its BDIA
    plan's ``rem_*`` arrays to carry one (the port's plan adds it)."""
    br, bc = (int(b) for b in blocksize)
    g, nb_pad = int(g), int(nb_pad)
    far = tuple(int(d) for d in far_offsets)
    slabs = np.asarray(slabs)
    width = 2 * bc + g * bc * (1 + len(far))
    if g < 1 or nb_pad % g or slabs.shape != (nb_pad // g * g * br, width):
        raise ValueError(f"slabs shape {slabs.shape} is not (ntiles·g·br, W) = "
                         f"({nb_pad // max(g, 1) * g * br}, {width})")
    rem_data = np.zeros(0, slabs.dtype) if rem_data is None else np.asarray(rem_data)
    rem_row = _index(np.zeros(0, np.int32) if rem_row is None else rem_row, "rem_row")
    rem_col = _index(np.zeros(0, np.int32) if rem_col is None else rem_col, "rem_col")
    if not rem_data.shape == rem_row.shape == rem_col.shape:
        raise ValueError("remainder arrays must have equal length")
    return BdiaSlabs(slabs=to_device(slabs, device), rem_data=to_device(rem_data, device),
                     rem_row=to_device(rem_row, device), rem_col=to_device(rem_col, device),
                     g=g, blocksize=(br, bc), shape=(int(shape[0]), int(shape[1])),
                     far_offsets=far, nb_pad=nb_pad)


def bsr_spmm_from_arrays(vals, cols, *, shape: Tuple[int, int], blocksize: Tuple[int, int],
                         G: int, K: int, k: int, device) -> BsrSpmmKernel:
    """A reference ``BsrSpmmKernel``'s packed arrays and fields."""
    br, bc = (int(b) for b in blocksize)
    G, K = int(G), int(K)
    vals = np.asarray(vals)
    cols = _index(cols, "cols")
    if vals.ndim != 3 or vals.shape[1:] != (G * br, K * bc) \
            or cols.shape != (vals.shape[0] * G * K,):
        raise ValueError(f"vals {vals.shape} / cols {cols.shape} are not (T, G·br, K·bc) / "
                         f"(T·G·K,) for G={G}, K={K}, blocksize {(br, bc)}")
    return BsrSpmmKernel(vals=to_device(vals, device), cols=to_device(cols, device),
                         shape=(int(shape[0]), int(shape[1])), blocksize=(br, bc), G=G, K=K,
                         k=int(k))


def poh_from_arrays(vals, cloc, rloc, wlo, whi, panel, first, last, *,
                    shape: Tuple[int, int], row_panel: int, col_window: int,
                    device) -> PohMatrix:
    """A reference ``PohMatrix``'s packed arrays and fields (its ``rloc_t``,
    a TPU layout, is not taken)."""
    vals = np.asarray(vals)
    cloc, rloc = np.asarray(cloc), np.asarray(rloc)
    if vals.ndim != 3 or vals.shape[2] != 128 or cloc.shape != vals.shape \
            or rloc.shape != vals.shape or cloc.dtype.kind not in "iu" \
            or rloc.dtype.kind not in "iu":
        raise ValueError(f"vals {vals.shape} / cloc {cloc.shape} / rloc {rloc.shape} are not "
                         f"the POH packing (ntiles, S, 128) with integer indices")
    tile = [_index(t, name) for t, name in ((wlo, "wlo"), (whi, "whi"), (panel, "panel"),
                                            (first, "first"), (last, "last"))]
    if any(t.shape != (vals.shape[0],) for t in tile):
        raise ValueError(f"per-tile arrays must have length ntiles = {vals.shape[0]}")
    wlo, whi, panel, first, last = (to_device(t, device) for t in tile)
    return PohMatrix(vals=to_device(vals, device),
                     cloc=to_device(cloc.astype(np.int32), device),
                     rloc=to_device(rloc.astype(np.int32), device), wlo=wlo, whi=whi,
                     panel=panel, first=first, last=last,
                     shape=(int(shape[0]), int(shape[1])), row_panel=int(row_panel),
                     col_window=int(col_window))


def _lell_pack(vals, idx):
    vals, idx = np.asarray(vals), np.asarray(idx)
    if vals.ndim != 3 or vals.shape[2] != 128 or idx.shape != vals.shape \
            or idx.dtype.kind not in "iu":
        raise ValueError(f"vals {vals.shape} / idx {idx.shape} are not the LELL packing "
                         f"(L, S_pad, 128) with integer indices")
    return vals, idx.astype(np.int32)


def lell_from_arrays(vals, idx, rem_data, rem_row, rem_col, *, shape: Tuple[int, int],
                     groups: int, device) -> LellMatrix:
    """A reference ``LellMatrix``'s packed arrays, remainder and fields."""
    vals, idx = _lell_pack(vals, idx)
    if int(groups) < 1 or 128 % int(groups):
        raise ValueError(f"groups must divide 128, got {groups}")
    rem_data = np.asarray(rem_data)
    rem_row, rem_col = _index(rem_row, "rem_row"), _index(rem_col, "rem_col")
    if not rem_data.shape == rem_row.shape == rem_col.shape:
        raise ValueError("remainder arrays must have equal length")
    return LellMatrix(vals=to_device(vals, device), idx=to_device(idx, device),
                      rem_data=to_device(rem_data, device),
                      rem_row=to_device(rem_row, device), rem_col=to_device(rem_col, device),
                      shape=(int(shape[0]), int(shape[1])), groups=int(groups))


def hyb_from_arrays(vals, idx, rem_data, rem_row, rem_col, hub_vals, hub_idx, slot2row, *,
                    shape: Tuple[int, int], groups: int, device) -> HybLell:
    """A reference ``HybLell``: its grouped tier's arrays (as
    :func:`lell_from_arrays` takes them), then its hub tier's."""
    main = lell_from_arrays(vals, idx, rem_data, rem_row, rem_col, shape=shape, groups=groups,
                            device=device)
    hub_vals, hub_idx = _lell_pack(hub_vals, hub_idx)
    slot2row = _index(slot2row, "slot2row")
    if slot2row.shape != (hub_vals.shape[1],):
        raise ValueError(f"slot2row must have length S_pad = {hub_vals.shape[1]}")
    hub = ChunkedLell(vals=to_device(hub_vals, device), idx=to_device(hub_idx, device),
                      slot2row=to_device(slot2row, device), shape=main.shape)
    return HybLell(main=main, hub=hub)


def spgemm_plan_from_arrays(src_a, src_b, out_id, c_indices, c_indptr, *,
                            shape: Tuple[int, int], device) -> SpGEMMPlan:
    """A reference ``SpGEMMPlan``'s five arrays and shape."""
    src_a, src_b, out_id = (_index(x, name) for x, name in
                            ((src_a, "src_a"), (src_b, "src_b"), (out_id, "out_id")))
    c_indices, c_indptr = _index(c_indices, "c_indices"), _index(c_indptr, "c_indptr")
    m, p = (int(s) for s in shape)
    if not src_a.shape == src_b.shape == out_id.shape or c_indptr.shape != (m + 1,):
        raise ValueError("SpGEMM plan arrays disagree with each other or with the shape")
    return SpGEMMPlan(shape=(m, p), src_a=src_a, src_b=src_b, out_id=out_id,
                      c_indices=c_indices, c_indptr=c_indptr, device=device)


def add_plan_from_arrays(c_indices, c_indptr, a_dst, b_dst, *, shape: Tuple[int, int],
                         device) -> AddPlan:
    """A reference ``AddPlan``'s union structure and source maps."""
    m, n = (int(s) for s in shape)
    c_indptr = _index(c_indptr, "c_indptr")
    if c_indptr.shape != (m + 1,):
        raise ValueError(f"c_indptr must have length {m + 1}")
    return AddPlan(shape=(m, n), c_indices=_index(c_indices, "c_indices"), c_indptr=c_indptr,
                   a_dst=_index(a_dst, "a_dst"), b_dst=_index(b_dst, "b_dst"), device=device)


def trisolve_plan_from_arrays(lvl_rows, lvl_diag_idx, lvl_ent_local, lvl_ent_col, lvl_ent_idx,
                              lvl_ent_valid, *, n: int, lower: bool, unit_diag: bool,
                              device) -> TriSolvePlan:
    """A reference ``TriSolvePlan``'s ``lvl_*`` arrays and flags (``nlevels``,
    ``max_rows`` and ``max_ents`` follow from the arrays' shapes)."""
    rows, diag = (np.asarray(x).astype(np.int32) for x in (lvl_rows, lvl_diag_idx))
    local, col, idx = (np.asarray(x).astype(np.int32)
                       for x in (lvl_ent_local, lvl_ent_col, lvl_ent_idx))
    valid = np.asarray(lvl_ent_valid, dtype=bool)
    if rows.ndim != 2 or diag.shape != rows.shape or local.ndim != 2 \
            or not local.shape == col.shape == idx.shape == valid.shape \
            or local.shape[0] != rows.shape[0]:
        raise ValueError("level arrays must be (nlevels, max_rows) and (nlevels, max_ents)")
    return TriSolvePlan(n=int(n), lower=bool(lower), unit_diag=bool(unit_diag),
                        nlevels=rows.shape[0], max_rows=rows.shape[1], max_ents=local.shape[1],
                        lvl_rows=rows, lvl_diag_idx=diag, lvl_ent_local=local, lvl_ent_col=col,
                        lvl_ent_idx=idx, lvl_ent_valid=valid, device=device)


def ilu0_factors_from_arrays(data, indices, indptr, shape: Tuple[int, int], *,
                             device) -> ILU0Factors:
    """A reference ``ILU0Factors``' combined LU values on A's pattern (its
    ``lu`` CSR's arrays); the solve plans are planned from the pattern, as
    the reference plans them."""
    return ilu0_factors(CSR(data=np.asarray(data), indices=_index(indices, "indices"),
                            indptr=_index(indptr, "indptr"),
                            shape=(int(shape[0]), int(shape[1]))), device=device)


def _stacked(x, name: str, nshards: int, ndim: int, index: bool = False) -> np.ndarray:
    a = np.asarray(x)
    if a.ndim != ndim or a.shape[0] != nshards:
        raise ValueError(f"{name} must be ({nshards}, ...) with {ndim} dimensions, got {a.shape}")
    if index:
        if a.dtype.kind not in "iu":
            raise ValueError(f"{name} must be an integer array, got {a.dtype}")
        return a.astype(np.int32)
    return a


def coo_partition_from_arrays(int_data, int_row, int_col, ext_data, ext_row, ext_col, *,
                              shape: Tuple[int, int], nshards: int, mloc: int) -> CooPartition:
    """A reference ``CooPartition``'s six stacked arrays and fields."""
    P = int(nshards)
    arrs = [_stacked(x, name, P, 2, index=name[4:] != "data") for x, name in (
        (int_data, "int_data"), (int_row, "int_row"), (int_col, "int_col"),
        (ext_data, "ext_data"), (ext_row, "ext_row"), (ext_col, "ext_col"))]
    if not arrs[0].shape == arrs[1].shape == arrs[2].shape \
            or not arrs[3].shape == arrs[4].shape == arrs[5].shape:
        raise ValueError("interior and exterior arrays must each share one shape")
    return CooPartition(*arrs, shape=(int(shape[0]), int(shape[1])), nshards=P, mloc=int(mloc))


def dia_partition_from_arrays(vals, remainder: Optional[CooPartition], *,
                              offsets: Sequence[int], shape: Tuple[int, int], nshards: int,
                              mloc: int) -> DiaPartition:
    """A reference ``DiaPartition``'s stacked values, its remainder (crossed
    with :func:`coo_partition_from_arrays`, or None) and fields."""
    vals = _stacked(vals, "vals", int(nshards), 3)
    offsets = tuple(int(o) for o in offsets)
    if vals.shape[1:] != (len(offsets), int(mloc)):
        raise ValueError(f"vals {vals.shape} is not (P, {len(offsets)} offsets, mloc {mloc})")
    return DiaPartition(vals=vals, remainder=remainder, offsets=offsets,
                        shape=(int(shape[0]), int(shape[1])), nshards=int(nshards),
                        mloc=int(mloc))


def bdia_partition_from_arrays(vals, head_vals, tail_vals, remainder: Optional[CooPartition], *,
                               block_offsets: Sequence[int], shape: Tuple[int, int],
                               blocksize: Tuple[int, int], ts: int, nshards: int, mloc: int,
                               nbloc: int) -> BdiaPartition:
    """A reference ``BdiaPartition``'s stacked values, edge windows, remainder
    (or None) and fields."""
    P = int(nshards)
    br, bc = (int(b) for b in blocksize)
    offsets = tuple(int(o) for o in block_offsets)
    vals = _stacked(vals, "vals", P, 6)
    if vals.shape[1] != br or vals.shape[3] != len(offsets) * bc \
            or vals.shape[4:] != (int(ts), _LANE):
        raise ValueError(f"vals shape {vals.shape} is not (P, br, T, npairs, ts, 128) for "
                         f"blocksize {(br, bc)}, {len(offsets)} offsets, ts={ts}")
    head_vals = _stacked(head_vals, "head_vals", P, 4)
    tail_vals = _stacked(tail_vals, "tail_vals", P, 4)
    if head_vals.shape[1:3] != (br, vals.shape[3]) or tail_vals.shape[1:3] != head_vals.shape[1:3]:
        raise ValueError("edge windows must be (P, br, npairs, width)")
    return BdiaPartition(vals=vals, head_vals=head_vals, tail_vals=tail_vals,
                         remainder=remainder, block_offsets=offsets,
                         shape=(int(shape[0]), int(shape[1])), blocksize=(br, bc), ts=int(ts),
                         nshards=P, mloc=int(mloc), nbloc=int(nbloc))


def poh_partition_from_arrays(arrays: dict, *, shape: Tuple[int, int], nshards: int,
                              mloc: int, row_panel: int, col_window: int) -> PohPartition:
    """A reference ``PohPartition``'s stacked packs, ``arrays`` keyed as its
    fields (``int_vals`` ... ``ext_last``; its ``rloc_t``, a TPU layout, is
    not taken), and fields."""
    P = int(nshards)
    got = {}
    for pfx in ("int", "ext"):
        vals = _stacked(arrays[f"{pfx}_vals"], f"{pfx}_vals", P, 4)
        if vals.shape[3] != _LANE:
            raise ValueError(f"{pfx}_vals {vals.shape} is not (P, ntiles, S, 128)")
        got[f"{pfx}_vals"] = vals
        for f in _POH_FIELDS[1:]:
            a = _stacked(arrays[f"{pfx}_{f}"], f"{pfx}_{f}", P, 4 if f in ("cloc", "rloc") else 2,
                         index=True)
            if a.shape[:2] != vals.shape[:2]:
                raise ValueError(f"{pfx}_{f} {a.shape} does not match {pfx}_vals {vals.shape}")
            got[f"{pfx}_{f}"] = a
    return PohPartition(**got, shape=(int(shape[0]), int(shape[1])), nshards=P,
                        mloc=int(mloc), row_panel=int(row_panel), col_window=int(col_window))


def coo2d_partition_from_arrays(data, row, col, *, shape: Tuple[int, int], pr: int, pc: int,
                                mr: int, mc: int) -> Coo2DPartition:
    """A reference ``Coo2DPartition``'s stacked blocks and fields."""
    P = int(pr) * int(pc)
    data = _stacked(data, "data", P, 2)
    row, col = _stacked(row, "row", P, 2, index=True), _stacked(col, "col", P, 2, index=True)
    if not data.shape == row.shape == col.shape:
        raise ValueError("data, row and col must share one shape")
    return Coo2DPartition(data=data, row=row, col=col, shape=(int(shape[0]), int(shape[1])),
                          pr=int(pr), pc=int(pc), mr=int(mr), mc=int(mc))
