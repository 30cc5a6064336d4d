"""Build the port's objects from the JAX package's fields.

A matrix or plan of :mod:`cask_tpu` crosses over as its arrays (numpy,
e.g. ``np.asarray(plan.vals)``) plus its static metadata; nothing here
imports JAX.  The result's arrays are tensors on ``device``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from cask_tpu_torch.formats.matrix import BSR, CSR, to_device
from cask_tpu_torch.ops.bdia import _LANE, BdiaMatrix
from cask_tpu_torch.ops.bdia_slab import BdiaSlabs
from cask_tpu_torch.ops.bsr_spmm import BsrSpmmKernel
from cask_tpu_torch.ops.dia import DiaMatrix


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
