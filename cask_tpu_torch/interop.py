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
