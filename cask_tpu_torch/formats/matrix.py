"""Sparse matrix containers as plain dataclasses.

The PyTorch counterpart of :mod:`cask_tpu.formats.matrix`.  A matrix is a
frozen dataclass of arrays plus static metadata (``shape``,
``blocksize``).  The arrays are host ``numpy`` arrays (construction,
conversion and planning happen there) or ``torch.Tensor``s on a device,
placed by :meth:`to`.

Conventions (the same as the JAX package's)
-------------------------------------------
- Indices are ``int32``.
- ``shape`` is the *logical* shape.  BSR stores rows/cols padded up to the
  block size; padded tail entries are structural zeros, so no runtime
  masking is needed in kernels.
- Equality is identity (``eq=False``): comparing arrays elementwise is not
  a matrix equality, and identity hashing lets a plan cache key on the
  instance (:class:`cask_tpu_torch.ops.spmv.PlanCache`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple, Union

import numpy as np
import torch

Array = Any  # np.ndarray | torch.Tensor


def _is_bf16(dtype) -> bool:
    """Whether a numpy or torch dtype is bfloat16.  numpy has no bfloat16
    of its own: an array of one (from JAX) carries a dtype named so."""
    if isinstance(dtype, torch.dtype):
        return dtype == torch.bfloat16
    return getattr(dtype, "name", dtype) == "bfloat16"


def _widen_bf16(a: np.ndarray) -> np.ndarray:
    """A numpy bfloat16 array as float32, exactly: a bfloat16 is the top
    half of the float32 of the same value."""
    return (np.ascontiguousarray(a).view(np.uint16).astype(np.uint32) << 16).view(np.float32)


def host(x) -> np.ndarray:
    """The array as host numpy (copies a device tensor to the host).
    bfloat16 values come as float32, which holds each exactly (numpy has
    no bfloat16); :func:`value_dtype` keeps the type, so a planner casts
    its packed values back without rounding anything."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).cpu().numpy()
    a = np.asarray(x)
    return _widen_bf16(a) if _is_bf16(a.dtype) else a


def value_dtype(x) -> torch.dtype:
    """The torch dtype of an array's values (numpy or tensor)."""
    return x.dtype if isinstance(x, torch.Tensor) else torch_dtype(np.asarray(x).dtype)


def torch_dtype(dtype) -> torch.dtype:
    """A numpy or torch dtype (or its name) as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if _is_bf16(dtype):
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def to_device(x, device: Union[str, torch.device], dtype=None) -> torch.Tensor:
    """``x`` (numpy or tensor) as a tensor on ``device``, cast to ``dtype``
    when given.  A numpy bfloat16 array crosses as its bits, so no
    bfloat16 support in numpy is needed."""
    if isinstance(x, torch.Tensor):
        t = x.to(device)
    else:
        a = np.ascontiguousarray(x)
        bf16 = _is_bf16(a.dtype)
        if bf16:
            a = a.view(np.int16)
        if not a.flags.writeable:  # e.g. a view of a JAX array: the tensor may be written
            a = a.copy()
        t = torch.as_tensor(a, device=device)
        if bf16:
            t = t.view(torch.bfloat16)
    return t if dtype is None else t.to(torch_dtype(dtype))


def _astype(x, dtype):
    if isinstance(x, torch.Tensor):
        return x.to(torch_dtype(dtype))
    return np.asarray(x).astype(dtype)


@dataclasses.dataclass(frozen=True, eq=False)
class COO:
    """Coordinate-format sparse matrix.

    ``data[k]`` sits at ``(row[k], col[k])``.  Duplicate coordinates are
    allowed at construction and are summed by :func:`coo_to_csr`.
    """

    data: Array  # (nnz,)
    row: Array  # (nnz,) int32
    col: Array  # (nnz,) int32
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    def to(self, device) -> "COO":
        return COO(data=to_device(self.data, device), row=to_device(self.row, device),
                   col=to_device(self.col, device), shape=self.shape)

    def todense(self) -> np.ndarray:
        data = host(self.data)
        out = np.zeros(self.shape, dtype=data.dtype)
        np.add.at(out, (host(self.row), host(self.col)), data)
        return out

    def astype(self, dtype) -> "COO":
        """Copy with values cast to ``dtype`` (indices unchanged)."""
        return dataclasses.replace(self, data=_astype(self.data, dtype))


@dataclasses.dataclass(frozen=True, eq=False)
class CSR:
    """Compressed-sparse-row matrix.

    Row ``i`` owns ``data[indptr[i]:indptr[i+1]]`` with column indices
    ``indices[indptr[i]:indptr[i+1]]``, kept sorted by the constructors in
    :mod:`cask_tpu_torch.formats.convert`.
    """

    data: Array  # (nnz,)
    indices: Array  # (nnz,) int32 column indices
    indptr: Array  # (nrows + 1,) int32
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    def to(self, device) -> "CSR":
        return CSR(data=to_device(self.data, device),
                   indices=to_device(self.indices, device),
                   indptr=to_device(self.indptr, device), shape=self.shape)

    def todense(self) -> np.ndarray:
        indptr = host(self.indptr)
        indices = host(self.indices)
        data = host(self.data)
        out = np.zeros(self.shape, dtype=data.dtype)
        rows = np.repeat(np.arange(self.shape[0]), np.diff(indptr))
        out[rows, indices] = out[rows, indices] + data
        return out

    def astype(self, dtype) -> "CSR":
        """Copy with values cast to ``dtype`` (indices unchanged)."""
        return dataclasses.replace(self, data=_astype(self.data, dtype))


@dataclasses.dataclass(frozen=True, eq=False)
class BSR:
    """Block-sparse-row matrix with dense ``(br, bc)`` blocks.

    ``data`` has shape ``(n_blocks, br, bc)``; block-row ``i`` owns blocks
    ``indptr[i]:indptr[i+1]`` with block-column indices from ``indices``.
    Logical shape may not divide the block size; rows/cols are zero-padded
    up to ``padded_shape`` and padding entries are structural zeros.
    """

    data: Array  # (n_blocks, br, bc)
    indices: Array  # (n_blocks,) int32 block-column indices
    indptr: Array  # (n_block_rows + 1,) int32
    shape: Tuple[int, int]
    blocksize: Tuple[int, int]

    @property
    def n_blocks(self) -> int:
        return int(self.data.shape[0])

    @property
    def nnz(self) -> int:
        """Stored entries (block area × block count), counting block fill."""
        br, bc = self.blocksize
        return self.n_blocks * br * bc

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def padded_shape(self) -> Tuple[int, int]:
        br, bc = self.blocksize
        m, n = self.shape
        return (-(-m // br) * br, -(-n // bc) * bc)

    @property
    def n_block_rows(self) -> int:
        return self.padded_shape[0] // self.blocksize[0]

    @property
    def n_block_cols(self) -> int:
        return self.padded_shape[1] // self.blocksize[1]

    def to(self, device) -> "BSR":
        return BSR(data=to_device(self.data, device),
                   indices=to_device(self.indices, device),
                   indptr=to_device(self.indptr, device),
                   shape=self.shape, blocksize=self.blocksize)

    def todense(self) -> np.ndarray:
        br, bc = self.blocksize
        pm, pn = self.padded_shape
        data = host(self.data)
        indices = host(self.indices)
        indptr = host(self.indptr)
        out = np.zeros((pm, pn), dtype=data.dtype)
        for bi in range(self.n_block_rows):
            for k in range(int(indptr[bi]), int(indptr[bi + 1])):
                bj = int(indices[k])
                out[bi * br : (bi + 1) * br, bj * bc : (bj + 1) * bc] += data[k]
        return out[: self.shape[0], : self.shape[1]]

    def astype(self, dtype) -> "BSR":
        """Copy with values cast to ``dtype`` (indices unchanged)."""
        return dataclasses.replace(self, data=_astype(self.data, dtype))
