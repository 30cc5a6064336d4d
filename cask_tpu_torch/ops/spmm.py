"""Sparse × dense matrix product  Y = A @ X  with tall-skinny X (n, k).

The PyTorch counterpart of :mod:`cask_tpu.ops.spmm`.  Dispatch:

- ``method='xla'`` — the gather + ``index_add_`` formulations in plain
  PyTorch (CSR/COO/BSR, both directions); the always-correct reference.
- ``method='dia'`` — plan the matrix's diagonals on ``X``'s device and run
  the DIA product (:func:`cask_tpu_torch.ops.dia.spmm_dia`).
- ``method='auto'`` — on a CUDA device, a banded :class:`CSR` rides the
  same cached DIA plan as ``spmv(csr, x)`` and a :class:`BSR` its cached
  BDIA plan (:class:`cask_tpu_torch.ops.spmv.PlanCache`, one plan per
  matrix serving both ops).  A BDIA plan multiplies through its scalar-DIA
  plan (:func:`cask_tpu_torch.ops.bdia.bdia_scalar_dia`) and the DIA SpMM
  kernel at every k: the JAX package's TPU route at k ≤ 64, and the last
  route of its wide-k chain above that, until the slab kernels are ported.
- ``method='pallas_bsr'``, ``'pallas_bdia'``, ``'slab'`` — the BSR, BDIA
  ring and slab SpMM kernels are not ported yet; these raise rather than
  run another route in their place.
"""

from __future__ import annotations

from typing import Optional

import torch

from cask_tpu_torch.formats.matrix import BSR, COO, CSR
from cask_tpu_torch.ops.bdia import BdiaMatrix, bdia_scalar_dia
from cask_tpu_torch.ops.bdia import transpose_plan as _bdia_transpose
from cask_tpu_torch.ops.dia import DiaMatrix, spmm_dia
from cask_tpu_torch.ops.spmv import _accum_dtype, _on, cached_plan, row_ids_from_indptr

_NOT_PORTED = ("pallas_bsr", "pallas_bdia", "slab")


def _spmm_xla_csr(a: CSR, x, transpose, accum_dtype):
    acc = _accum_dtype(a.dtype, accum_dtype)
    data, indices, indptr = _on(x, a.data, a.indices, a.indptr)
    indices = indices.long()
    rows = row_ids_from_indptr(indptr, a.nnz)
    if not transpose:
        prod = (data[:, None] * x[indices]).to(acc)  # (nnz, k)
        return prod.new_zeros((a.shape[0], x.shape[1])).index_add_(0, rows, prod)
    prod = (data[:, None] * x[rows]).to(acc)
    return prod.new_zeros((a.shape[1], x.shape[1])).index_add_(0, indices, prod)


def _spmm_xla_coo(a: COO, x, transpose, accum_dtype):
    acc = _accum_dtype(a.dtype, accum_dtype)
    data, row, col = _on(x, a.data, a.row, a.col)
    if transpose:
        row, col, m = col, row, a.shape[1]
    else:
        m = a.shape[0]
    prod = (data[:, None] * x[col.long()]).to(acc)
    return prod.new_zeros((m, x.shape[1])).index_add_(0, row.long(), prod)


def _spmm_xla_bsr(a: BSR, x, transpose, accum_dtype):
    acc = _accum_dtype(a.dtype, accum_dtype)
    br, bc = a.blocksize
    pm, pn = a.padded_shape
    k = x.shape[1]
    data, indices, indptr = _on(x, a.data, a.indices, a.indptr)  # data (nb, br, bc)
    indices = indices.long()
    brow = row_ids_from_indptr(indptr, a.n_blocks)
    # block products in the wider of acc and X's type, summed into acc
    ct = torch.promote_types(acc, x.dtype)
    data = data.to(ct)
    if not transpose:
        xp = x.new_zeros((pn, k))
        xp[: a.shape[1]] = x
        xb = xp.reshape(a.n_block_cols, bc, k)[indices].to(ct)  # (nb, bc, k)
        part = torch.bmm(data, xb).to(acc)  # (nb, br, k)
        yb = part.new_zeros((a.n_block_rows, br, k)).index_add_(0, brow, part)
        return yb.reshape(pm, k)[: a.shape[0]]
    xp = x.new_zeros((pm, k))
    xp[: a.shape[0]] = x
    xb = xp.reshape(a.n_block_rows, br, k)[brow].to(ct)  # (nb, br, k)
    part = torch.bmm(data.transpose(1, 2), xb).to(acc)  # (nb, bc, k)
    yb = part.new_zeros((a.n_block_cols, bc, k)).index_add_(0, indices, part)
    return yb.reshape(pn, k)[: a.shape[1]]


def spmm(a, x, *, transpose: bool = False, method: str = "auto",
         accum_dtype: Optional[object] = None):
    """``Y = a @ X`` (or ``aᵀ @ X``) with dense ``X`` of shape (n, k).  See
    the module docstring for methods."""
    x = torch.as_tensor(x).contiguous()  # the kernels take contiguous operands
    if x.ndim != 2:
        raise ValueError(f"X must be 2-D, got shape {tuple(x.shape)}")
    n_expect = a.shape[0] if transpose else a.shape[1]
    if x.shape[0] != n_expect:
        raise ValueError(f"dimension mismatch: A {a.shape} (transpose={transpose}) "
                         f"vs X {tuple(x.shape)}")

    if method in _NOT_PORTED:
        raise NotImplementedError(
            f"spmm method {method!r}: the BSR, BDIA ring and slab SpMM kernels are "
            f"not ported yet (ROADMAP Queue A 8)")
    if method == "dia":
        return spmm_dia(a, x, transpose=transpose)
    if method not in ("auto", "xla"):
        raise ValueError(f"unknown spmm method {method!r}")

    auto = method == "auto" and not transpose and accum_dtype is None
    if isinstance(a, CSR):
        # banded CSR rides the same cached DIA plan as spmv(csr, x)
        plan = cached_plan(a, x) if auto else None
        return plan.spmm(x) if plan is not None else _spmm_xla_csr(a, x, transpose, accum_dtype)
    if isinstance(a, COO):
        return _spmm_xla_coo(a, x, transpose, accum_dtype)
    if isinstance(a, BSR):
        # the same cached BDIA plan as spmv(bsr, x), then the BDIA route below
        plan = cached_plan(a, x) if auto else None
        return spmm(plan, x) if plan is not None else _spmm_xla_bsr(a, x, transpose, accum_dtype)
    if isinstance(a, DiaMatrix):
        return spmm_dia(a, x, transpose=transpose)
    if isinstance(a, BdiaMatrix):
        if transpose:
            a = _bdia_transpose(a)  # one-time host rebuild; hold the plan to reuse
        # scalar-DIA SpMM on the expanded structure, the plan held in the cache
        return bdia_scalar_dia(a).spmm(x)
    raise TypeError(f"unsupported matrix type {type(a)}")
