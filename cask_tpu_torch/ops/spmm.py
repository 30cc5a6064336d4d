"""Sparse × dense matrix product  Y = A @ X  with tall-skinny X (n, k).

The PyTorch counterpart of :mod:`cask_tpu.ops.spmm`.  Dispatch:

- ``method='xla'`` — the gather + ``index_add_`` formulations in plain
  PyTorch (CSR/COO/BSR, both directions); the always-correct reference.
- ``method='dia'`` — plan the matrix's diagonals on ``X``'s device and run
  the DIA product (:func:`cask_tpu_torch.ops.dia.spmm_dia`).
- ``method='pallas_bsr'`` — a :class:`BSR` through the ELL-packed BSR SpMM
  kernel (:func:`cask_tpu_torch.ops.bsr_spmm.spmm_bsr`), planned per call.
- ``method='auto'`` — with ``X`` on a CUDA device (or host data, which goes
  there), a banded :class:`CSR` rides the same cached DIA plan as
  ``spmv(csr, x)`` and a :class:`BSR` its cached BDIA plan
  (:class:`cask_tpu_torch.ops.spmv.PlanCache`, one plan per matrix serving
  both ops); a CPU tensor ``X`` takes the gather formulation.
- A BDIA plan multiplies, at k ≤ 64, through its scalar-DIA plan
  (:func:`cask_tpu_torch.ops.bdia.bdia_scalar_dia`) and the DIA SpMM
  kernel, the JAX package's TPU route.  At k > 64 it takes the reference's
  wide-k chain: its slab plan and the slab kernel
  (:mod:`cask_tpu_torch.ops.bdia_slab`), else the BDIA ring kernel where
  the reference's ``bdia_mm_ok`` admits it, else scalar DIA.
  ``method='slab'`` and ``'pallas_bdia'`` force the slab and the ring; a
  plan that has no slab plan, or that the ring's gate refuses, raises
  ``ValueError`` rather than running another route (ROADMAP Queue C 2).  On
  a :class:`BSR` they plan it first, where the reference runs the gather
  formulation.
- A held :class:`cask_tpu_torch.ops.bdia_slab.BdiaSlabs` is the operator
  itself: the slab kernel plus the remainder the plan carries.
- A :class:`cask_tpu_torch.ops.poh.PohMatrix` runs the POH SpMM kernel at
  any k.

Every route runs its kernel on CUDA tensors and the kernel's plain twin on
CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from cask_tpu_torch.formats.matrix import BSR, COO, CSR
from cask_tpu_torch.ops.bdia import BdiaMatrix, bdia_plan, bdia_scalar_dia, remainder_spmm
from cask_tpu_torch.ops.bdia import transpose_plan as _bdia_transpose
from cask_tpu_torch.ops.bdia_slab import BdiaSlabs
from cask_tpu_torch.ops.bsr_spmm import spmm_bsr
from cask_tpu_torch.ops.dia import DiaMatrix, spmm_dia
from cask_tpu_torch.ops.kernels.bdia_kernels import bdia_mm_ok, bdia_spmm_ring
from cask_tpu_torch.ops.poh import PohMatrix, poh_transpose_plan
from cask_tpu_torch.ops.spmv import (_accum_dtype, _on, as_operand, cached_plan,
                                     default_plan_cache, row_ids_from_indptr)

_WIDE_K = 64  # above this k a BDIA plan takes the wide-k chain (ops/spmm.py:197)


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


def _bdia_spmm(a: BdiaMatrix, x: torch.Tensor, method: str, accum_dtype) -> torch.Tensor:
    """A BDIA plan's product: scalar DIA at k ≤ 64, else the wide-k chain
    (``ops/spmm.py:189-228``).  The slab plan adds the remainder it carries;
    the ring's result gets it here."""
    if x.shape[1] <= _WIDE_K:
        return bdia_scalar_dia(a).spmm(x)
    sl = default_plan_cache.get(a, "slab") if method != "pallas_bdia" else None
    if sl is not None:
        return sl.spmm(x, out_dtype=accum_dtype)
    if method == "slab":
        raise ValueError(f"method='slab': the plan has no slab plan (offsets "
                         f"{a.block_offsets}, blocksize {a.blocksize}, nb_pad {a.nb_pad})")
    if bdia_mm_ok(a, x.shape[1]):
        y = bdia_spmm_ring(a, x, out_dtype=accum_dtype)
        if a.rem_data.shape[0]:
            y = y + remainder_spmm(a.rem_data, a.rem_row, a.rem_col, a.shape[0], x, y.dtype)
        return y
    if method == "pallas_bdia":
        raise ValueError(f"method='pallas_bdia': the ring's gate refuses the plan "
                         f"({a.npairs} pairs, block offsets {a.block_offsets})")
    return bdia_scalar_dia(a).spmm(x)


def spmm(a, x, *, transpose: bool = False, method: str = "auto",
         accum_dtype: Optional[object] = None):
    """``Y = a @ X`` (or ``aᵀ @ X``) with dense ``X`` of shape (n, k).  See
    the module docstring for methods."""
    x = as_operand(a, x).contiguous()  # the kernels take contiguous operands
    if x.ndim != 2:
        raise ValueError(f"X must be 2-D, got shape {tuple(x.shape)}")
    n_expect = a.shape[0] if transpose else a.shape[1]
    if x.shape[0] != n_expect:
        raise ValueError(f"dimension mismatch: A {a.shape} (transpose={transpose}) "
                         f"vs X {tuple(x.shape)}")

    if method == "pallas_bsr":
        return spmm_bsr(a, x, transpose=transpose)
    if method == "dia":
        return spmm_dia(a, x, transpose=transpose)
    if method not in ("auto", "xla", "pallas_bdia", "slab"):
        raise ValueError(f"unknown spmm method {method!r}")

    auto = method == "auto" and not transpose and accum_dtype is None
    if isinstance(a, CSR):
        # banded CSR rides the same cached DIA plan as spmv(csr, x)
        plan = cached_plan(a, x) if auto else None
        return plan.spmm(x) if plan is not None else _spmm_xla_csr(a, x, transpose, accum_dtype)
    if isinstance(a, COO):
        return _spmm_xla_coo(a, x, transpose, accum_dtype)
    if isinstance(a, BSR):
        if method in ("pallas_bdia", "slab"):
            # an explicit BDIA kernel plans the matrix: its cached plan, else anew
            if transpose:
                from cask_tpu_torch.formats.convert import transpose as _t

                a, transpose = _t(a), False
            plan = cached_plan(a, x) or bdia_plan(a, a.blocksize, device=x.device)
            return _bdia_spmm(plan, x, method, accum_dtype)
        # the same cached BDIA plan as spmv(bsr, x), then the BDIA route below
        plan = cached_plan(a, x) if auto else None
        return spmm(plan, x) if plan is not None else _spmm_xla_bsr(a, x, transpose, accum_dtype)
    if isinstance(a, DiaMatrix):
        return spmm_dia(a, x, transpose=transpose)
    if isinstance(a, BdiaSlabs):
        # a held slab plan is the operator, its remainder included
        if transpose:
            raise ValueError("BdiaSlabs has no transpose plan; shear transpose_plan(bdia) "
                             "instead")
        return a.spmm(x, out_dtype=accum_dtype)
    if isinstance(a, PohMatrix):
        if transpose:
            a = poh_transpose_plan(a)  # one-time host repack; hold transposed(a) to reuse
        return a.spmm(x)
    if isinstance(a, BdiaMatrix):
        if transpose:
            a = _bdia_transpose(a)  # one-time host rebuild; hold the plan to reuse
        return _bdia_spmm(a, x, method, accum_dtype)
    raise TypeError(f"unsupported matrix type {type(a)}")
