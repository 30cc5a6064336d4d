"""Sparse matrix–vector product  y = A @ x  (and  y = Aᵀ @ x).

The PyTorch counterpart of :mod:`cask_tpu.ops.spmv`.  Dispatch:

- ``method='xla'``  — the gather + ``index_add_`` formulation in plain
  PyTorch, every format, every device; the always-correct reference (the
  JAX package computes it in XLA, so its counterpart here is plain
  PyTorch, not a kernel).
- ``method='bdia'`` — plan the matrix's block diagonals
  (:func:`cask_tpu_torch.ops.bdia.bdia_plan`) and run the BDIA product.
- ``method='auto'`` — a :class:`BSR` on a CUDA device goes through a
  cached BDIA plan and the CUDA kernel when the plan qualifies (see
  :class:`PlanCache`); everything else takes the gather formulation, which
  is also the JAX package's route off the TPU.  The JAX package's DIA
  route for banded CSR is not ported yet.
"""

from __future__ import annotations

import weakref
from typing import Optional

import torch

from cask_tpu_torch.formats.matrix import BSR, COO, CSR, to_device, torch_dtype
from cask_tpu_torch.ops.bdia import BdiaMatrix, bdia_plan, transpose_plan
from cask_tpu_torch.ops.kernels.bdia_kernels import bdia_kernel_ok

# the auto route's remainder gate: a plan whose scalar remainder holds more
# than this share of the stored entries takes the gather formulation
_MAX_REMAINDER_SHARE = 0.1


def _accum_dtype(dtype, accum_dtype) -> torch.dtype:
    if accum_dtype is not None:
        return torch_dtype(accum_dtype)
    d = torch_dtype(dtype)
    if d in (torch.bfloat16, torch.float16):
        return torch.float32
    return d


def row_ids_from_indptr(indptr: torch.Tensor, nnz: int) -> torch.Tensor:
    """Expand CSR indptr into per-entry row ids."""
    counts = (indptr[1:] - indptr[:-1]).long()
    rows = torch.arange(counts.shape[0], device=indptr.device)
    return torch.repeat_interleave(rows, counts, output_size=nnz)


def _on(x: torch.Tensor, *arrays):
    return [to_device(a, x.device) for a in arrays]


# ---------------------------------------------------------------------------
# gather formulations
# ---------------------------------------------------------------------------


def _spmv_xla_csr(a: CSR, x, transpose, accum_dtype):
    acc = _accum_dtype(a.dtype, accum_dtype)
    data, indices, indptr = _on(x, a.data, a.indices, a.indptr)
    indices = indices.long()
    rows = row_ids_from_indptr(indptr, a.nnz)
    if not transpose:
        prod = (data * x[indices]).to(acc)
        y = prod.new_zeros(a.shape[0]).index_add_(0, rows, prod)
    else:
        prod = (data * x[rows]).to(acc)
        y = prod.new_zeros(a.shape[1]).index_add_(0, indices, prod)
    return y.to(x.dtype) if x.dtype == data.dtype else y


def _spmv_xla_coo(a: COO, x, transpose, accum_dtype):
    acc = _accum_dtype(a.dtype, accum_dtype)
    data, row, col = _on(x, a.data, a.row, a.col)
    if transpose:
        row, col = col, row
        m = a.shape[1]
    else:
        m = a.shape[0]
    prod = (data * x[col.long()]).to(acc)
    return prod.new_zeros(m).index_add_(0, row.long(), prod)


def _spmv_xla_bsr(a: BSR, x, transpose, accum_dtype):
    acc = _accum_dtype(a.dtype, accum_dtype)
    br, bc = a.blocksize
    pm, pn = a.padded_shape
    data, indices, indptr = _on(x, a.data, a.indices, a.indptr)  # data (nb, br, bc)
    indices = indices.long()
    brow = row_ids_from_indptr(indptr, a.n_blocks)
    # block products in the wider of acc and x's type, summed into acc
    ct = torch.promote_types(acc, x.dtype)
    data = data.to(ct)
    if not transpose:
        xp = x.new_zeros(pn)
        xp[: a.shape[1]] = x
        xb = xp.reshape(a.n_block_cols, bc)[indices].to(ct)  # (nb, bc): one gather per block
        part = (data * xb[:, None, :]).sum(-1).to(acc)  # (nb, br)
        yb = part.new_zeros((a.n_block_rows, br)).index_add_(0, brow, part)
        return yb.reshape(pm)[: a.shape[0]]
    xp = x.new_zeros(pm)
    xp[: a.shape[0]] = x
    xb = xp.reshape(a.n_block_rows, br)[brow].to(ct)  # (nb, br)
    part = (data * xb[:, :, None]).sum(1).to(acc)  # (nb, bc)
    yb = part.new_zeros((a.n_block_cols, bc)).index_add_(0, indices, part)
    return yb.reshape(pn)[: a.shape[1]]


def transposed(a):
    """The transpose of ``a`` in its own format/plan family, built ONCE.

    CSR/COO/BSR re-encode via :func:`cask_tpu_torch.formats.convert.
    transpose`; a BDIA plan rebuilds through its ``transpose_plan``.
    Iterating algorithms that apply both A and Aᵀ should call this once up
    front instead of passing ``transpose=True`` per application."""
    if isinstance(a, (CSR, COO, BSR)):
        from cask_tpu_torch.formats.convert import transpose as _t

        return _t(a)
    if isinstance(a, BdiaMatrix):
        return transpose_plan(a)
    raise TypeError(f"cannot transpose {type(a)}")


# ---------------------------------------------------------------------------
# public op
# ---------------------------------------------------------------------------


class PlanCache:
    """BDIA plans for the ``spmv`` auto route, one per BSR instance.

    A plan is built once per matrix (host numpy planning, then the packed
    values go to the matrix's device) and reused by every later call on
    the same instance.  A matrix whose plan does not qualify caches
    ``None``, so it never re-pays the planning probe.  It qualifies when
    the kernel can take it (:func:`bdia_kernel_ok`) and the scalar
    remainder holds at most ``_MAX_REMAINDER_SHARE`` of the stored
    entries.  Entries are held weakly: they go with their matrix.

    The plan copies the matrix's values, so each entry also keeps the
    version counters of the matrix's tensors: a tensor changed in place
    since (``a.data.mul_(2)``) makes the next ``get`` build the plan anew.
    Host numpy arrays carry no such counter and are taken as frozen.
    """

    def __init__(self):
        self._plans = weakref.WeakKeyDictionary()

    @staticmethod
    def _stamp(a: BSR):
        return tuple(getattr(t, "_version", None) for t in (a.data, a.indices, a.indptr))

    def get(self, a: BSR) -> Optional[BdiaMatrix]:
        stamp = self._stamp(a)
        hit = self._plans.get(a)
        if hit is not None and hit[0] == stamp:
            return hit[1]
        p = bdia_plan(a, a.blocksize)
        ok = bdia_kernel_ok(p) and p.rem_data.shape[0] <= _MAX_REMAINDER_SHARE * max(a.nnz, 1)
        self._plans[a] = (stamp, p if ok else None)
        return self._plans[a][1]


# the one cache that ``spmv``'s auto route uses
default_plan_cache = PlanCache()


def spmv(a, x, *, transpose: bool = False, method: str = "auto",
         accum_dtype: Optional[object] = None):
    """``y = a @ x`` (or ``aᵀ @ x``).  See the module docstring for methods.

    ``method='auto'`` on a :class:`BSR` whose arrays lie on a CUDA device
    routes through its BDIA plan in :data:`default_plan_cache` and the
    CUDA kernel, so the obvious API
    call on the obvious input is the tuned path.  A plan that does not
    qualify, a transposed or re-typed product, and CPU tensors take the
    gather formulation."""
    x = torch.as_tensor(x)
    if x.ndim != 1:
        raise ValueError(f"x must be 1-D, got shape {tuple(x.shape)}")
    n_expect = a.shape[0] if transpose else a.shape[1]
    if x.shape[0] != n_expect:
        raise ValueError(f"dimension mismatch: A {a.shape} (transpose={transpose}) "
                         f"vs x {tuple(x.shape)}")

    if method == "bdia":
        if transpose:
            from cask_tpu_torch.formats.convert import transpose as _t

            a = _t(a)  # BSR transposes in place; blocksize swaps with it
        return bdia_plan(a, getattr(a, "blocksize", None), device=x.device).spmv(x)
    if method not in ("auto", "xla"):
        raise ValueError(f"unknown spmv method {method!r}")

    if isinstance(a, CSR):
        return _spmv_xla_csr(a, x, transpose, accum_dtype)
    if isinstance(a, COO):
        return _spmv_xla_coo(a, x, transpose, accum_dtype)
    if isinstance(a, BSR):
        if (method == "auto" and not transpose and accum_dtype is None
                and isinstance(a.data, torch.Tensor) and a.data.is_cuda):
            plan = default_plan_cache.get(a)
            if plan is not None and plan.dtype == x.dtype:
                return plan.spmv(x)
        return _spmv_xla_bsr(a, x, transpose, accum_dtype)
    if isinstance(a, BdiaMatrix):
        if transpose:
            a = transpose_plan(a)  # one-time host rebuild; hold the plan to reuse
        return a.spmv(x)
    raise TypeError(f"unsupported matrix type {type(a)}")
