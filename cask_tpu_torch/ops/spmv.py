"""Sparse matrix–vector product  y = A @ x  (and  y = Aᵀ @ x).

The PyTorch counterpart of :mod:`cask_tpu.ops.spmv`.  Dispatch:

- ``method='xla'``  — the gather + ``index_add_`` formulation in plain
  PyTorch, every format, every device; the always-correct reference (the
  JAX package computes it in XLA, so its counterpart here is plain
  PyTorch, not a kernel).
- ``method='dia'``  — plan the matrix's diagonals on ``x``'s device
  (:func:`cask_tpu_torch.ops.dia.dia_plan`) and run the DIA product.
- ``method='bdia'`` — plan the matrix's block diagonals
  (:func:`cask_tpu_torch.ops.bdia.bdia_plan`) and run the BDIA product.
- ``method='auto'`` — with an operand on a CUDA device, a :class:`BSR`
  goes through a cached BDIA plan and a banded :class:`CSR` through a
  cached DIA plan, each with its CUDA kernel, when the plan qualifies (see
  :class:`PlanCache`); a matrix of host numpy arrays is planned onto the
  operand's device once.  Everything else takes the gather formulation,
  which is also the JAX package's route off the TPU.  As in the JAX
  package, an unstructured CSR is not routed to a POH plan: the caller
  plans it (:func:`cask_tpu_torch.ops.poh.poh_plan`) and passes the plan,
  which runs its CUDA kernel.

Operands run on the card unless the caller asks for the CPU, and a CPU
tensor is how a caller asks: a host (numpy) operand goes to the matrix's
device, or to the CUDA device when the matrix's arrays are host numpy too
(:func:`as_operand`), and raises without one.
"""

from __future__ import annotations

import collections
import dataclasses
import time
import weakref
from typing import Optional, Union

import numpy as np
import torch

from cask_tpu_torch.formats.matrix import BSR, COO, CSR, to_device, torch_dtype
from cask_tpu_torch.ops.bdia import BdiaMatrix, bdia_plan, scalar_dia_from_pack
from cask_tpu_torch.ops.bdia import transpose_plan as _bdia_transpose
from cask_tpu_torch.ops.bdia_slab import BdiaSlabs, slab_auto_plan
from cask_tpu_torch.ops.dia import DiaMatrix, dia_plan, estimate_dia_traffic, spmv_dia
from cask_tpu_torch.ops.dia import transpose_plan as _dia_transpose
from cask_tpu_torch.ops.kernels.bdia_kernels import bdia_kernel_ok, kernel_types_ok
from cask_tpu_torch.ops.kernels.dia_kernels import dia_kernel_ok
from cask_tpu_torch.ops.poh import PohMatrix, poh_transpose_plan
from cask_tpu_torch.utils.platform import default_device, plan_device
from cask_tpu_torch.utils.profiling import annotate

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
    transpose`; DIA and BDIA plans rebuild through their
    ``transpose_plan``.  Iterating algorithms that apply both A and Aᵀ
    should call this once up front instead of passing ``transpose=True``
    per application."""
    if isinstance(a, (CSR, COO, BSR)):
        from cask_tpu_torch.formats.convert import transpose as _t

        return _t(a)
    if isinstance(a, DiaMatrix):
        return _dia_transpose(a)
    if isinstance(a, BdiaMatrix):
        return _bdia_transpose(a)
    if isinstance(a, PohMatrix):
        return poh_transpose_plan(a)
    raise TypeError(f"cannot transpose {type(a)}")


# ---------------------------------------------------------------------------
# public op
# ---------------------------------------------------------------------------


class PlanCache:
    """The auto routes' plans, for ``spmv`` and ``spmm`` alike, one entry per
    (matrix, kind):

    - a :class:`BSR` gets its BDIA plan (kind ``"bdia"``);
    - a :class:`CSR` gets its DIA plan (``"dia"``), when
      :func:`estimate_dia_traffic` finds the split worth it;
    - a :class:`BdiaMatrix` gets its scalar-DIA plan (``"scalar_dia"``,
      :func:`cask_tpu_torch.ops.bdia.bdia_scalar_dia`), always, and its slab
      plan (``"slab"``, :func:`cask_tpu_torch.ops.bdia_slab.slab_auto_plan`)
      or ``None`` where the reference's gates admit none.

    A plan is built once per matrix and kind and reused by every later call
    on the same instance.  A BSR or CSR plan is planned in host numpy, its
    packed values then sent to the device (the matrix's, or the operand's
    for a matrix of host numpy arrays); a scalar-DIA plan is derived from
    the BDIA pack with tensor ops on the pack's own device
    (:func:`cask_tpu_torch.ops.bdia.scalar_dia_from_pack`).  A BSR or CSR
    plan qualifies when its kernel can take it and its scalar remainder
    holds at most ``_MAX_REMAINDER_SHARE`` of the stored entries; a matrix
    whose plan does not caches ``None``, so it never re-pays the planning
    probe.  Entries are held weakly: they go with their matrix.

    A plan copies the matrix's values, so each entry also keeps the version
    counters of the matrix's tensors: a tensor changed in place since
    (``a.data.mul_(2)``) makes the next ``get`` build the plan anew.  Host
    numpy arrays carry no such counter and are taken as frozen.

    Counters: ``builds`` (plans built, by kind; a stale plan built anew
    counts), ``build_s`` (host seconds in those builds, by kind) and
    ``hits`` (calls answered from the cache).  Under a profiler a build is
    the span ``plan.build.<kind>``, and a scalar-DIA build holds the spans
    of its steps, ``plan.scalar_dia.count``, ``plan.scalar_dia.fill`` and
    ``plan.scalar_dia.remainder``: a :func:`cask_tpu_torch.utils.profiling.trace`
    around a first ``spmm`` on a BDIA plan times each step.
    """

    def __init__(self):
        self._plans = weakref.WeakKeyDictionary()
        self.builds = collections.Counter()
        self.build_s = collections.defaultdict(float)
        self.hits = 0

    @staticmethod
    def _stamp(a):
        return tuple(getattr(getattr(a, f.name), "_version", None)
                     for f in dataclasses.fields(a))

    @staticmethod
    def _kind(a) -> str:
        for cls, kind in ((BSR, "bdia"), (CSR, "dia"), (BdiaMatrix, "scalar_dia")):
            if isinstance(a, cls):
                return kind
        raise TypeError(f"no cached plan for {type(a)}")

    @staticmethod
    def _build(a, kind: str, device) -> Union[BdiaMatrix, DiaMatrix, BdiaSlabs, None]:
        if kind == "scalar_dia":
            return scalar_dia_from_pack(a)
        if kind == "slab":
            return slab_auto_plan(a)
        if kind == "bdia":
            p = bdia_plan(a, a.blocksize, device=device)
            ok = bdia_kernel_ok(p)
        else:
            if estimate_dia_traffic(a) is None:
                return None
            p = dia_plan(a, device=device)
            ok = dia_kernel_ok(p)
        ok = ok and p.rem_data.shape[0] <= _MAX_REMAINDER_SHARE * max(a.nnz, 1)
        return p if ok else None

    def get(self, a, kind: Optional[str] = None, device=None):
        """The plan of ``kind`` (default: the matrix type's) for ``a``, built
        on first use; ``device`` places a plan built from host numpy arrays
        (default: the CUDA device)."""
        kind = kind or self._kind(a)
        stamp = self._stamp(a)
        entries = self._plans.setdefault(a, {})
        hit = entries.get(kind)
        if hit is None or hit[0] != stamp:
            t0 = time.perf_counter()
            with annotate(f"plan.build.{kind}"):
                plan = self._build(a, kind, device)
            self.build_s[kind] += time.perf_counter() - t0
            self.builds[kind] += 1
            entries[kind] = hit = (stamp, plan)
        else:
            self.hits += 1
        return hit[1]


# the one cache that the ``spmv`` and ``spmm`` auto routes use
default_plan_cache = PlanCache()


def cached_plan(a, x: torch.Tensor):
    """The auto route's plan for a CSR or BSR and a CUDA operand ``x``: built
    on ``x``'s device for a matrix of host numpy arrays, on the matrix's own
    for one of tensors there.  None when ``x`` lies on the CPU (which asks
    for the CPU), when the matrix's tensors lie elsewhere, or when the plan
    does not qualify or its kernels do not take its values with ``x``'s type
    (:func:`cask_tpu_torch.ops.kernels.bdia_kernels.kernel_types_ok`: one
    f32 or f64 type, or bf16 or f16 values or ``x`` with the other of the
    same half type or f32)."""
    if not x.is_cuda or (isinstance(a.data, torch.Tensor) and a.data.device != x.device):
        return None
    plan = default_plan_cache.get(a, device=x.device)
    ok = plan is not None and kernel_types_ok(plan.dtype, x.dtype) and plan.device == x.device
    return plan if ok else None


def operand_device(a) -> torch.device:
    """Where host data for ``a`` goes: the matrix's device when its arrays
    are tensors (a plan's or an operator's ``device``), else the CUDA device
    (:func:`default_device`, which raises without one)."""
    home = plan_device(a.data) if isinstance(a, (CSR, COO, BSR)) else getattr(a, "device", None)
    return home if home is not None else default_device()


def as_operand(a, x) -> torch.Tensor:
    """``x`` as a tensor.  A tensor stays where it is (a CPU tensor asks for
    the CPU); host data goes to :func:`operand_device`."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=operand_device(a))


def shard_product(a, x, *, transpose: bool, method: str, accum_dtype) -> torch.Tensor:
    """``a(x)`` for a distributed operator's padded shard
    (:class:`~cask_tpu_torch.parallel.dist.ShardOperator`, which has no
    ``shape``): this rank's rows of the product, by the automatic route
    only.  Raises ``TypeError`` for anything else without a ``shape``."""
    from cask_tpu_torch.parallel.dist import ShardOperator  # parallel imports ops: late

    if not isinstance(a, ShardOperator):
        raise TypeError(f"unsupported matrix type {type(a)}")
    if transpose or method != "auto" or accum_dtype is not None:
        raise ValueError("a distributed operator's shard takes the automatic product only")
    return a(x)


def spmv(a, x, *, transpose: bool = False, method: str = "auto",
         accum_dtype: Optional[object] = None):
    """``y = a @ x`` (or ``aᵀ @ x``).  See the module docstring for methods.

    ``method='auto'`` on a :class:`BSR` or :class:`CSR` with ``x`` on a CUDA
    device (or host data, which goes there) routes through its plan in
    :data:`default_plan_cache` (BDIA or DIA) and the CUDA kernel, so the
    obvious API call on the obvious input, a generated matrix and a numpy
    vector, is the tuned path.  A plan that does not qualify, a transposed
    or re-typed product, and a CPU tensor ``x`` take the gather
    formulation.  A distributed operator's padded shard
    (``DistSpmv(...).padded_op``) gives this rank's rows of its product."""
    if not hasattr(a, "shape"):  # no matrix: a distributed operator's shard
        return shard_product(a, x, transpose=transpose, method=method, accum_dtype=accum_dtype)
    x = as_operand(a, x).contiguous()  # the kernels take contiguous operands
    if x.ndim != 1:
        raise ValueError(f"x must be 1-D, got shape {tuple(x.shape)}")
    n_expect = a.shape[0] if transpose else a.shape[1]
    if x.shape[0] != n_expect:
        raise ValueError(f"dimension mismatch: A {a.shape} (transpose={transpose}) "
                         f"vs x {tuple(x.shape)}")

    if method == "dia":
        return spmv_dia(a, x, transpose=transpose)
    if method == "bdia":
        if transpose:
            from cask_tpu_torch.formats.convert import transpose as _t

            a = _t(a)  # BSR transposes in place; blocksize swaps with it
        return bdia_plan(a, getattr(a, "blocksize", None), device=x.device).spmv(x)
    if method not in ("auto", "xla"):
        raise ValueError(f"unknown spmv method {method!r}")

    auto = method == "auto" and not transpose and accum_dtype is None
    if isinstance(a, CSR):
        plan = cached_plan(a, x) if auto else None
        return plan.spmv(x) if plan is not None else _spmv_xla_csr(a, x, transpose, accum_dtype)
    if isinstance(a, COO):
        return _spmv_xla_coo(a, x, transpose, accum_dtype)
    if isinstance(a, BSR):
        plan = cached_plan(a, x) if auto else None
        return plan.spmv(x) if plan is not None else _spmv_xla_bsr(a, x, transpose, accum_dtype)
    if isinstance(a, BdiaMatrix):
        if transpose:
            a = _bdia_transpose(a)  # one-time host rebuild; hold the plan to reuse
        return a.spmv(x)
    if isinstance(a, DiaMatrix):
        return spmv_dia(a, x, transpose=transpose)
    if isinstance(a, PohMatrix):
        if transpose:
            a = poh_transpose_plan(a)  # one-time host repack; hold transposed(a) to reuse
        return a.spmv(x)
    raise TypeError(f"unsupported matrix type {type(a)}")
