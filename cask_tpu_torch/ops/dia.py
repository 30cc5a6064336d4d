"""Diagonal-packed (DIA/HYB) SpMV and SpMM — the banded-matrix path.

The PyTorch counterpart of :mod:`cask_tpu.ops.dia`.  The matrix's
populated diagonals are packed into a dense ``(ndiags, m_pad)`` value array
that streams from device memory; each diagonal contributes one shifted
FMA, with no gathers.  Diagonals below a density threshold spill their
entries to a COO remainder, added with ``index_add_`` (HYB).

Planning (:func:`dia_plan`) is host numpy and packs ``vals`` exactly as the
JAX package does (rows padded to ``_ROW_TILE``); the plan's tensors then
live on the device the caller names, by default the CUDA device.  The
product runs in the CUDA kernels of
:mod:`cask_tpu_torch.ops.kernels.dia_kernels` on a CUDA device, or in their
plain twins on the CPU.  The TPU's solver layouts (``to_layout``,
``to_interleaved``, the streamed-x and pre-transposed value variants) have
no counterpart: the Hopper kernels read natural-order vectors, so
:class:`DiaOperator` works in natural order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from cask_tpu_torch.formats.matrix import CSR, host, to_device, torch_dtype, value_dtype
from cask_tpu_torch.ops.kernels.dia_kernels import (dia_kernel_ok, dia_spmm,
                                                    dia_spmm_reference, dia_spmv,
                                                    dia_spmv_reference)
from cask_tpu_torch.utils.platform import plan_device

# Row padding granularity of the packed values: the JAX package's Pallas
# value tile (64 × 128), kept so the packed arrays equal the reference's.
_ROW_TILE = 64 * 128


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def remainder_spmm(rem_data, rem_row, rem_col, m: int, x: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """The COO remainder's product with ``x`` (1-D or 2-D) as ``dtype``, the
    product's output type: the reference's remainder add
    (``ops/spmm.py:217-221``), summed in ``promote(dtype, f32)`` and rounded
    once, as the kernels sum (an f16 ``y`` plus it then rounds twice, as the
    reference's f16 ``y + remainder`` does)."""
    acc = torch.promote_types(dtype, torch.float32)
    xr = x[rem_col.long()].to(acc)
    vals = rem_data.to(acc)
    prod = vals[:, None] * xr if x.ndim == 2 else vals * xr
    return prod.new_zeros((m, *x.shape[1:])).index_add_(0, rem_row.long(), prod).to(dtype)


@dataclasses.dataclass(frozen=True, eq=False)
class DiaMatrix:
    """Diagonal-packed matrix plus COO remainder (HYB).

    ``vals[d, r]`` is entry ``A[r, r + offsets[d]]`` (0 outside bounds);
    rows are padded to ``_ROW_TILE``.  ``offsets_dev`` is ``offsets`` as an
    int32 tensor on the plan's device, built once with the plan, which the
    kernels read.  All tensors live on one device.
    """

    vals: torch.Tensor  # (ndiags, m_pad)
    rem_data: torch.Tensor  # (nrem,) remainder values (may be size 0)
    rem_row: torch.Tensor  # (nrem,) int32
    rem_col: torch.Tensor  # (nrem,) int32
    # row-major copy (m_pad, ndiags), carried for parity with the reference
    # plan (its SpMM kernels stream it); the Hopper kernels read ``vals``
    vals_t: Optional[torch.Tensor]
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]
    offsets_dev: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "offsets_dev", torch.tensor(
            self.offsets, dtype=torch.int32, device=self.vals.device))

    @property
    def m_pad(self) -> int:
        return int(self.vals.shape[1])

    @property
    def ndiags(self) -> int:
        return len(self.offsets)

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def traffic_bytes(self) -> int:
        """Device-memory bytes per SpMV: the streamed values + remainder."""
        db = self.vals.element_size()
        return int(self.vals.numel() * db + self.rem_data.shape[0] * (db + 8))

    def to(self, device) -> "DiaMatrix":
        return dataclasses.replace(
            self, vals=self.vals.to(device), rem_data=self.rem_data.to(device),
            rem_row=self.rem_row.to(device), rem_col=self.rem_col.to(device),
            vals_t=None if self.vals_t is None else self.vals_t.to(device))

    def astype(self, dtype) -> "DiaMatrix":
        dt = torch_dtype(dtype)
        return dataclasses.replace(
            self, vals=self.vals.to(dt), rem_data=self.rem_data.to(dt),
            vals_t=None if self.vals_t is None else self.vals_t.to(dt))

    # -- compute ----------------------------------------------------------

    def spmv(self, x: torch.Tensor) -> torch.Tensor:
        """``A·x``: the kernel on a CUDA device (raises on what it does not
        take), the plain twin on the CPU; the remainder added after."""
        return self._with_remainder(dia_spmv(self, x), x)

    def spmm(self, x: torch.Tensor) -> torch.Tensor:
        """``A·X`` for a dense ``X (n, k)``, as :meth:`spmv`."""
        return self._with_remainder(dia_spmm(self, x), x)

    def _spmv_reference(self, x: torch.Tensor) -> torch.Tensor:
        """The same math in plain PyTorch on any device (the port of
        ``_spmv_xla``)."""
        return self._with_remainder(dia_spmv_reference(self, x), x)

    def _spmm_reference(self, x: torch.Tensor) -> torch.Tensor:
        """The port of ``_spmm_xla``."""
        return self._with_remainder(dia_spmm_reference(self, x), x)

    def _with_remainder(self, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        if not self.rem_data.shape[0]:
            return y
        return y + remainder_spmm(self.rem_data, self.rem_row, self.rem_col, self.shape[0], x,
                                  y.dtype)


class DiaOperator:
    """Solver-facing SpMV operator on a DIA plan.

    The counterpart of the JAX package's zero-copy padded-layout operator:
    every Krylov vector stays in one layout, so iterations pay no relayout.
    On Hopper that layout is natural order (``to_padded``/``from_padded``
    are identities), and ``__call__`` launches the same kernel as
    :meth:`DiaMatrix.spmv`.  ``mode`` is ``"kernel"`` for a plan on a CUDA
    device and ``"reference"`` (the plain twin) for a plan on the CPU.
    The reference's ``layout``/``interleaved``/``stream_x`` choices are TPU
    relayouts that Hopper does not need.
    """

    def __init__(self, a, *, device=None):
        if isinstance(a, CSR):
            a = dia_plan(a, device=device)
        if not isinstance(a, DiaMatrix):
            raise TypeError(f"DiaOperator needs a CSR or a DiaMatrix, got {type(a)}")
        if a.vals.is_cuda and not dia_kernel_ok(a):
            raise ValueError(f"the CUDA DIA kernel cannot take a {a.dtype} plan")
        self.dia = a
        self.mode = "kernel" if a.vals.is_cuda else "reference"

    @property
    def device(self) -> torch.device:
        return self.dia.device

    def to_padded(self, v) -> torch.Tensor:
        return torch.as_tensor(v, device=self.device)

    def from_padded(self, v: torch.Tensor) -> torch.Tensor:
        return v

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return self.dia.spmv(v)


def solver_operator(a, *, device=None) -> DiaOperator:
    """The SpMV operator for iterative solves on a banded matrix.

    Returns an object with ``to_padded`` / ``from_padded`` / ``__call__``,
    so solver code is uniform::

        op = cask_tpu_torch.solver_operator(a)
        res = cask_tpu_torch.solvers.cg(op, op.to_padded(b))
        x = op.from_padded(res.x)
    """
    return DiaOperator(a, device=device)


def _diagonal_counts(a: CSR):
    """(rows, offsets, unique offsets, their counts, their densities)."""
    m, n = a.shape
    indptr = host(a.indptr).astype(np.int64)
    indices = host(a.indices).astype(np.int64)
    rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(indptr))
    offs = indices - rows
    uniq, counts = np.unique(offs, return_counts=True)
    return rows, offs, uniq, counts, _density(uniq, counts, (m, n))


def _density(uniq: np.ndarray, counts: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """The share of each diagonal ``uniq`` that its ``counts`` entries fill."""
    m, n = shape
    diag_len = np.minimum(np.minimum(m, n - uniq), np.minimum(n, m + uniq))
    return counts / np.maximum(diag_len, 1)


def kept_offsets(uniq: np.ndarray, counts: np.ndarray, shape: Tuple[int, int], *,
                 min_density: float = 0.10, max_diags: int = 1024) -> np.ndarray:
    """The diagonals :func:`dia_plan` packs, ascending: of the offsets
    ``uniq`` (ascending, ``np.unique``'s), each holding ``counts`` (int64)
    stored entries, those at least ``min_density`` full; where more than
    ``max_diags`` are, the ``max_diags`` fullest by count instead.  The one
    keep rule of every scalar-DIA plan, whatever derived the counts."""
    keep = _density(uniq, counts, shape) >= min_density
    if keep.sum() > max_diags:
        top = np.argsort(-counts)[:max_diags]
        keep = np.zeros_like(keep)
        keep[top] = True
    return uniq[keep]


def dia_plan(a: CSR, *, min_density: float = 0.10, max_diags: int = 1024,
             with_vals_t: bool = False, device=None) -> DiaMatrix:
    """Pack ``a``'s dense-enough diagonals; spill the rest to COO.

    ``min_density``: keep a diagonal if it holds at least this fraction of
    its possible entries.  Host numpy planning, exactly as the JAX package
    packs; the plan's tensors go to ``device`` (default: where ``a``'s
    tensors are, the CUDA device for host numpy arrays)."""
    device = plan_device(a.data, device)
    vdt = value_dtype(a.data)  # bf16 values are planned as their exact f32
    m, n = a.shape
    indices = host(a.indices).astype(np.int64)
    data = host(a.data)
    rows, offs, uniq, counts, _ = _diagonal_counts(a)
    kept = kept_offsets(uniq, counts, (m, n), min_density=min_density, max_diags=max_diags)

    in_dia = np.isin(offs, kept)

    m_pad = _round_up(max(m, 1), _ROW_TILE)
    vals = np.zeros((max(len(kept), 1), m_pad), dtype=data.dtype)
    if len(kept):
        d_ids = np.searchsorted(kept, offs[in_dia])
        vals[d_ids, rows[in_dia]] = data[in_dia]
        offsets = tuple(int(o) for o in kept)
    else:
        offsets = (0,)

    rem = ~in_dia
    return DiaMatrix(
        vals=to_device(vals, device, vdt),
        rem_data=to_device(data[rem], device, vdt),
        rem_row=to_device(rows[rem].astype(np.int32), device),
        rem_col=to_device(indices[rem].astype(np.int32), device),
        vals_t=to_device(np.ascontiguousarray(vals.T), device, vdt) if with_vals_t else None,
        offsets=offsets,
        shape=(m, n),
    )


def estimate_dia_traffic(a: CSR, *, min_density: float = 0.10,
                         max_diags: int = 1024) -> Optional[float]:
    """Streamed entries per SpMV under the DIA split, or None when the split
    is clearly unprofitable (less than half the entries on kept diagonals)."""
    m, _ = a.shape
    _, _, _, counts, density = _diagonal_counts(a)
    keep = density >= min_density
    if keep.sum() > max_diags:
        keep &= counts >= np.sort(counts[keep])[-max_diags]
    dia_entries = int(keep.sum()) * m
    rem_entries = int(counts[~keep].sum())
    covered = counts[keep].sum() / max(a.nnz, 1)
    if covered < 0.5:  # mostly remainder → DIA adds no value
        return None
    return dia_entries + rem_entries * 3.0  # remainder entries cost ~3x (idx+scatter)


def transpose_plan(a: DiaMatrix) -> DiaMatrix:
    """Plan for ``Aᵀ``: diagonal ``d`` of A at offset ``k`` is the diagonal
    of Aᵀ at offset ``−k``, shifted along itself by ``k``:
    ``Aᵀ[r, r−k] = A[r−k, r]`` ⇒ ``valsᵀ[d, r] = vals[d, r − k]``.

    A host-side one-time shuffle onto the plan's device.  Unlike the JAX
    package's, it copies only the rows both paddings hold, so tall plans
    (more padded rows than padded columns) transpose too."""
    m, n = a.shape
    vals = host(a.vals)
    m_pad = vals.shape[1]
    n_pad = _round_up(max(n, 1), _ROW_TILE)
    new_vals = np.zeros((vals.shape[0], n_pad), vals.dtype)
    for d, off in enumerate(a.offsets):
        r0, r1 = max(off, 0), min(n_pad, m_pad + off)  # rows r with 0 <= r − off < m_pad
        if r1 > r0:
            new_vals[d, r0:r1] = vals[d, r0 - off : r1 - off]
    return DiaMatrix(
        vals=to_device(new_vals, a.device, a.dtype),
        rem_data=a.rem_data,
        rem_row=a.rem_col,
        rem_col=a.rem_row,
        vals_t=None,
        offsets=tuple(-off for off in a.offsets),
        shape=(n, m),
    )


def spmv_dia(a, x: torch.Tensor, *, transpose: bool = False) -> torch.Tensor:
    """``A·x`` (or ``Aᵀ·x``) through a DIA plan; a CSR is planned on ``x``'s
    device first (a one-time host step: hold the plan to reuse it)."""
    if isinstance(a, CSR):
        a = dia_plan(a, device=x.device)
    if not isinstance(a, DiaMatrix):
        raise TypeError(f"spmv_dia needs CSR or DiaMatrix, got {type(a)}")
    if transpose:
        a = transpose_plan(a)
    return a.spmv(x)


def spmm_dia(a, x: torch.Tensor, *, transpose: bool = False) -> torch.Tensor:
    """``A·X`` (or ``Aᵀ·X``) through a DIA plan, as :func:`spmv_dia`."""
    if isinstance(a, CSR):
        a = dia_plan(a, device=x.device)
    if not isinstance(a, DiaMatrix):
        raise TypeError(f"spmm_dia needs CSR or DiaMatrix, got {type(a)}")
    if transpose:
        a = transpose_plan(a)
    return a.spmm(x)
