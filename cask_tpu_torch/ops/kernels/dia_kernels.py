"""DIA SpMV and SpMM: the hand-written CUDA kernels, their wrappers and their
plain twins.

:func:`dia_spmv` and :func:`dia_spmm` compute the packed diagonals' part of
``A·x`` and ``A·X`` for a :class:`cask_tpu_torch.ops.dia.DiaMatrix` (the COO
remainder is added by the caller, as in the JAX package).  On CUDA tensors
they launch the kernels of ``csrc/dia_spmv.cu`` and ``csrc/dia_spmm.cu`` or
raise; on CPU tensors they run :func:`dia_spmv_reference` and
:func:`dia_spmm_reference`, the same sums in plain PyTorch (the port of
``DiaMatrix._spmv_xla``/``_spmm_xla``).

Two kernels stand in for the eight TPU kernels of
``cask_tpu/ops/pallas/dia_kernels.py``: the SpMV one for
``dia_spmv_pallas_padded``, ``_layout``, ``_interleaved`` and ``_il_stream``
(which differ only in how the TPU lays x out), the SpMM one for
``dia_spmm_pallas_padded``, ``_ring_padded``, ``_kt_padded`` and
``_ring_mxu_padded`` (which differ only in how the TPU stages X).
"""

from __future__ import annotations

import ctypes
import functools
from typing import TYPE_CHECKING

import torch

from cask_tpu_torch.ops.kernels.bdia_kernels import (VALUE_DTYPES, _out_dtype, bind,
                                                     check_out_dtype, check_types, entry,
                                                     raise_on, result_dtype, vec_ok)

if TYPE_CHECKING:
    from cask_tpu_torch.ops.dia import DiaMatrix


def _padded(a: "DiaMatrix", x: torch.Tensor):
    """x (n, ...) embedded at row ``lo`` of a zero array long enough for
    every diagonal's window ``[lo + off, lo + off + m_pad)``, and ``lo``."""
    n = a.shape[1]
    lo = -min(min(a.offsets), 0)
    hi = max(max(a.offsets), 0)
    xp = x.new_zeros((lo + max(a.m_pad, n) + hi + 1, *x.shape[1:]))
    xp[lo : lo + n] = x
    return xp, lo


def dia_spmv_reference(a: "DiaMatrix", x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``Σ_d vals[d] · x-shift``, in offsets order, values and
    x widened to ``promote(out, f32)`` first and the sum rounded once to the
    output type :func:`_out_dtype` (f16 for f16 values and x): the port of
    ``DiaMatrix._spmv_xla`` without its remainder.

    Works on any device; the CUDA kernel is held against it."""
    xp, lo = _padded(a, x)
    out = _out_dtype(a.vals.dtype, x.dtype)
    acc = torch.promote_types(out, torch.float32)
    xp = xp.to(acc)
    y = torch.zeros(a.m_pad, dtype=acc, device=x.device)
    for d, off in enumerate(a.offsets):
        y = y + a.vals[d].to(acc) * xp[lo + off : lo + off + a.m_pad]
    return y[: a.shape[0]].to(out)


def dia_spmm_reference(a: "DiaMatrix", x: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """Plain PyTorch ``Σ_d vals[d][:, None] · X-shift``, in offsets order,
    summed in ``promote(out, f32)`` and cast to ``out`` (``out_dtype``, else
    the promotion of values and X, bf16 promoted to f32): the port of
    ``DiaMatrix._spmm_xla`` without its remainder."""
    xp, lo = _padded(a, x)
    out = result_dtype(a.vals.dtype, x.dtype, out_dtype)
    acc = torch.promote_types(out, torch.float32)
    xp = xp.to(acc)
    y = torch.zeros((a.m_pad, x.shape[1]), dtype=acc, device=x.device)
    for d, off in enumerate(a.offsets):
        y = y + a.vals[d][:, None].to(acc) * xp[lo + off : lo + off + a.m_pad]
    return y[: a.shape[0]].to(out)


def dia_kernel_ok(a: "DiaMatrix") -> bool:
    """Can the CUDA kernels take this plan?  They take any diagonal count,
    f32, f64, bf16 and f16 values."""
    return a.vals.dtype in VALUE_DTYPES


@functools.lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    extra = [i, i] if name == "dia_spmm" else []  # k, vec
    return bind(name, f"cask_{name}", [p, p, i, p, p, ll, ll, ll, *extra, p],
                spmm=name == "dia_spmm")


def _check(a: "DiaMatrix", x: torch.Tensor, ndim: int) -> None:
    """Raise on anything the kernels do not take."""
    m, n = a.shape
    if a.vals.device != x.device or a.offsets_dev.device != x.device:
        raise ValueError(f"x on {x.device} but the plan on {a.vals.device}")
    if x.ndim != ndim or x.shape[0] != n:
        raise ValueError(f"x must have {ndim} dimension(s) and {n} rows, "
                         f"got shape {tuple(x.shape)}")
    if a.vals.shape != (a.ndiags, a.m_pad) or a.m_pad < m \
            or a.offsets_dev.shape != (a.ndiags,) or a.offsets_dev.dtype != torch.int32:
        raise ValueError(f"vals {tuple(a.vals.shape)} / offsets {tuple(a.offsets_dev.shape)} "
                         f"are not the packed (ndiags, m_pad) layout of a {a.shape} plan")
    if not (x.is_contiguous() and a.vals.is_contiguous()):
        raise ValueError("kernel needs contiguous x and vals")


def dia_spmv(a: "DiaMatrix", x: torch.Tensor) -> torch.Tensor:
    """Diagonals' part of ``A·x``: the CUDA kernel for a CUDA ``x``, the plain
    twin for a CPU ``x``.  Raises on what the kernel does not take."""
    if not x.is_cuda:
        if a.vals.is_cuda:
            raise ValueError(f"x on {x.device} but the plan on {a.vals.device}")
        return dia_spmv_reference(a, x)
    _check(a, x, 1)
    check_types(a.vals.dtype, x.dtype)
    m, n = a.shape
    out = _out_dtype(a.vals.dtype, x.dtype)
    if m == 0 or n == 0:
        return torch.zeros(m, dtype=out, device=x.device)
    y = torch.empty(m, dtype=out, device=x.device)
    lib = _lib("dia_spmv")
    fn = getattr(lib, entry("cask_dia_spmv", a.vals.dtype, x.dtype))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(a.vals.data_ptr(), a.offsets_dev.data_ptr(), a.ndiags, x.data_ptr(),
                 y.data_ptr(), m, n, a.m_pad, stream)
    raise_on(lib, err, "dia_spmv")
    dia_spmv.launches += 1
    return y


def dia_spmm(a: "DiaMatrix", x: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """Diagonals' part of ``A·X`` for a dense row-major ``X (n, k)``: the CUDA
    kernel for a CUDA ``X``, the plain twin for a CPU ``X``.  ``out_dtype``
    as the reference's ring (``dia_kernels.py:1026-1033``): by default the
    promotion of values and X (bf16 promoted to f32, f16 · f16 gives f16);
    the half type for the fully-half chain, summed in f32 and rounded once.
    Raises on what the kernel does not take."""
    if not x.is_cuda:
        if a.vals.is_cuda:
            raise ValueError(f"X on {x.device} but the plan on {a.vals.device}")
        return dia_spmm_reference(a, x, out_dtype)
    _check(a, x, 2)
    out = result_dtype(a.vals.dtype, x.dtype, out_dtype)
    check_out_dtype(a.vals.dtype, x.dtype, out)
    if out == torch.float64 and x.dtype != torch.float64:
        raise TypeError("the DIA SpMM kernel has no float64 output for float32 values")
    m, n = a.shape
    k = int(x.shape[1])
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, k), dtype=out, device=x.device)
    y = torch.empty((m, k), dtype=out, device=x.device)
    vec = vec_ok(k, x, y)  # 16-byte vector loads and stores
    lib = _lib("dia_spmm")
    fn = getattr(lib, entry("cask_dia_spmm", a.vals.dtype, x.dtype, out))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(a.vals.data_ptr(), a.offsets_dev.data_ptr(), a.ndiags, x.data_ptr(),
                 y.data_ptr(), m, n, a.m_pad, k, vec, stream)
    raise_on(lib, err, "dia_spmm")
    dia_spmm.launches += 1
    return y


dia_spmv.launches = 0  # kernel launches since the last reset
dia_spmm.launches = 0
