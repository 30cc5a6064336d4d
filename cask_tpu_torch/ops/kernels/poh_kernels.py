"""POH SpMV and SpMM: the hand-written CUDA kernels, their wrappers and their
plain twins.

:func:`poh_spmv` computes ``A·x`` and :func:`poh_spmm` ``A·X`` for a
:class:`cask_tpu_torch.ops.poh.PohMatrix`.  On a CUDA tensor each launches
its kernel (``csrc/poh_spmv.cu``, ``csrc/poh_spmm.cu``) or raises; on a CPU
tensor it runs its plain PyTorch twin.  They replace
``cask_tpu/ops/pallas/poh_kernels.py:poh_spmv_pallas`` (B16) and
``:poh_spmm_pallas`` (B17), whose one-hot MXU products are the TPU's way to
gather and scatter: the Hopper kernels gather x and scatter into a
shared-memory panel accumulator directly, in plain FP32/FP64.
"""

from __future__ import annotations

import ctypes
import functools
from typing import TYPE_CHECKING

import torch

from cask_tpu_torch.ops.kernels import build
from cask_tpu_torch.ops.kernels.bdia_kernels import _KERNEL_DTYPES, _out_dtype, raise_on

if TYPE_CHECKING:
    from cask_tpu_torch.ops.poh import PohMatrix

_MAX_SMEM = 232448  # bytes of shared memory a block may opt in to (227 KB)
_CTAS_PER_SM = 8  # SpMV: aim for this many CTAs per SM when splitting panels


def _slot_coords(p: "PohMatrix"):
    """Global (row, col) of every slot, flattened, as int64."""
    nt = p.ntiles
    rows = p.panel.long()[:, None] * p.row_panel + p.rloc.reshape(nt, -1).long()
    cols = p.wlo.long()[:, None] * p.col_window + p.cloc.reshape(nt, -1).long()
    return rows.reshape(-1), cols.reshape(-1)


def _x_padded(p: "PohMatrix", x: torch.Tensor) -> torch.Tensor:
    """``x`` (or ``X``) with zero rows up to the last window's end, so every
    slot's column (< (nseg + 1)·C) indexes it."""
    xp = x.new_zeros(((p.nseg + 1) * p.col_window,) + tuple(x.shape[1:]))
    xp[: p.shape[1]] = x
    return xp


def poh_spmv_reference(p: "PohMatrix", x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``y[row] += val · x[col]`` over every slot: products in
    ``promote(vals, x)`` (bf16 promoted to f32), the result in that type.
    The scatter sums in f64: ``index_add_`` on a CUDA tensor adds in no fixed
    order, and a power-law hub row gathers thousands of products, so an f32
    scatter would differ from run to run by more than the kernel's own
    rounding.  Works on any device; the CUDA kernel is held against it."""
    acc = _out_dtype(p.vals.dtype, x.dtype)
    rows, cols = _slot_coords(p)
    prod = p.vals.reshape(-1).to(acc) * _x_padded(p, x)[cols].to(acc)
    wide = torch.promote_types(acc, torch.float64)
    y = prod.new_zeros(p.n_panels * p.row_panel, dtype=wide).index_add_(0, rows, prod.to(wide))
    return y[: p.shape[0]].to(acc)


def poh_spmm_reference(p: "PohMatrix", x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``Y[row, :] += val · X[col, :]`` over every slot, as
    :func:`poh_spmv_reference`."""
    acc = _out_dtype(p.vals.dtype, x.dtype)
    rows, cols = _slot_coords(p)
    prod = p.vals.reshape(-1, 1).to(acc) * _x_padded(p, x)[cols].to(acc)
    wide = torch.promote_types(acc, torch.float64)
    y = prod.new_zeros((p.n_panels * p.row_panel, x.shape[1]), dtype=wide)
    return y.index_add_(0, rows, prod.to(wide))[: p.shape[0]].to(acc)


@functools.lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    lib = build.load(name)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if name == "poh_spmv":  # ..., x, y, n_panels, splits, R, C, T, m, n, stream
        args = [p] * 7 + [i, i, i, i, i, ll, ll, p]
    else:  # ..., X, Y, n_panels, R, C, T, m, n, k, stream
        args = [p] * 7 + [i, i, i, i, ll, ll, i, p]
    for fn in (getattr(lib, f"cask_{name}_f32"), getattr(lib, f"cask_{name}_f64")):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.cask_cuda_error_string.argtypes = [ctypes.c_int]
    lib.cask_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(p: "PohMatrix", x: torch.Tensor, ndim: int, what: str) -> None:
    """Raise on what the kernels do not take."""
    n = p.shape[1]
    if any(t.device != x.device for t in (p.vals, p.cloc, p.rloc, p.wlo, p.panel_ptr)):
        raise ValueError(f"{what} on {x.device} but the plan on {p.vals.device}")
    if x.ndim != ndim or x.shape[0] != n:
        raise ValueError(f"{what} must have shape ({n}{', k' if ndim == 2 else ''}), "
                         f"got {tuple(x.shape)}")
    if x.dtype not in _KERNEL_DTYPES or p.vals.dtype != x.dtype:
        raise TypeError(f"kernel takes float32/float64 values and {what} of one type, "
                        f"got vals {p.vals.dtype}, {what} {x.dtype}")
    slots = (p.ntiles, p.slot_rows, 128)
    if p.vals.shape != slots or p.cloc.shape != slots or p.rloc.shape != slots \
            or p.cloc.dtype != torch.int32 or p.rloc.dtype != torch.int32 \
            or p.wlo.dtype != torch.int32 or p.wlo.shape != (p.ntiles,):
        raise ValueError("vals/cloc/rloc/wlo are not the POH packing (ntiles, S, 128) "
                         "with int32 indices")
    if not all(t.is_contiguous() for t in (x, p.vals, p.cloc, p.rloc, p.wlo)):
        raise ValueError("kernel needs contiguous operands and slot arrays")
    if p.row_panel * x.element_size() > _MAX_SMEM:
        raise ValueError(f"row_panel {p.row_panel} needs {p.row_panel * x.element_size()} "
                         f"bytes of shared memory; a block has at most {_MAX_SMEM}")


def poh_spmv(p: "PohMatrix", x: torch.Tensor) -> torch.Tensor:
    """``A·x``: the CUDA kernel for a CUDA ``x``, the plain twin for a CPU
    ``x``.  Raises on what the kernel does not take."""
    if not x.is_cuda:
        if p.vals.is_cuda:
            raise ValueError(f"x on {x.device} but the plan on {p.vals.device}")
        return poh_spmv_reference(p, x)
    _check(p, x, 1, "x")
    m, n = p.shape
    y = torch.zeros(m, dtype=x.dtype, device=x.device)  # the kernel adds into it
    if m == 0 or n == 0:
        return y
    # split each panel's tile run so the grid holds _CTAS_PER_SM CTAs per SM
    # (no more pieces than tiles)
    want = -(-_CTAS_PER_SM * _sm_count(x.device.index or 0) // p.n_panels)
    splits = max(1, min(want, p.ntiles))
    lib = _lib("poh_spmv")
    fn = lib.cask_poh_spmv_f32 if x.dtype == torch.float32 else lib.cask_poh_spmv_f64
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(p.vals.data_ptr(), p.cloc.data_ptr(), p.rloc.data_ptr(), p.wlo.data_ptr(),
                 p.panel_ptr.data_ptr(), x.data_ptr(), y.data_ptr(), p.n_panels, splits,
                 p.row_panel, p.col_window, p.slot_rows * 128, m, n, stream)
    raise_on(lib, err, "poh_spmv")
    poh_spmv.launches += 1
    return y


def poh_spmm(p: "PohMatrix", x: torch.Tensor) -> torch.Tensor:
    """``A·X`` for a dense row-major ``X (n, k)``, any k: the CUDA kernel for
    a CUDA ``X``, the plain twin for a CPU ``X``.  Raises on what the kernel
    does not take."""
    if not x.is_cuda:
        if p.vals.is_cuda:
            raise ValueError(f"X on {x.device} but the plan on {p.vals.device}")
        return poh_spmm_reference(p, x)
    _check(p, x, 2, "X")
    m, n = p.shape
    k = int(x.shape[1])
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, k), dtype=x.dtype, device=x.device)
    y = torch.empty((m, k), dtype=x.dtype, device=x.device)  # every element is written
    lib = _lib("poh_spmm")
    fn = lib.cask_poh_spmm_f32 if x.dtype == torch.float32 else lib.cask_poh_spmm_f64
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(p.vals.data_ptr(), p.cloc.data_ptr(), p.rloc.data_ptr(), p.wlo.data_ptr(),
                 p.panel_ptr.data_ptr(), x.data_ptr(), y.data_ptr(), p.n_panels, p.row_panel,
                 p.col_window, p.slot_rows * 128, m, n, k, stream)
    raise_on(lib, err, "poh_spmm")
    poh_spmm.launches += 1
    return y


poh_spmv.launches = 0  # kernel launches since the last reset
poh_spmm.launches = 0
