"""BDIA SpMV: the hand-written CUDA kernel, its wrapper and its plain twin.

:func:`bdia_spmv` computes the packed block diagonals' part of ``A·x`` for
a :class:`cask_tpu_torch.ops.bdia.BdiaMatrix` (the COO remainder is added
by the caller, as in the JAX package).  On a CUDA tensor it launches the
kernel of ``csrc/bdia_spmv.cu`` or raises; on a CPU tensor it runs
:func:`bdia_spmv_reference`, the same sum in plain PyTorch.  One kernel
stands in for both TPU kernels of the path,
``cask_tpu/ops/pallas/bdia_kernels.py:bdia_spmv_pallas_fused`` and
``:bdia_spmv_pallas_resident``: on Hopper, natural-order vectors need no
relayout, so the solver layout is the natural one.
"""

from __future__ import annotations

import ctypes
import functools
from typing import TYPE_CHECKING

import torch

from cask_tpu_torch.ops.kernels import build

if TYPE_CHECKING:
    from cask_tpu_torch.ops.bdia import BdiaMatrix

_LANE = 128
MAX_PAIRS = 80  # (d, c) slots a plan may hold for the kernel (kMaxDiags)
_KERNEL_DTYPES = (torch.float32, torch.float64)


def _out_dtype(vals_dtype: torch.dtype, x_dtype: torch.dtype) -> torch.dtype:
    acc = torch.promote_types(vals_dtype, x_dtype)
    if torch.bfloat16 in (vals_dtype, x_dtype):
        acc = torch.promote_types(acc, torch.float32)
    return acc


def bdia_spmv_reference(a: "BdiaMatrix", x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``Σ_j vals[:, j] · x-shift`` over the packed pairs, in
    pair order: the port of ``BdiaMatrix._spmv_xla`` without its remainder.

    Works on any device; the CUDA kernel is held against it."""
    br, bc = a.blocksize
    m, n = a.shape
    nbr, nbc, lo, hi = a.nbr, a.nbc, a.lo, a.hi
    T, plane = a.n_tiles, a.ts * _LANE
    acc = _out_dtype(a.vals.dtype, x.dtype)
    xn = x.new_zeros(nbc * bc)
    xn[:n] = x
    # component rows x_c[i] = x[i·bc + c], zero outside [0, nbc): every
    # shifted window [lo + d, lo + d + T·plane) stays inside
    xp = x.new_zeros((bc, lo + max(nbc, T * plane) + hi + 1))
    xp[:, lo : lo + nbc] = xn.reshape(nbc, bc).T
    vt = a.vals.reshape(br, T, a.npairs, plane)
    y = torch.zeros((br, T, plane), dtype=acc, device=x.device)
    for j, (c, d) in enumerate(a.pairs):
        xs = xp[c, lo + d : lo + d + T * plane].reshape(T, plane)
        y += vt[:, :, j, :].to(acc) * xs.to(acc)
    return y.reshape(br, T * plane)[:, :nbr].T.reshape(-1)[:m]


def bdia_kernel_ok(a: "BdiaMatrix") -> bool:
    """Can the CUDA kernel take this plan (pair count and value type)?"""
    return a.npairs <= MAX_PAIRS and a.vals.dtype in _KERNEL_DTYPES


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = build.load("bdia_spmv")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for fn in (lib.cask_bdia_spmv_f32, lib.cask_bdia_spmv_f64):
        fn.argtypes = [p, p, p, ctypes.POINTER(ctypes.c_int), i, i, i, ll, ll, ll,
                       i, i, p]
        fn.restype = ctypes.c_int
    lib.cask_cuda_error_string.argtypes = [ctypes.c_int]
    lib.cask_cuda_error_string.restype = ctypes.c_char_p
    return lib


def bdia_spmv(a: "BdiaMatrix", x: torch.Tensor) -> torch.Tensor:
    """``vals``-part of ``A·x``: the CUDA kernel for a CUDA ``x``, the plain
    twin for a CPU ``x``.  Raises on what the kernel does not take."""
    if not x.is_cuda:
        if a.vals.is_cuda:
            raise ValueError(f"x on {x.device} but the plan on {a.vals.device}")
        return bdia_spmv_reference(a, x)
    br, bc = a.blocksize
    m, n = a.shape
    if a.vals.device != x.device:
        raise ValueError(f"x on {x.device} but the plan on {a.vals.device}")
    if x.ndim != 1 or x.shape[0] != n:
        raise ValueError(f"x must have shape ({n},), got {tuple(x.shape)}")
    if x.dtype not in _KERNEL_DTYPES or a.vals.dtype != x.dtype:
        raise TypeError(f"kernel takes float32/float64 values and x of one type, "
                        f"got vals {a.vals.dtype}, x {x.dtype}")
    if a.npairs > MAX_PAIRS:
        raise ValueError(f"plan has {a.npairs} (d, c) pairs; the kernel takes "
                         f"at most {MAX_PAIRS}")
    if a.vals.shape != (br, a.n_tiles, a.npairs, a.ts, _LANE):
        raise ValueError(f"vals shape {tuple(a.vals.shape)} is not the packed "
                         f"(br, T, npairs, ts, 128) layout")
    if not (x.is_contiguous() and a.vals.is_contiguous()):
        raise ValueError("kernel needs contiguous x and vals")
    y = torch.empty(m, dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    lib = _lib()
    fn = lib.cask_bdia_spmv_f32 if x.dtype == torch.float32 else lib.cask_bdia_spmv_f64
    offs = (ctypes.c_int * len(a.block_offsets))(*a.block_offsets)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(a.vals.data_ptr(), x.data_ptr(), y.data_ptr(), offs,
                 len(a.block_offsets), br, bc, m, n, a.nbr, a.n_tiles,
                 a.ts * _LANE, stream)
    if err != 0:
        msg = lib.cask_cuda_error_string(err).decode()
        raise RuntimeError(f"bdia_spmv kernel launch failed: cudaError {err} ({msg})")
    bdia_spmv.launches += 1
    return y


bdia_spmv.launches = 0  # kernel launches since the last reset
