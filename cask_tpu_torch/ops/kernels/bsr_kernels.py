"""BSR SpMM: the hand-written CUDA kernel, its wrapper and its plain twin.

:func:`bsr_spmm` computes ``A·X`` for an ELL-packed
:class:`cask_tpu_torch.ops.bsr_spmm.BsrSpmmKernel`.  On a CUDA tensor it
launches the kernel of ``csrc/bsr_spmm.cu`` or raises; on a CPU tensor it
runs :func:`bsr_spmm_reference`, the same product in plain PyTorch.  It
replaces ``cask_tpu/ops/pallas/bsr_kernels.py:BsrSpmmKernel`` (B7), whose
double-buffered VMEM panel of DMA'd X block rows has no counterpart: the
Hopper kernel stages a block's values and ``cols`` in shared memory and
gathers X rows by ``cols`` straight into registers.

Types: f32 or f64 values and X of one type, or the half path (bf16 or f16
values or X, with the other of the same half type or f32), which sums in
f32; the output always has the values' type, as the reference's (a half Y
even for an f32 X, each f32 sum rounded once).
"""

from __future__ import annotations

import ctypes
import functools
from typing import TYPE_CHECKING

import torch

from cask_tpu_torch.ops.kernels.bdia_kernels import (bind, check_types, entry, raise_on,
                                                     vec_ok)

if TYPE_CHECKING:
    from cask_tpu_torch.ops.bsr_spmm import BsrSpmmKernel


def bsr_spmm_reference(p: "BsrSpmmKernel", x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ELL product: gather each block row's ``K`` X block rows
    by ``cols`` (rows ``n ≤ row < n_pad`` as zero), one batched
    ``(br, K·bc) @ (K·bc, k)`` product per block row, summed in
    ``promote(vals, f32)`` with each side widened exactly; the output has
    the values' type, as the reference's.  Works on any device; the CUDA
    kernel is held against it."""
    m, n = p.shape
    br, bc = p.blocksize
    T = p.vals.shape[0]
    k = x.shape[1]
    acc = torch.promote_types(p.vals.dtype, torch.float32)
    nbc = -(-n // bc)
    xp = x.new_zeros((nbc * bc, k))
    xp[:n] = x
    xb = xp.reshape(nbc, bc, k)[p.cols.long()].reshape(T * p.G, p.K * bc, k)
    v = p.vals.reshape(T * p.G, br, p.K * bc)
    y = torch.bmm(v.to(acc), xb.to(acc))  # (T·G, br, k)
    return y.reshape(T * p.G * br, k)[:m].to(p.vals.dtype)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return bind("bsr_spmm", "cask_bsr_spmm", [p, p, p, p, ll, i, i, i, i, ll, ll, ll, i, i, p],
                spmm=False)


def bsr_spmm(p: "BsrSpmmKernel", x: torch.Tensor) -> torch.Tensor:
    """``A·X`` for a dense row-major ``X (n, k)``: the CUDA kernel for a CUDA
    ``X``, the plain twin for a CPU ``X``.  Raises on what the kernel does
    not take."""
    if not x.is_cuda:
        if p.vals.is_cuda:
            raise ValueError(f"X on {x.device} but the plan on {p.vals.device}")
        return bsr_spmm_reference(p, x)
    m, n = p.shape
    br, bc = p.blocksize
    T = int(p.vals.shape[0])
    if p.vals.device != x.device or p.cols.device != x.device:
        raise ValueError(f"X on {x.device} but the plan on {p.vals.device}")
    if x.ndim != 2 or x.shape[0] != n:
        raise ValueError(f"X must have shape ({n}, k), got {tuple(x.shape)}")
    check_types(p.vals.dtype, x.dtype)
    if p.vals.shape != (T, p.G * br, p.K * bc) or p.cols.shape != (T * p.G * p.K,) \
            or p.cols.dtype != torch.int32 or not 1 <= p.G <= 8:
        raise ValueError(f"vals {tuple(p.vals.shape)} / cols {tuple(p.cols.shape)} are not "
                         f"the ELL packing (T, G·br, K·bc) / (T·G·K,) int32 with G <= 8")
    if not (x.is_contiguous() and p.vals.is_contiguous() and p.cols.is_contiguous()):
        raise ValueError("kernel needs contiguous X, vals and cols")
    k = int(x.shape[1])
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, k), dtype=p.vals.dtype, device=x.device)
    y = torch.empty((m, k), dtype=p.vals.dtype, device=x.device)
    lib = _lib()
    fn = getattr(lib, entry("cask_bsr_spmm", p.vals.dtype, x.dtype))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(p.vals.data_ptr(), p.cols.data_ptr(), x.data_ptr(), y.data_ptr(), T, p.G,
                 p.K, br, bc, m, n, p.n_block_rows, k, vec_ok(k, x, y), stream)
    raise_on(lib, err, "bsr_spmm")
    bsr_spmm.launches += 1
    return y


bsr_spmm.launches = 0  # kernel launches since the last reset
