"""ELL-packed BSR SpMM: the plan, bound to its CUDA kernel.

The PyTorch counterpart of the plan half of
:mod:`cask_tpu.ops.pallas.bsr_kernels`.  Block rows are grouped ``G =
max(1, 8 // br)`` at a time and each is padded to ``K`` block slots (the
most any block row holds); padded slots point at block column 0 with zero
values.  The packed ``vals (T, G·br, K·bc)`` and ``cols (T·G·K,)`` equal the
reference's exactly; they are packed with vectorised numpy, not the
reference's Python loop over block rows.  The product runs in the kernel
of :mod:`cask_tpu_torch.ops.kernels.bsr_kernels` on a CUDA device, or in its
plain twin on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from cask_tpu_torch.formats.matrix import BSR, host, to_device, value_dtype
from cask_tpu_torch.ops.kernels.bsr_kernels import bsr_spmm
from cask_tpu_torch.utils.platform import plan_device


@dataclasses.dataclass(frozen=True, eq=False)
class BsrSpmmKernel:
    """A BSR matrix ELL-packed for the SpMM kernel; both tensors on one
    device."""

    vals: torch.Tensor  # (T, G·br, K·bc)
    cols: torch.Tensor  # (T·G·K,) int32 block-column ids
    shape: Tuple[int, int]
    blocksize: Tuple[int, int]
    G: int
    K: int
    k: int  # dense width this plan was built for (the reference's field)

    @property
    def n_block_rows(self) -> int:
        return -(-self.shape[0] // self.blocksize[0])

    @classmethod
    def plan(cls, a: BSR, k: int, *, device=None) -> "BsrSpmmKernel":
        """Pack ``a`` as the reference's ``BsrSpmmKernel.plan`` does; the
        tensors go to ``device`` (default: where ``a``'s tensors are, the
        CUDA device for host numpy arrays)."""
        device = plan_device(a.data, device)
        vdt = value_dtype(a.data)  # bf16 values are planned as their exact f32
        br, bc = a.blocksize
        G = max(1, 8 // br)
        nbr = a.n_block_rows
        T = -(-nbr // G)
        indptr = host(a.indptr).astype(np.int64)
        indices = host(a.indices).astype(np.int64)
        data = host(a.data)
        lens = np.diff(indptr)
        K = max(int(lens.max(initial=0)), 1)
        ib = np.repeat(np.arange(nbr, dtype=np.int64), lens)  # block row of each block
        slot = np.arange(ib.size, dtype=np.int64) - indptr[ib]
        vals = np.zeros((T * G, br, K, bc), dtype=data.dtype)
        vals[ib, :, slot, :] = data
        cols = np.zeros(T * G * K, dtype=np.int32)
        cols[ib * K + slot] = indices
        return cls(vals=to_device(vals.reshape(T, G * br, K * bc), device, vdt),
                   cols=to_device(cols, device), shape=a.shape, blocksize=(br, bc),
                   G=G, K=K, k=int(k))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return bsr_spmm(self, x)


def spmm_bsr(a: BSR, x: torch.Tensor, *, transpose: bool = False) -> torch.Tensor:
    """``A·X`` (or ``Aᵀ·X``) through the BSR SpMM kernel, planned on ``x``'s
    device (a one-time host step: hold :meth:`BsrSpmmKernel.plan` to reuse
    it).  ``transpose`` re-encodes ``Aᵀ`` on the host first, as the
    reference's ``bsr_spmm_pallas`` does."""
    if not isinstance(a, BSR):
        raise TypeError(f"the BSR SpMM kernel needs a BSR matrix, got {type(a)}")
    if transpose:
        from cask_tpu_torch.formats.convert import transpose as _t

        a = _t(a)
    return BsrSpmmKernel.plan(a, k=int(x.shape[1]), device=x.device)(x)
