"""Roofline accounting: bytes per op and the achieved share of the card's
bandwidth.

The PyTorch counterpart of :mod:`cask_tpu.bench.roofline`.  The denominator
is the published HBM bandwidth of the CUDA card the bench runs on
(:func:`cask_tpu_torch.utils.platform.hbm_bandwidth`); a run on the CPU, or
on a card missing from that table, records no roofline share.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from cask_tpu_torch.formats.matrix import BSR, COO, CSR, host


def chip_bandwidth() -> Optional[float]:
    """The CUDA card's published HBM bandwidth in bytes/s, or None (no CUDA
    device, or a card missing from the table)."""
    if not torch.cuda.is_available():
        return None
    from cask_tpu_torch.utils.platform import hbm_bandwidth

    bw, known = hbm_bandwidth()
    return bw if known else None


@dataclasses.dataclass
class OpTraffic:
    """Minimal device-memory bytes one application of the op must move."""

    bytes_per_op: int
    flops_per_op: int
    nnz: int

    def record(self, seconds: float, *, bandwidth: Optional[float] = None) -> dict:
        """Rates of one op taking ``seconds``; ``roofline_frac`` against
        ``bandwidth`` (bytes/s) where one is given."""
        achieved = self.bytes_per_op / seconds
        rec = {
            "seconds_per_op": seconds,
            "achieved_GBs": round(achieved / 1e9, 3),
            "gnnz_per_s": round(self.nnz / seconds / 1e9, 4),
            "gflops": round(self.flops_per_op / seconds / 1e9, 3),
        }
        if bandwidth:
            rec["roofline_frac"] = round(achieved / bandwidth, 4)
        return rec


def _itemsize(dtype) -> int:
    return dtype.itemsize if isinstance(dtype, torch.dtype) else np.dtype(dtype).itemsize


def spmv_traffic(matrix, variant: str, k: int = 1) -> OpTraffic:
    """Bytes/flops for one SpMV/SpMM on ``matrix`` as the variant stores it:
    a plan's packed values and remainder (``traffic_bytes``: the DIA, BDIA
    and POH plans), a BSR's stored blocks, a CSR's or COO's entries; plus
    X read and Y written once.  Operations: 2 per true entry and column."""
    from cask_tpu_torch.ops.bdia import BdiaMatrix
    from cask_tpu_torch.ops.dia import DiaMatrix
    from cask_tpu_torch.ops.poh import PohMatrix

    if not isinstance(matrix, (PohMatrix, DiaMatrix, BdiaMatrix, BSR, CSR, COO)):
        raise TypeError(f"no traffic model for {type(matrix)}")
    db = _itemsize(matrix.dtype)
    m, n = matrix.shape
    if isinstance(matrix, PohMatrix):  # its traffic_bytes holds x and y once
        true_nnz = int(torch.count_nonzero(matrix.vals))
        bytes_ = matrix.traffic_bytes + (n + m) * db * (k - 1)
        return OpTraffic(bytes_, 2 * true_nnz * k, true_nnz)
    if isinstance(matrix, (DiaMatrix, BdiaMatrix)):
        true_nnz = int(torch.count_nonzero(matrix.vals)) + int(matrix.rem_data.shape[0])
        return OpTraffic(matrix.traffic_bytes + (n + m) * db * k, 2 * true_nnz * k, true_nnz)
    if isinstance(matrix, BSR):
        true_nnz = int(np.count_nonzero(host(matrix.data)))
        bytes_ = matrix.nnz * db + matrix.n_blocks * 4 + (n + m) * db * k
        return OpTraffic(bytes_, 2 * true_nnz * k, true_nnz)
    nnz = matrix.nnz  # CSR, COO
    return OpTraffic(nnz * (db + 4) + (n + m) * db * k, 2 * nnz * k, nnz)
