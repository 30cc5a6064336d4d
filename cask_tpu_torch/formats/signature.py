"""Sparsity signatures: the autotuner's cache key.

The PyTorch counterpart of :mod:`cask_tpu.formats.signature`, numpy only.
The key is a structural fingerprint, so that tuned parameters carry over
between matrices with the same sparsity shape (every timestep of a
simulation, resized instances of one stencil family).  A matrix gives the
same :class:`Signature`, ``key()`` and ``class_key()`` as in the JAX
package, so one cache file serves both.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Tuple

import numpy as np
import torch

from cask_tpu_torch.formats.matrix import BSR, COO, CSR, host


@dataclasses.dataclass(frozen=True)
class Signature:
    shape: Tuple[int, int]
    nnz: int
    dtype: str
    # distribution of nnz/row, quantized: robust to permutations of rows
    row_nnz_quantiles: Tuple[int, ...]  # [min, p25, p50, p75, p90, p99, max]
    mean_bandwidth_log2: int  # log2 of mean |i - j| over entries
    # percent fill of the occupied b×b blocks, for each b in BLOCK_PROBE:
    # "blockiness", i.e. whether BSR pays
    block_fill: Tuple[int, ...]

    BLOCK_PROBE = (4, 8, 16, 32)

    def key(self) -> str:
        payload = json.dumps(dataclasses.asdict(self), sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()[:16]

    def class_key(self) -> str:
        """Coarser key ignoring exact shape/nnz: matches the matrix
        *family* (same structure at a different size)."""
        d = dataclasses.asdict(self)
        m, n = d.pop("shape")
        nnz = d.pop("nnz")
        d["aspect_log2"] = int(np.round(np.log2(max(m, 1) / max(n, 1)))) if n else 0
        d["nnz_per_row_log2"] = int(np.round(np.log2(max(nnz / max(m, 1), 1e-9))))
        # size-relative bandwidth exponent α where bw ≈ n^α (stencils keep
        # α≈0.5 across sizes, dense bands α≈1, diagonals α≈0)
        bwl2 = d.pop("mean_bandwidth_log2")
        d["bandwidth_alpha_x2"] = int(np.round(2.0 * bwl2 / max(np.log2(n + 2.0), 1.0)))
        # quantize fill to 20%-buckets and quantiles relative to median
        d["block_fill"] = [int(f // 20) for f in d["block_fill"]]
        qs = d.pop("row_nnz_quantiles")
        med = max(qs[3], 1)
        d["rel_quantiles"] = [int(np.round(4.0 * q / med)) for q in qs]
        payload = json.dumps(d, sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()[:16]


def dtype_name(dtype) -> str:
    """numpy's name of a numpy or torch dtype ("float32", "bfloat16")."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(np.dtype(dtype))


def _drop_repeats(key: np.ndarray) -> np.ndarray:
    """``key`` without the entries equal to the one before them."""
    return key[np.concatenate(([True], key[1:] != key[:-1]))] if key.size else key


def _unique(key: np.ndarray) -> np.ndarray:
    """``np.unique(key)`` by a sort: numpy 2.3's ``np.unique`` hashes, which
    is over a hundred times slower than the sort on tens of millions of
    random int64 keys."""
    return _drop_repeats(np.sort(key))


def occupied_blocks(rows: np.ndarray, cols: np.ndarray, n: int, sizes) -> list:
    """The number of distinct ``(row // b, col // b)`` blocks for each b in
    ``sizes``, each a multiple of the one before it.  One sort over the
    entries, after dropping runs of one block (a CSR row's sorted columns),
    for the first size; the larger ones coarsen the blocks found, since
    ``i // (b·f) == (i // b) // f``."""
    b0 = sizes[0]
    nbc = -(-n // b0)
    key = _unique(_drop_repeats((rows // b0) * nbc + cols // b0))
    out = [int(key.size)]
    br, bc = key // nbc, key % nbc
    for prev, b in zip(sizes, sizes[1:]):
        f = b // prev
        nbc = -(-n // b)
        br, bc = br // f, bc // f
        key = _unique(br * nbc + bc)
        br, bc = key // nbc, key % nbc
        out.append(int(key.size))
    return out


def signature(a) -> Signature:
    if isinstance(a, BSR):
        from cask_tpu_torch.formats.convert import bsr_to_csr

        a = bsr_to_csr(a)
    if isinstance(a, COO):
        from cask_tpu_torch.formats.convert import coo_to_csr

        a = coo_to_csr(a)
    if not isinstance(a, CSR):
        raise TypeError(f"cannot fingerprint {type(a)}")

    indptr = host(a.indptr).astype(np.int64)
    indices = host(a.indices).astype(np.int64)
    m, n = a.shape
    lens = np.diff(indptr)
    if m and a.nnz:
        qs = np.quantile(lens, [0.0, 0.25, 0.5, 0.75, 0.9, 0.99, 1.0])
        rows = np.repeat(np.arange(m, dtype=np.int64), lens)
        bw = float(np.mean(np.abs(rows - indices))) if indices.size else 0.0
        block_fill = []
        for b, occupied in zip(Signature.BLOCK_PROBE,
                               occupied_blocks(rows, indices, n, Signature.BLOCK_PROBE)):
            fill = indices.size / max(occupied * b * b, 1)
            block_fill.append(int(round(100 * min(fill, 1.0))))
    else:
        qs = np.zeros(7)
        bw = 0.0
        block_fill = [0] * len(Signature.BLOCK_PROBE)

    return Signature(
        shape=(int(m), int(n)),
        nnz=int(a.nnz),
        dtype=dtype_name(a.dtype),
        row_nnz_quantiles=tuple(int(q) for q in qs),
        mean_bandwidth_log2=int(np.round(np.log2(bw + 1.0))),
        block_fill=tuple(block_fill),
    )
