"""Sparse + sparse addition and diagonal shifts.

The PyTorch counterpart of :mod:`cask_tpu.ops.add`.  Same architecture as
SpGEMM (host symbolic / device numeric): the union structure of two
patterns is computed once on the host, equal to the JAX package's; the
value combination ``α·a + β·b`` is an ``index_add_`` of each side into the
union's slots on the device, so shifted operators (A − σI) and operator
sums rebuild values without re-planning.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from cask_tpu_torch.formats.convert import coo_from_arrays, coo_to_csr
from cask_tpu_torch.formats.matrix import CSR, host, to_device
from cask_tpu_torch.utils.platform import plan_device

_INT = np.int32


@dataclasses.dataclass(frozen=True, eq=False)
class AddPlan:
    """Union structure of two CSR patterns with source maps (host numpy,
    equal to the reference's), and their copies on ``device`` (the maps as
    int64 for ``index_add_``), made once with the plan."""

    shape: Tuple[int, int]
    c_indices: np.ndarray  # (nnz_C,) int32
    c_indptr: np.ndarray  # (m+1,) int32
    a_dst: np.ndarray  # (nnz_A,) int32 → C slot of each A entry
    b_dst: np.ndarray  # (nnz_B,) int32 → C slot of each B entry
    device: torch.device
    dev: dict = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "dev", {
            "c_indices": torch.as_tensor(self.c_indices, device=self.device),
            "c_indptr": torch.as_tensor(self.c_indptr, device=self.device),
            "a_dst": torch.as_tensor(self.a_dst.astype(np.int64), device=self.device),
            "b_dst": torch.as_tensor(self.b_dst.astype(np.int64), device=self.device)})

    @property
    def nnz(self) -> int:
        return int(self.c_indices.shape[0])

    def numeric(self, a_data, b_data, *, alpha=1.0, beta=1.0) -> CSR:
        """``α·a + β·b`` on the union pattern, as a CSR of tensors on the
        plan's device, in the promotion of the two value types."""
        a = to_device(a_data, self.device)
        b = to_device(b_data, self.device)
        dt = torch.promote_types(a.dtype, b.dtype)
        c = torch.zeros(self.nnz, dtype=dt, device=self.device)
        c.index_add_(0, self.dev["a_dst"], (alpha * a).to(dt))
        c.index_add_(0, self.dev["b_dst"], (beta * b).to(dt))
        return CSR(data=c, indices=self.dev["c_indices"], indptr=self.dev["c_indptr"],
                   shape=self.shape)


def add_plan(a: CSR, b: CSR, *, device=None) -> AddPlan:
    """The union structure of ``a`` and ``b`` (host numpy); the plan's copies
    go to ``device`` (default: where ``a``'s tensors are, the CUDA device for
    host numpy arrays)."""
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    device = plan_device(a.data, device)
    m, n = a.shape

    def expand(x):
        ip = host(x.indptr).astype(np.int64)
        rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(ip))
        return rows * n + host(x.indices).astype(np.int64)

    ka = expand(a)
    kb = expand(b)
    keys = np.concatenate([ka, kb])
    uniq, inv = np.unique(keys, return_inverse=True)
    a_dst = inv[: ka.shape[0]]
    b_dst = inv[ka.shape[0]:]
    c_rows = uniq // n
    c_indptr = np.zeros(m + 1, dtype=np.int64)
    np.add.at(c_indptr, c_rows + 1, 1)
    return AddPlan(shape=(m, n), c_indices=(uniq % n).astype(_INT),
                   c_indptr=np.cumsum(c_indptr).astype(_INT), a_dst=a_dst.astype(_INT),
                   b_dst=b_dst.astype(_INT), device=device)


def sp_add(a: CSR, b: CSR, *, alpha=1.0, beta=1.0, plan: Optional[AddPlan] = None,
           device=None) -> CSR:
    """``C = α·A + β·B`` on the union pattern (a new plan on ``device``, as
    :func:`add_plan`)."""
    if plan is None:
        plan = add_plan(a, b, device=device)
    return plan.numeric(a.data, b.data, alpha=alpha, beta=beta)


def shift_identity(a: CSR, sigma, *, device=None) -> CSR:
    """``A + σ·I`` (host structure extension, values on ``device``)."""
    n = min(a.shape)
    eye = coo_to_csr(coo_from_arrays(
        np.ones(n, dtype=host(a.data).dtype),
        np.arange(n, dtype=np.int64), np.arange(n, dtype=np.int64), a.shape,
    ))
    return sp_add(a, eye, alpha=1.0, beta=sigma, device=device)
