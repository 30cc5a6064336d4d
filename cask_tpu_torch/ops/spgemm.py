"""SpGEMM:  C = A @ B  for sparse A, B (BASELINE config 4: A·A and A·B on
graph matrices).

The PyTorch counterpart of :mod:`cask_tpu.ops.spgemm`, in the same two
phases:

- **symbolic** (host, structure-only, cacheable): the expansion map (every
  scalar product A[i,k]·B[k,j] gets a slot, slots sorted by their C entry)
  and the output structure, in numpy, equal to the JAX package's; its
  index arrays then go to the device once;
- **numeric** (device): two gathers, one multiply and one sorted segment
  sum (``index_add_``) over those arrays.  With A's values bound
  (:meth:`SpGEMMPlan.bind_poh`) the numeric phase is instead one POH SpMV
  (the ``poh_spmv`` CUDA kernel) over the expansion map as a matrix.

Heavy-tailed products whose expansion would be too large for the device
arrays go to the native core's host Gustavson (:func:`spgemm_native`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from cask_tpu_torch.formats.matrix import CSR, host, to_device
from cask_tpu_torch.native import binding as nat
from cask_tpu_torch.ops.poh import PohMatrix, poh_plan
from cask_tpu_torch.utils.platform import plan_device

_INT = np.int32


@dataclasses.dataclass(frozen=True, eq=False)
class SpGEMMPlan:
    """Host-side symbolic product of two sparsity patterns.

    ``src_a[t]`` / ``src_b[t]`` index the A/B entries whose product feeds
    expansion slot ``t``; ``out_id[t]`` maps the slot to its C entry.  The
    arrays are host numpy (equal to the reference's); their copies on
    ``device`` (the maps as int64 for the gathers and ``index_add_``) are
    made once with the plan.
    """

    shape: Tuple[int, int]
    src_a: np.ndarray  # (E,) int32 into A.data
    src_b: np.ndarray  # (E,) int32 into B.data
    out_id: np.ndarray  # (E,) int32 into C.data, non-decreasing
    c_indices: np.ndarray  # (nnz_C,) int32
    c_indptr: np.ndarray  # (m+1,) int32
    device: torch.device
    dev: dict = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        def put(x, dtype):
            return torch.as_tensor(x.astype(dtype), device=self.device)

        object.__setattr__(self, "dev", {
            "src_a": put(self.src_a, np.int64), "src_b": put(self.src_b, np.int64),
            "out_id": put(self.out_id, np.int64), "c_indices": put(self.c_indices, _INT),
            "c_indptr": put(self.c_indptr, _INT)})

    @property
    def nnz(self) -> int:
        return int(self.c_indices.shape[0])

    @property
    def expansion(self) -> int:
        return int(self.src_a.shape[0])

    def _csr(self, c_data: torch.Tensor) -> CSR:
        return CSR(data=c_data, indices=self.dev["c_indices"], indptr=self.dev["c_indptr"],
                   shape=self.shape)

    def numeric(self, a_data, b_data) -> CSR:
        """Device-side numeric phase: ``C.data`` on the plan's device."""
        a = to_device(a_data, self.device)
        b = to_device(b_data, self.device)
        prod = a[self.dev["src_a"]] * b[self.dev["src_b"]]
        return self._csr(prod.new_zeros(self.nnz).index_add_(0, self.dev["out_id"], prod))

    def bind_poh(self, a_data, *, nnz_b: Optional[int] = None,
                 tile_slots: int = 8192) -> "PohNumeric":
        """Bake A's values into a gather-free numeric phase.

        The expansion map with A's values bound is itself a sparse matrix
        ``M (nnz_C × nnz_B)`` with ``M[out_id[t], src_b[t]] =
        a_data[src_a[t]]``, and the numeric phase is the SpMV ``c_data = M @
        b_data``: one launch of the POH SpMV kernel on the card.  A's values
        are baked at bind time (rebuild the binding when they change); B's
        values stream freely (for A·A pass the same vector)."""
        a_np = host(a_data)
        nb = int(nnz_b if nnz_b is not None else self.src_b.max(initial=-1) + 1)
        counts = np.bincount(self.out_id, minlength=self.nnz)
        indptr = np.zeros(self.nnz + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        m_csr = CSR(data=a_np[self.src_a], indices=self.src_b.astype(np.int32),
                    indptr=indptr.astype(np.int32), shape=(self.nnz, nb))
        return PohNumeric(plan=self,
                          _poh=poh_plan(m_csr, tile_slots=tile_slots, device=self.device))


@dataclasses.dataclass(frozen=True, eq=False)
class PohNumeric:
    """SpGEMM numeric phase with A's values baked into a POH SpMV."""

    plan: SpGEMMPlan
    _poh: PohMatrix

    def to(self, device) -> "PohNumeric":
        """The binding with its pack on ``device`` (the reference's
        ``device_put``); the C structure stays where the plan's is."""
        return dataclasses.replace(self, _poh=self._poh.to(device))

    def __call__(self, b_data, *, precision: str = "split") -> CSR:
        """``C = A @ B`` for B's values ``b_data``: one ``poh_spmv`` launch on
        the card (``C.data`` in the POH kernel's output type, at least f32)."""
        c_data = self._poh.spmv(to_device(b_data, self._poh.device), precision=precision)
        return self.plan._csr(c_data)


def spgemm_plan(a: CSR, b: CSR, *, device=None) -> SpGEMMPlan:
    """Symbolic phase: expansion map + output structure (host, numpy); the
    plan's copies go to ``device`` (default: where ``a``'s tensors are, the
    CUDA device for host numpy arrays)."""
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"dimension mismatch: {a.shape} @ {b.shape}")
    device = plan_device(a.data, device)
    m, p = a.shape[0], b.shape[1]

    a_indptr = host(a.indptr).astype(np.int64)
    a_indices = host(a.indices).astype(np.int64)
    b_indptr = host(b.indptr).astype(np.int64)
    b_indices = host(b.indices).astype(np.int64)

    a_rows = np.repeat(np.arange(m, dtype=np.int64), np.diff(a_indptr))
    # expansion slots: A entry e pairs with the whole B row a_indices[e]
    b_counts = np.diff(b_indptr)
    exp_counts = b_counts[a_indices]  # products per A entry
    E = int(exp_counts.sum())
    if E > np.iinfo(_INT).max:
        raise OverflowError(
            f"SpGEMM expansion ({E:.2e} products) exceeds int32 indexing; "
            "use spgemm(..., backend='native')"
        )
    src_a = np.repeat(np.arange(a_indices.shape[0], dtype=np.int64), exp_counts)
    # src_b: for slot t within A-entry e, b_indptr[a_indices[e]] + local_offset
    slot_start = np.zeros(a_indices.shape[0] + 1, dtype=np.int64)
    np.cumsum(exp_counts, out=slot_start[1:])
    local = np.arange(E, dtype=np.int64) - slot_start[src_a]
    src_b = b_indptr[a_indices[src_a]] + local

    rows = a_rows[src_a]
    cols = b_indices[src_b]
    key = rows * p + cols
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq_mask = np.empty(E, dtype=bool)
    if E:
        uniq_mask[0] = True
        np.not_equal(key_s[1:], key_s[:-1], out=uniq_mask[1:])
        out_of_order = np.cumsum(uniq_mask) - 1  # C id per sorted slot
        out_id = np.empty(E, dtype=np.int64)
        out_id[order] = out_of_order
        uniq_key = key_s[uniq_mask]
    else:
        out_id = np.zeros(0, dtype=np.int64)
        uniq_key = np.zeros(0, dtype=np.int64)

    c_rows = uniq_key // p
    c_indices = (uniq_key % p).astype(_INT)
    c_indptr = np.zeros(m + 1, dtype=np.int64)
    np.add.at(c_indptr, c_rows + 1, 1)
    c_indptr = np.cumsum(c_indptr)

    # slots sorted by output id: the runs per C entry are contiguous (the
    # sorted segment sum, and bind_poh's rows)
    src_a = src_a[order]
    src_b = src_b[order]
    out_id = out_id[order]

    return SpGEMMPlan(shape=(m, p), src_a=src_a.astype(_INT), src_b=src_b.astype(_INT),
                      out_id=out_id.astype(_INT), c_indices=c_indices,
                      c_indptr=c_indptr.astype(_INT), device=device)


def expansion_size(a: CSR, b: CSR) -> int:
    """Scalar products in A·B (= FLOPs/2): the expansion-plan footprint."""
    b_counts = np.diff(host(b.indptr).astype(np.int64))
    return int(b_counts[host(a.indices).astype(np.int64)].sum())


# Above this expansion size the device plan's index arrays get heavy
# (≈12 bytes/slot host + device); Gustavson in the native core wins.
_NATIVE_THRESHOLD = 30_000_000


def spgemm_native(a: CSR, b: CSR) -> CSR:
    """Full host Gustavson SpGEMM via the native core (heavy-tailed graphs
    where the expansion plan blows up).  Returns a host CSR of numpy arrays,
    as the reference does; raises ``NativeUnavailable`` without the core."""
    c_ptr, c_col, c_val = nat.spgemm(
        a.shape[0], a.shape[1], b.shape[1],
        host(a.indptr), host(a.indices), host(a.data),
        host(b.indptr), host(b.indices), host(b.data),
    )
    return CSR(data=c_val.astype(host(a.data).dtype), indices=c_col, indptr=c_ptr,
               shape=(a.shape[0], b.shape[1]))


def spgemm(a: CSR, b: Optional[CSR] = None, *, plan: Optional[SpGEMMPlan] = None,
           backend: str = "auto", device=None) -> CSR:
    """``C = A @ B`` (``B=None`` means ``A @ A``).

    backend:
    - ``'plan'``   — host symbolic + device numeric (structure cached,
      values updatable on the device; the solver-pipeline mode), on
      ``device`` as :func:`spgemm_plan`;
    - ``'native'`` — one-shot host Gustavson in C++ (big irregular graphs;
      a host CSR); raises where the core cannot build;
    - ``'auto'``   — native when the expansion would exceed
      ``_NATIVE_THRESHOLD`` products and the core is available, else plan.
    """
    if b is None:
        b = a
    if not isinstance(a, CSR) or not isinstance(b, CSR):
        raise TypeError("spgemm requires CSR operands (convert first)")
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"dimension mismatch: {a.shape} @ {b.shape}")
    if plan is not None:
        return plan.numeric(a.data, b.data)
    if backend == "native":
        return spgemm_native(a, b)
    if backend == "auto" and expansion_size(a, b) > _NATIVE_THRESHOLD:
        try:
            return spgemm_native(a, b)
        except nat.NativeUnavailable:
            pass  # the plan path below
    return spgemm_plan(a, b, device=device).numeric(a.data, b.data)
