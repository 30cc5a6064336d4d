"""ILU(0): incomplete LU factorization with zero fill-in.

The PyTorch counterpart of :mod:`cask_tpu.ops.ilu`.  Two factorization
paths:

- **Host** (:func:`ilu0`): the exact sequential IKJ row recurrence in the
  port's copy of the native C++ core, or in numpy without it.
- **Device** (:func:`ilu0_device` / :class:`ILU0DevicePlan`): the
  Chow–Patel fine-grained parallel ILU (SISC 2015): the factorization is
  the fixed point of ``F(v)`` where every nonzero updates independently per
  sweep.  A host *symbolic* phase enumerates each nonzero's L·U dependency
  pairs once per pattern (vectorized here; the arrays equal the
  reference's row loop's); the *numeric* sweeps are a gather /
  ``index_add_`` loop on the device, so values re-bind without re-planning.

Either way the preconditioner *apply* (two triangular solves) runs on the
device through cached :class:`~cask_tpu_torch.ops.trisolve.TriSolvePlan`s.
Storage follows the classic convention: one CSR on A's pattern holding
strict-lower = L (unit diagonal implied) and diag+upper = U.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from cask_tpu_torch.formats.convert import coo_from_arrays, coo_to_csr
from cask_tpu_torch.formats.matrix import CSR, host, to_device
from cask_tpu_torch.native import binding as nat
from cask_tpu_torch.ops.trisolve import TriSolvePlan, jacobi_trisolve_plan, trisolve_plan
from cask_tpu_torch.utils.platform import plan_device


def _ilu0_numpy(indptr: np.ndarray, indices: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Reference IKJ ILU(0) on a CSR pattern with sorted column indices."""
    n = indptr.shape[0] - 1
    lu = data.astype(np.float64, copy=True)
    # position of the diagonal entry in each row
    diag_pos = np.full(n, -1, dtype=np.int64)
    for i in range(n):
        s, e = indptr[i], indptr[i + 1]
        cols_i = indices[s:e]
        dp = np.searchsorted(cols_i, i)
        if dp < cols_i.shape[0] and cols_i[dp] == i:
            diag_pos[i] = s + dp
        else:
            raise ValueError(f"ILU(0): missing diagonal in row {i}")

    for i in range(n):
        s, e = indptr[i], indptr[i + 1]
        cols_i = indices[s:e]
        row_i = lu[s:e]
        for t in range(e - s):
            k = cols_i[t]
            if k >= i:
                break
            dk = lu[diag_pos[k]]
            lik = row_i[t] / dk
            row_i[t] = lik
            # subtract lik * U-row(k) restricted to row i's pattern
            ks, ke = diag_pos[k] + 1, indptr[k + 1]
            if ks < ke:
                cols_k = indices[ks:ke]
                # merge: positions of cols_k within cols_i (both sorted)
                pos = np.searchsorted(cols_i, cols_k)
                ok = (pos < cols_i.shape[0])
                ok &= cols_i[np.minimum(pos, cols_i.shape[0] - 1)] == cols_k
                row_i[pos[ok]] -= lik * lu[ks:ke][ok]
        if lu[diag_pos[i]] == 0.0:
            raise ZeroDivisionError(f"ILU(0): zero pivot at row {i}")
    return lu


@dataclasses.dataclass(frozen=True, eq=False)
class ILU0Factors:
    """Combined LU values on A's pattern (host numpy, ``lu``), plus cached
    solve plans and each plan's values on the plans' device."""

    lu: CSR  # values = factorization, pattern = A's
    _lower_plan: TriSolvePlan
    _upper_plan: TriSolvePlan
    _lower_data: torch.Tensor  # values rearranged for each plan's pattern
    _upper_data: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self._lower_plan.device

    def apply(self, b, *, method: str = "levels", sweeps: int = 5) -> torch.Tensor:
        """Preconditioner solve  x = U⁻¹ L⁻¹ b.

        ``method='jacobi'`` replaces each exact triangular solve with
        ``sweeps`` Jacobi–Richardson sweeps (each one SpMV: on a banded
        factor, one DIA kernel launch); 'levels' is the exact wavefront
        solve."""
        if method == "jacobi":
            lp, up = self._jacobi_plans()
            return up.solve(lp.solve(b, sweeps=sweeps), sweeps=sweeps)
        y = self._lower_plan.solve(self._lower_data, b)
        return self._upper_plan.solve(self._upper_data, y)

    def jacobi_applier(self, sweeps: int = 5):
        """An ``r → M⁻¹r`` callable using sweep solves: pass as ``M=`` to the
        Krylov solvers."""
        lp, up = self._jacobi_plans()
        return lambda r: up.solve(lp.solve(r, sweeps=sweeps), sweeps=sweeps)

    def _jacobi_plans(self):
        cached = getattr(self, "_jacobi_cache", None)
        if cached is None:
            low, up = self.split()
            cached = (jacobi_trisolve_plan(low, lower=True, unit_diag=True, device=self.device),
                      jacobi_trisolve_plan(up, lower=False, unit_diag=False,
                                           device=self.device))
            object.__setattr__(self, "_jacobi_cache", cached)
        return cached

    def split(self):
        """Return (L with unit diag, U) as separate host CSRs."""
        return _split_lu(self.lu)


def _split_lu(lu: CSR):
    indptr = host(lu.indptr).astype(np.int64)
    indices = host(lu.indices).astype(np.int64)
    data = host(lu.data)
    n = lu.shape[0]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))

    def build(mask, extra_diag):
        r = rows[mask]
        c = indices[mask]
        d = data[mask]
        if extra_diag:
            r = np.concatenate([r, np.arange(n, dtype=np.int64)])
            c = np.concatenate([c, np.arange(n, dtype=np.int64)])
            d = np.concatenate([d, np.ones(n, dtype=data.dtype)])
        return coo_to_csr(coo_from_arrays(d, r, c, lu.shape), sum_duplicates=False)

    low = build(indices < rows, extra_diag=True)
    up = build(indices >= rows, extra_diag=False)
    return low, up


def _diag_positions(indptr: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Position of each row's diagonal entry (column indices sorted within
    rows): one search over the (row, column) keys, where the reference
    searches row by row, with the same result."""
    n = indptr.shape[0] - 1
    span = max(n, int(indices.max(initial=-1)) + 1)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    key = rows * span + indices
    diag = np.arange(n, dtype=np.int64)
    pos = np.searchsorted(key, diag * span + diag)
    found = pos < indptr[1:]
    found[found] = indices[pos[found]] == diag[found]
    if not found.all():
        raise ValueError(f"ILU(0): missing diagonal in row {int(np.argmin(found))}")
    return pos


def _dependency_pairs(indptr: np.ndarray, indices: np.ndarray, shape):
    """Chow–Patel pairs ``(pair_out, pair_l, pair_u)``: the target entry
    (i, j) at position p needs l_ik · u_kj for each k in row i's columns
    below min(i, j) with (k, j) in the pattern.  Vectorized over all rows;
    the pairs come in the reference's row-loop order (rows, then targets,
    then k)."""
    import scipy.sparse as sp

    n = indptr.shape[0] - 1
    nnz = indices.shape[0]
    span = max(n, int(indices.max(initial=-1)) + 1)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    key = rows * span + indices
    # candidates of entry p: its row's first tt[p] entries (columns < min(i, j))
    tt = np.searchsorted(key, rows * span + np.minimum(indices, rows)) - indptr[rows]
    tot = int(tt.sum())
    if tot == 0:
        return (np.zeros(0, np.int32),) * 3
    p_c = np.repeat(np.arange(nnz, dtype=np.int64), tt)
    q = np.arange(tot, dtype=np.int64) - np.repeat(np.cumsum(tt) - tt, tt)
    l_c = np.repeat(indptr[rows], tt) + q
    k_c = indices[l_c]
    j_c = indices[p_c]
    # (k, j) ∈ pattern lookup via a position matrix, as the reference looks up
    P = sp.csr_matrix((np.arange(1, nnz + 1, dtype=np.int64), indices, indptr), shape=shape)
    upos = np.asarray(P[k_c, j_c]).ravel()
    keep = upos > 0
    return (p_c[keep].astype(np.int32), l_c[keep].astype(np.int32),
            (upos[keep] - 1).astype(np.int32))


@dataclasses.dataclass(frozen=True, eq=False)
class ILU0DevicePlan:
    """Chow–Patel symbolic plan: per-nonzero L·U dependency pairs, as
    tensors on one device (the index arrays int32, as the reference's, with
    int64 copies made once for the gathers and ``index_add_``).

    Convergence domain: the fixed-point iteration contracts for the
    diagonally-dominant / M-matrix class typical of PDE discretizations;
    for wildly indefinite values it can diverge: check :meth:`residual` and
    fall back to the host :func:`ilu0`."""

    a_vals: torch.Tensor  # (nnz,) A's values (re-bindable)
    pair_out: torch.Tensor  # (npairs,) int32 target nnz, sorted
    pair_l: torch.Tensor  # (npairs,) int32 position of l_ik
    pair_u: torch.Tensor  # (npairs,) int32 position of u_kj
    diag_of_col: torch.Tensor  # (nnz,) int32 diag position of each entry's column
    is_lower: torch.Tensor  # (nnz,) bool
    low_src: torch.Tensor  # (nnz_low,) int32 into vals; -1 → unit diagonal 1.0
    up_src: torch.Tensor  # (nnz_up,) int32 into vals
    lower_plan: TriSolvePlan
    upper_plan: TriSolvePlan
    idx: dict = dataclasses.field(init=False, repr=False)  # int64 copies of the index arrays

    def __post_init__(self):
        object.__setattr__(self, "idx", {
            name: getattr(self, name).long()
            for name in ("pair_out", "pair_l", "pair_u", "diag_of_col", "up_src")})
        self.idx["low_src"] = self.low_src.long().clamp(min=0)

    @property
    def nnz(self) -> int:
        return int(self.a_vals.shape[0])

    @property
    def device(self) -> torch.device:
        return self.a_vals.device

    def _sweep(self, a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """``F(v)``: one fixed-point sweep."""
        prod = v[self.idx["pair_l"]] * v[self.idx["pair_u"]]
        corr = prod.new_zeros(self.nnz).index_add_(0, self.idx["pair_out"], prod)
        new = a - corr
        return torch.where(self.is_lower, new / v[self.idx["diag_of_col"]], new)

    def factorize(self, a_vals=None, *, sweeps: int = 5) -> torch.Tensor:
        """Fixed-point sweeps → combined LU values on A's pattern."""
        a = self.a_vals if a_vals is None else to_device(a_vals, self.device)
        v = torch.where(self.is_lower, a / a[self.idx["diag_of_col"]], a)
        for _ in range(sweeps):
            v = self._sweep(a, v)
        return v

    def residual(self, vals: torch.Tensor) -> torch.Tensor:
        """‖vals − F(vals)‖∞ / ‖A‖∞ (a 0-d tensor): fixed-point convergence check."""
        f = self._sweep(self.a_vals, vals)
        return (f - vals).abs().max() / self.a_vals.abs().max()

    def apply(self, vals: torch.Tensor, b) -> torch.Tensor:
        """Preconditioner solve ``x = U⁻¹ L⁻¹ b`` from factorized vals."""
        low_data = torch.where(self.low_src < 0, torch.ones((), dtype=vals.dtype,
                                                            device=vals.device),
                               vals[self.idx["low_src"]])
        up_data = vals[self.idx["up_src"]]
        y = self.lower_plan.solve(low_data, b)
        return self.upper_plan.solve(up_data, y)


def ilu0_device_plan(a: CSR, *, device=None) -> ILU0DevicePlan:
    """Symbolic Chow–Patel plan for A's pattern (host, once per pattern); its
    tensors go to ``device`` (default: where ``a``'s tensors are, the CUDA
    device for host numpy arrays)."""
    device = plan_device(a.data, device)
    indptr = host(a.indptr).astype(np.int64)
    indices = host(a.indices).astype(np.int64)
    data = host(a.data)
    n = a.shape[0]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    diag_pos = _diag_positions(indptr, indices)
    pair_out, pair_l, pair_u = _dependency_pairs(indptr, indices, a.shape)

    # triangular split patterns + value-assembly permutations
    lu_pattern = CSR(data=data, indices=indices.astype(np.int32),
                     indptr=indptr.astype(np.int32), shape=a.shape)
    low, up = _split_lu(lu_pattern)
    lower_mask = indices < rows
    up_src = np.nonzero(~lower_mask)[0].astype(np.int32)
    low_positions = np.nonzero(lower_mask)[0]
    low_rows = rows[lower_mask]
    cnt = np.zeros(n, np.int64)
    np.add.at(cnt, low_rows, 1)
    # ordinal within row (rows are sorted runs)
    starts = np.cumsum(cnt) - cnt
    ordinal = np.arange(low_positions.shape[0]) - starts[low_rows]
    low_indptr = host(low.indptr).astype(np.int64)
    low_src = np.full(low.nnz, -1, dtype=np.int32)
    low_src[low_indptr[low_rows] + ordinal] = low_positions.astype(np.int32)

    def put(x):
        return torch.as_tensor(x, device=device)

    return ILU0DevicePlan(
        a_vals=to_device(data, device), pair_out=put(pair_out), pair_l=put(pair_l),
        pair_u=put(pair_u), diag_of_col=put(diag_pos[indices].astype(np.int32)),
        is_lower=put(lower_mask), low_src=put(low_src), up_src=put(up_src),
        lower_plan=trisolve_plan(low, lower=True, unit_diag=True, device=device),
        upper_plan=trisolve_plan(up, lower=False, unit_diag=False, device=device))


@dataclasses.dataclass(frozen=True, eq=False)
class ILU0DeviceFactors:
    """Factorized values bound to their plan: a drop-in ``.apply`` like
    :class:`ILU0Factors`, but factorized on the device."""

    plan: ILU0DevicePlan
    vals: torch.Tensor

    def apply(self, b) -> torch.Tensor:
        return self.plan.apply(self.vals, b)


def ilu0_device(a: CSR, *, sweeps: int = 5, device=None) -> ILU0DeviceFactors:
    """Chow–Patel parallel ILU(0) on the device (plan + factorize)."""
    plan = ilu0_device_plan(a, device=device)
    return ILU0DeviceFactors(plan=plan, vals=plan.factorize(sweeps=sweeps))


def ilu0_lu(a: CSR, *, use_native: Optional[bool] = None) -> CSR:
    """The combined LU values on A's pattern, as a host CSR: the host
    factorization of :func:`ilu0` without its solve plans (``use_native``
    as there)."""
    if not isinstance(a, CSR):
        raise TypeError("ilu0 requires a CSR matrix")
    indptr = host(a.indptr).astype(np.int64)
    indices = host(a.indices).astype(np.int64)
    data = host(a.data)

    lu_vals = None
    if use_native is not False:
        try:
            lu_vals = nat.ilu0(indptr, indices, data)
        except (nat.NativeUnavailable, ZeroDivisionError):
            if use_native:
                raise
    if lu_vals is None:
        lu_vals = _ilu0_numpy(indptr, indices, data)
    return CSR(data=lu_vals.astype(data.dtype), indices=indices.astype(np.int32),
               indptr=indptr.astype(np.int32), shape=a.shape)


def ilu0(a: CSR, *, use_native: Optional[bool] = None, device=None) -> ILU0Factors:
    """Factor ``A ≈ L U`` on A's own sparsity pattern, on the host: the native
    core (``use_native=True`` raises where it cannot build; ``None`` takes
    numpy then, and on a pivot the core refuses, so that numpy names the
    fault), or numpy (``False``).  The solve plans and the factors' values go
    to ``device`` (default: where ``a``'s tensors are, the CUDA device for
    host numpy arrays)."""
    if not isinstance(a, CSR):
        raise TypeError("ilu0 requires a CSR matrix")
    device = plan_device(a.data, device)
    return ilu0_factors(ilu0_lu(a, use_native=use_native), device=device)


def ilu0_factors(lu: CSR, *, device) -> ILU0Factors:
    """:class:`ILU0Factors` of combined LU values on A's pattern (a host CSR):
    the two triangles' solve plans and values on ``device``."""
    low, up = _split_lu(lu)
    return ILU0Factors(
        lu=lu,
        _lower_plan=trisolve_plan(low, lower=True, unit_diag=True, device=device),
        _upper_plan=trisolve_plan(up, lower=False, unit_diag=False, device=device),
        _lower_data=to_device(low.data, device),
        _upper_data=to_device(up.data, device),
    )
