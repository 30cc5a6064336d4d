"""Sparse triangular solve  L x = b  /  U x = b.

The PyTorch counterpart of :mod:`cask_tpu.ops.trisolve`.  Two methods:

- **Level scheduling** (:class:`TriSolvePlan`): rows are grouped into
  levels such that every row's dependencies live in earlier levels.  The
  level analysis runs on the host once per pattern (the native core's
  sweep, or a numpy frontier without it) and packs padded per-level index
  arrays equal to the JAX package's.  The device then runs a Python loop
  over levels, each step a batched gather / ``index_add_`` / divide over a
  padded level's worth of rows (the reference runs one ``lax.scan``).
  Rows and columns are padded with index ``n`` into an (n+1)-slot solution
  whose last slot stays 0, so the loop needs no masks.  The loop never
  reads a value back to the host.
- **Jacobi–Richardson sweeps** (:class:`JacobiTriSolvePlan`): split
  ``A = D + N`` and iterate ``x ← D⁻¹(b − N x)``; each sweep is one SpMV
  (the DIA kernel when the strict triangle is banded).  ``N D⁻¹`` is
  nilpotent, so ``n`` sweeps are exact, and a diagonally dominant factor
  is preconditioner-accurate in a few.

Plans built from host numpy arrays live on the CUDA device unless given
``device=`` (a CPU tensor asks for the CPU, as the tests do).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from cask_tpu_torch.formats.convert import coo_from_arrays, coo_to_csr
from cask_tpu_torch.formats.matrix import CSR, host, to_device
from cask_tpu_torch.native import binding as nat
from cask_tpu_torch.ops.dia import DiaMatrix, dia_plan, estimate_dia_traffic
from cask_tpu_torch.ops.spmm import spmm
from cask_tpu_torch.ops.spmv import spmv
from cask_tpu_torch.utils.platform import plan_device

_INT = np.int32


def _split_triangle(a: CSR, lower: bool):
    """Host split of CSR into (strict off-diag entries, diag values)."""
    indptr = host(a.indptr).astype(np.int64)
    indices = host(a.indices).astype(np.int64)
    n = a.shape[0]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    on_diag = rows == indices
    strict = (indices < rows) if lower else (indices > rows)
    wrong_side = ~(on_diag | strict)
    if np.any(wrong_side):
        raise ValueError(
            "matrix has entries on the wrong side of the diagonal for "
            f"{'lower' if lower else 'upper'} trisolve"
        )
    diag_val_idx = np.full(n, -1, dtype=np.int64)
    diag_val_idx[rows[on_diag]] = np.nonzero(on_diag)[0]
    return rows, indices, strict, diag_val_idx


def compute_levels(rows: np.ndarray, cols: np.ndarray, n: int, lower: bool) -> np.ndarray:
    """Level of each row (0-based): the native core's sequential sweep, else
    a vectorized numpy frontier propagation (O(nnz) total work)."""
    try:
        # the native sweep processes rows in ascending order, which is a
        # topological order only for lower patterns: reflect upper ones
        r = rows if lower else (n - 1 - rows)
        c = cols if lower else (n - 1 - cols)
        order = np.argsort(r, kind="stable")
        sptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(sptr, r + 1, 1)
        sptr = np.cumsum(sptr)
        lv, _ = nat.levels_lower(n, sptr, c[order])
        lv = lv.astype(np.int64)
        # undo the reflection: original row i lives at reflected slot n-1-i
        return lv if lower else np.ascontiguousarray(lv[::-1])
    except nat.NativeUnavailable:
        pass
    # dependency edges: row r depends on row c (strict triangle entries)
    dep_counts = np.zeros(n, dtype=np.int64)
    np.add.at(dep_counts, rows, 1)
    # group edges by their *column* (CSC-ish) to find dependents of a row
    order = np.argsort(cols, kind="stable")
    e_rows = rows[order]
    e_cols = cols[order]
    col_ptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(col_ptr, e_cols + 1, 1)
    col_ptr = np.cumsum(col_ptr)

    level = np.full(n, -1, dtype=np.int64)
    frontier = np.nonzero(dep_counts == 0)[0]
    lvl = 0
    while frontier.size:
        level[frontier] = lvl
        # all edges whose source column is in the frontier
        starts = col_ptr[frontier]
        ends = col_ptr[frontier + 1]
        lens = ends - starts
        tot = int(lens.sum())
        if tot:
            base = np.repeat(starts, lens)
            offs = np.arange(tot, dtype=np.int64) - np.repeat(np.cumsum(lens) - lens, lens)
            touched = e_rows[base + offs]
            np.add.at(dep_counts, touched, -1)
            dep_counts[frontier] = -1  # retired
            frontier = np.unique(touched[dep_counts[touched] == 0])
        else:
            dep_counts[frontier] = -1
            frontier = np.zeros(0, dtype=np.int64)
        lvl += 1
    if np.any(level < 0):
        raise ValueError("dependency cycle — not a permuted triangular matrix?")
    return level


def _operand(b, device: torch.device) -> torch.Tensor:
    """``b`` as a tensor: a tensor stays where it is, host data goes to
    ``device``."""
    return b if isinstance(b, torch.Tensor) else torch.as_tensor(np.asarray(b), device=device)


@dataclasses.dataclass(frozen=True, eq=False)
class TriSolvePlan:
    """Level schedule + padded index arrays for one triangular pattern.

    The ``lvl_*`` arrays are host numpy, equal to the reference's; int64
    copies of them live on ``device``, made once with the plan, for the
    level loop's ``index_select`` / ``index_add_`` / ``index_copy_``."""

    n: int
    lower: bool
    unit_diag: bool
    nlevels: int
    max_rows: int  # rows per level, padded
    max_ents: int  # strict entries per level, padded
    lvl_rows: np.ndarray  # (nlevels, max_rows) int32, pad = n
    lvl_diag_idx: np.ndarray  # (nlevels, max_rows) int32 into data, pad = 0
    lvl_ent_local: np.ndarray  # (nlevels, max_ents) int32 into [0, max_rows), pad→max_rows
    lvl_ent_col: np.ndarray  # (nlevels, max_ents) int32, pad = n
    lvl_ent_idx: np.ndarray  # (nlevels, max_ents) int32 into data, pad = 0
    lvl_ent_valid: np.ndarray  # (nlevels, max_ents) bool
    device: torch.device
    dev: dict = dataclasses.field(init=False, repr=False)  # the arrays above on ``device``

    def __post_init__(self):
        def put(x):
            return torch.as_tensor(x.astype(np.int64) if x.dtype != bool else x,
                                   device=self.device)

        object.__setattr__(self, "dev", {
            "rows": put(self.lvl_rows), "diag": put(self.lvl_diag_idx),
            "ent_local": put(self.lvl_ent_local), "ent_col": put(self.lvl_ent_col),
            "ent_idx": put(self.lvl_ent_idx), "ent_valid": put(self.lvl_ent_valid)})

    def solve(self, data, b) -> torch.Tensor:
        """The solve given the pattern's value array ``data``.  ``b`` may be
        (n,) or (n, k): the level sweep is batched over the trailing axis
        at no extra scheduling cost."""
        b = _operand(b, self.device)
        return tri_solve_arrays(to_device(data, b.device), b, self.dev["rows"],
                                self.dev["diag"], self.dev["ent_local"],
                                self.dev["ent_col"], self.dev["ent_idx"],
                                self.dev["ent_valid"], n=self.n, max_rows=self.max_rows,
                                unit_diag=self.unit_diag)


def _level_sweep(data, b, lvl_rows, lvl_diag, ent_local, ent_col, ent_idx, ent_valid, *,
                 n: int, max_rows: int, unit_diag: bool) -> torch.Tensor:
    """The level loop; returns the whole (n+1, k) solution, pad slot ``n``
    included (it stays 0: every pad row's right-hand side and sum are 0)."""
    vec = b.ndim == 1
    b2 = b[:, None] if vec else b
    k = b2.shape[1]
    xe = b2.new_zeros((n + 1, k))
    be = torch.cat([b2, b2.new_zeros((1, k))])
    lvl_rows, lvl_diag = lvl_rows.long(), lvl_diag.long()
    ent_local, ent_col, ent_idx = ent_local.long(), ent_col.long(), ent_idx.long()
    # every level's entry values and pivots at once (the reference's scan body
    # gathers its level's): one gather each, before the loop
    vals = torch.where(ent_valid, data[ent_idx], 0).to(b.dtype)
    if not unit_diag:
        piv = torch.where(lvl_rows < n, data[lvl_diag], 1).to(b.dtype)
    for lv in range(lvl_rows.shape[0]):
        rows = lvl_rows[lv]
        prod = vals[lv, :, None] * xe.index_select(0, ent_col[lv])
        contrib = prod.new_zeros((max_rows + 1, k)).index_add_(0, ent_local[lv], prod)
        rhs = be.index_select(0, rows) - contrib[:max_rows]
        xe.index_copy_(0, rows, rhs if unit_diag else rhs / piv[lv, :, None])
    return xe


def tri_solve_arrays(data, b, lvl_rows, lvl_diag, ent_local, ent_col, ent_idx, ent_valid,
                     *, n: int, max_rows: int, unit_diag: bool) -> torch.Tensor:
    """The level sweep on raw plan arrays (tensors on ``b``'s device).

    Factored out of :meth:`TriSolvePlan.solve` so stacked per-shard plans
    (distributed block-ILU) can run the identical program."""
    xe = _level_sweep(data, b, lvl_rows, lvl_diag, ent_local, ent_col, ent_idx, ent_valid,
                      n=n, max_rows=max_rows, unit_diag=unit_diag)
    out = xe[:n]
    return out[:, 0] if b.ndim == 1 else out


def trisolve_plan(a: CSR, *, lower: bool = True, unit_diag: bool = False,
                  device=None) -> TriSolvePlan:
    """Host level analysis and packing, exactly as the JAX package packs; the
    plan's index copies go to ``device`` (default: where ``a``'s tensors
    are, the CUDA device for host numpy arrays)."""
    device = plan_device(a.data, device)
    n = a.shape[0]
    if a.shape[0] != a.shape[1]:
        raise ValueError("triangular solve needs a square matrix")
    rows, cols, strict, diag_idx = _split_triangle(a, lower)
    if not unit_diag and np.any(diag_idx < 0):
        raise ValueError("zero diagonal entry (missing from pattern)")
    s_rows = rows[strict]
    s_cols = cols[strict]
    s_idx = np.nonzero(strict)[0]
    level = compute_levels(s_rows, s_cols, n, lower)

    nlevels = int(level.max()) + 1 if n else 0
    order = np.argsort(level, kind="stable")
    lvl_sizes = np.bincount(level, minlength=nlevels)
    max_rows = int(lvl_sizes.max()) if nlevels else 0

    lvl_rows = np.full((nlevels, max_rows), n, dtype=_INT)
    lvl_diag = np.zeros((nlevels, max_rows), dtype=_INT)
    pos_in_level = np.zeros(n, dtype=np.int64)
    # position of each row inside its level
    start = np.zeros(nlevels + 1, dtype=np.int64)
    np.cumsum(lvl_sizes, out=start[1:])
    pos_in_level[order] = np.arange(n) - start[level[order]]
    lvl_rows[level, pos_in_level] = np.arange(n, dtype=_INT)
    if not unit_diag:
        lvl_diag[level, pos_in_level] = diag_idx.astype(_INT)

    e_level = level[s_rows]
    ents_per_level = (np.bincount(e_level, minlength=nlevels) if s_rows.size
                      else np.zeros(nlevels, np.int64))
    max_ents = int(ents_per_level.max()) if nlevels and ents_per_level.size else 0
    max_ents = max(max_ents, 1)

    lvl_ent_local = np.full((nlevels, max_ents), max_rows, dtype=_INT)
    lvl_ent_col = np.full((nlevels, max_ents), n, dtype=_INT)
    lvl_ent_idx = np.zeros((nlevels, max_ents), dtype=_INT)
    lvl_ent_valid = np.zeros((nlevels, max_ents), dtype=bool)
    if s_rows.size:
        e_order = np.argsort(e_level, kind="stable")
        e_start = np.zeros(nlevels + 1, dtype=np.int64)
        np.cumsum(ents_per_level, out=e_start[1:])
        e_pos = np.arange(s_rows.size) - e_start[e_level[e_order]]
        el = e_level[e_order]
        lvl_ent_local[el, e_pos] = pos_in_level[s_rows[e_order]].astype(_INT)
        lvl_ent_col[el, e_pos] = s_cols[e_order].astype(_INT)
        lvl_ent_idx[el, e_pos] = s_idx[e_order].astype(_INT)
        lvl_ent_valid[el, e_pos] = True

    return TriSolvePlan(n=n, lower=lower, unit_diag=unit_diag, nlevels=nlevels,
                        max_rows=max_rows, max_ents=max_ents, lvl_rows=lvl_rows,
                        lvl_diag_idx=lvl_diag, lvl_ent_local=lvl_ent_local,
                        lvl_ent_col=lvl_ent_col, lvl_ent_idx=lvl_ent_idx,
                        lvl_ent_valid=lvl_ent_valid, device=device)


# ---------------------------------------------------------------------------
# Iterative (Jacobi–Richardson) triangular solve: each sweep is ONE
# SpMV-class parallel op (the DIA kernel when the triangle is banded), no
# levels.  The iteration matrix D⁻¹N is strictly triangular, hence
# nilpotent: exact after n sweeps, and accurate to preconditioner quality
# in ~3-10 sweeps on the diagonally dominant factors of PDE matrices.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class JacobiTriSolvePlan:
    """Strict-triangle operator + inverse diagonal for sweep solves.

    ``strict`` is the planned N (a DIA plan when the triangle is banded,
    whose products run the DIA kernels, else a CSR of tensors riding the
    gather formulation); values are baked in at plan time (re-plan to
    re-bind)."""

    n: int
    lower: bool
    unit_diag: bool
    strict: Union[DiaMatrix, CSR]  # N = A - D, on ``device``
    dinv: Optional[torch.Tensor]  # None for unit_diag
    device: torch.device

    def solve(self, b, *, sweeps: int = 5) -> torch.Tensor:
        """``sweeps`` Jacobi–Richardson iterations toward ``A x = b``;
        ``b`` may be (n,) or (n, k).  Each sweep is one ``spmv`` (an
        ``spmm`` for a block)."""
        b = _operand(b, self.device)
        product = spmv if b.ndim == 1 else spmm
        if self.unit_diag:
            def scale(v):
                return v
        elif b.ndim == 1:
            def scale(v):
                return v * self.dinv
        else:
            def scale(v):
                return v * self.dinv[:, None]
        x = scale(b)
        for _ in range(sweeps):
            x = scale(b - product(self.strict, x))
        return x


def jacobi_trisolve_plan(a: CSR, *, lower: bool = True, unit_diag: bool = False,
                         device=None) -> JacobiTriSolvePlan:
    """Plan the sweep solve: split D / strict-N on the host, route N through
    the DIA plan when banded (zero-gather sweeps); on ``device`` as
    :func:`trisolve_plan`."""
    device = plan_device(a.data, device)
    n = a.shape[0]
    if a.shape[0] != a.shape[1]:
        raise ValueError("triangular solve needs a square matrix")
    rows, cols, strict, diag_idx = _split_triangle(a, lower)
    if not unit_diag and np.any(diag_idx < 0):
        raise ValueError("zero diagonal entry (missing from pattern)")
    data = host(a.data)
    dinv = None
    if not unit_diag:
        d = data[diag_idx]
        if np.any(d == 0):
            raise ValueError("zero diagonal entry")
        dinv = torch.as_tensor(1.0 / d, device=device)

    n_csr = coo_to_csr(coo_from_arrays(data[strict], rows[strict], cols[strict], (n, n)),
                       sum_duplicates=False)
    if n_csr.nnz and estimate_dia_traffic(n_csr) is not None:
        strict_op = dia_plan(n_csr, device=device)
    else:
        strict_op = n_csr.to(device)
    return JacobiTriSolvePlan(n=n, lower=lower, unit_diag=unit_diag, strict=strict_op,
                              dinv=dinv, device=device)


def trisolve(a: CSR, b, *, lower: bool = True, unit_diag: bool = False,
             method: str = "levels", sweeps: int = 5, plan: Optional[object] = None,
             device=None) -> torch.Tensor:
    """Solve the sparse triangular system ``a x = b``.

    ``method='levels'``: the exact level-scheduled wavefront solve.
    ``method='jacobi'``: ``sweeps`` Jacobi–Richardson iterations, each an
    SpMV-class parallel op (exact once ``sweeps ≥ n``, accurate much sooner
    on diagonally dominant triangles).

    Build (or pass) the matching plan; for repeated solves with one
    pattern (the preconditioner case) keep it.  A new plan goes to
    ``device``, else to a tensor ``b``'s device, else where ``a``'s tensors
    are (the CUDA device for host numpy arrays)."""
    if device is None and isinstance(b, torch.Tensor):
        device = b.device
    if method == "jacobi":
        if plan is None:
            plan = jacobi_trisolve_plan(a, lower=lower, unit_diag=unit_diag, device=device)
        return plan.solve(b, sweeps=sweeps)
    if method != "levels":
        raise ValueError(f"unknown trisolve method {method!r}")
    if plan is None:
        plan = trisolve_plan(a, lower=lower, unit_diag=unit_diag, device=device)
    return plan.solve(a.data, b)
