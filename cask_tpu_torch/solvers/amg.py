"""Smoothed-aggregation algebraic multigrid (AMG) preconditioner.

The PyTorch counterpart of :mod:`cask_tpu.solvers.amg`, split as there:

- **Set-up (host, once):** strength-of-connection graph → greedy (Vaněk)
  aggregation (the port's native core, or the same passes in Python) →
  piecewise-constant tentative prolongator → Jacobi-smoothed prolongator →
  Galerkin ``A_c = Pᵀ A P``, in scipy step for step as the reference, so
  the level matrices are the reference's; recursing until the coarsest
  level is small enough to invert densely.
- **Apply (device):** one V-cycle: weighted-Jacobi smoothing, restriction
  and prolongation, a dense coarse solve.  ``route='auto'`` sends each
  level operator through a kernel: a banded level through its DIA plan
  (the DIA SpMV kernel), an unstructured one through its POH plan (the POH
  SpMV kernel), a level at or below ``dense_cutoff`` rows as a dense
  matrix; the smoothed P and R are applied in factored form over one-hot
  tentative POH packs and the routed level operator.

With ``nu_pre == nu_post`` and the symmetric Jacobi smoother the V-cycle
is SPD for SPD ``A``, so a valid CG preconditioner.  The hierarchy is
plain frozen dataclasses (the reference's are JAX pytrees so that a jitted
solve can take them as arguments; a Python loop needs no such thing).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import scipy.sparse as sp
import torch

from cask_tpu_torch.formats.convert import from_scipy, to_scipy
from cask_tpu_torch.formats.matrix import CSR, numpy_dtype
from cask_tpu_torch.native import binding as nat
from cask_tpu_torch.ops.dia import dia_plan, estimate_dia_traffic
from cask_tpu_torch.ops.poh import PohMatrix, poh_plan
from cask_tpu_torch.ops.spmv import spmv
from cask_tpu_torch.utils.platform import plan_device, require_full_fp32


def _strength_graph(a_sp, theta: float):
    """Symmetric strength-of-connection mask: |a_ij| ≥ θ·√(a_ii·a_jj)."""
    d = np.abs(a_sp.diagonal())
    d = np.where(d == 0, 1.0, d)
    coo = a_sp.tocoo()
    scale = np.sqrt(d[coo.row] * d[coo.col])
    keep = (np.abs(coo.data) >= theta * scale) & (coo.row != coo.col)
    s = sp.csr_matrix(
        (np.ones(int(keep.sum())), (coo.row[keep], coo.col[keep])),
        shape=a_sp.shape)
    return s.maximum(s.T).tocsr()


def _aggregate(strength, *, use_native: Optional[bool] = None) -> np.ndarray:
    """Greedy aggregation over the strength graph (Vaněk passes 1-3):
    ``agg[i]`` is node i's aggregate id; isolated nodes become singletons.

    The port's native core (``use_native=True`` raises where it cannot
    build; ``None`` takes the Python passes then), or the Python passes
    (``False``), which give the same ids: both are the same order-dependent
    greedy passes in row order."""
    if use_native is not False:
        try:
            agg, _ = nat.aggregate(strength.indptr, strength.indices)
            return agg
        except nat.NativeUnavailable:
            if use_native:
                raise
    n = strength.shape[0]
    indptr, indices = strength.indptr, strength.indices
    agg = np.full(n, -1, dtype=np.int64)
    next_id = 0
    # pass 1: roots whose strong neighbourhood is fully unaggregated
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        if (agg[nbrs] == -1).all():
            agg[i] = next_id
            agg[nbrs] = next_id
            next_id += 1
    # pass 2: attach leftovers to any aggregated strong neighbour
    for i in range(n):
        if agg[i] != -1:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        hit = nbrs[agg[nbrs] != -1]
        if hit.size:
            agg[i] = agg[hit[0]]
    # pass 3: remaining isolated nodes become singletons
    for i in range(n):
        if agg[i] == -1:
            agg[i] = next_id
            next_id += 1
    return agg


@dataclasses.dataclass(frozen=True, eq=False)
class AmgLevel:
    """One level: its operator, prolongator, restriction and inverse
    diagonal, on the device.  An operator is whatever the router picked: a
    :class:`~cask_tpu_torch.ops.dia.DiaMatrix` (banded), a
    :class:`~cask_tpu_torch.ops.poh.PohMatrix` (unstructured), a dense
    tensor (small), a :class:`_FactoredApply` (smoothed P and R), or a CSR
    (``route='csr'``)."""

    a: object
    p: object  # n_fine × n_coarse
    r: object  # Pᵀ
    dinv: torch.Tensor  # 1/diag(a), for Jacobi smoothing


def _apply_op(op, x, precision: str = "split"):
    if isinstance(op, torch.Tensor):
        return op @ x
    if isinstance(op, _FactoredApply):
        return op(x, precision)
    if isinstance(op, PohMatrix):
        return op.spmv(x, precision=precision)
    return spmv(op, x)


@dataclasses.dataclass(frozen=True, eq=False)
class _FactoredApply:
    """The smoothed prolongator in factored form, ``P = (I − ω_s D⁻¹A)·T``:

        P·xc = t − ω_s·D⁻¹·(A·t),          t = T·xc
        R·r  = Tᵀ·(r − ω_s·A·(D⁻¹·r))      (A symmetric)

    so each application is one product with a one-hot tentative pack (one
    slot a fine row) and one with the level's routed operator, instead of
    a product with the smoothed P or R (about three slots a fine row)."""

    kind: str  # 'p' | 'r'
    tent: object  # PohMatrix, (n × nc) one-hot
    tent_t: object  # PohMatrix, (nc × n)
    a: object  # the routed level operator
    dinv: torch.Tensor
    omega_s: float

    @property
    def shape(self):
        return self.tent.shape if self.kind == "p" else self.tent_t.shape

    def __call__(self, x, precision: str = "split"):
        w = self.omega_s
        if self.kind == "p":
            t = _apply_op(self.tent, x, precision)
            return t - w * self.dinv * _apply_op(self.a, t, precision)
        return _apply_op(self.tent_t,
                         x - w * _apply_op(self.a, self.dinv * x, precision),
                         precision)


@dataclasses.dataclass(frozen=True, eq=False)
class AmgPrecond:
    """Callable ``r → V-cycle(r) ≈ A⁻¹r``; pass it as ``M=`` to the solvers.

    ``poh_precision`` goes to every POH-routed product of the cycle; the
    port's POH kernels are exact in every mode (plain FP32/FP64 FMAs), so
    it changes nothing but is checked as the reference checks it.  The
    coarse solve is a dense matrix–vector product, full FP32 on the card:
    a CUDA float32 cycle raises under ``allow_tf32``."""

    levels: List[AmgLevel]
    coarse_inv: torch.Tensor  # dense inverse of the coarsest operator
    omega: float
    nu_pre: int
    nu_post: int
    poh_precision: str = "split"

    @property
    def level_sizes(self) -> List[int]:
        return [lv.a.shape[0] for lv in self.levels] + [self.coarse_inv.shape[0]]

    def _cycle(self, b, lvl: int):
        if lvl == len(self.levels):
            return self.coarse_inv @ b
        level = self.levels[lvl]
        w = self.omega
        prec = self.poh_precision
        x = w * level.dinv * b  # first sweep from x = 0
        for _ in range(self.nu_pre - 1):
            x = x + w * level.dinv * (b - _apply_op(level.a, x, prec))
        resid = b - _apply_op(level.a, x, prec)
        xc = self._cycle(_apply_op(level.r, resid, prec), lvl + 1)
        x = x + _apply_op(level.p, xc, prec)
        for _ in range(self.nu_post):
            x = x + w * level.dinv * (b - _apply_op(level.a, x, prec))
        return x

    def apply(self, r):
        require_full_fp32(self.coarse_inv, "the AMG coarse solve")
        return self._cycle(r, 0)

    def __call__(self, r):
        return self.apply(r)


def smoothed_aggregation_amg(a: CSR, *, theta: float = 0.08, omega: float = 2.0 / 3.0,
                             nu_pre: int = 1, nu_post: int = 1, smooth: bool = True,
                             max_levels: int = 12, coarse_size: int = 256,
                             dtype=None, route: str = "auto",
                             dense_cutoff: int = 2048,
                             poh_precision: str = "split", device=None) -> AmgPrecond:
    """Build a smoothed-aggregation AMG hierarchy for SPD ``a``.

    ``theta`` is the strength threshold (smaller: coarser aggregates);
    ``smooth=False`` gives plain aggregation.  ``dtype`` (torch or numpy)
    sets the apply precision, e.g. float32 for the V-cycle inside an f64
    :func:`~cask_tpu_torch.solvers.ir_solve`.  ``route='auto'`` routes each
    level operator as the module docstring says (the tentative packs with
    16384-row panels and 8192-slot tiles); ``route='csr'`` keeps every
    operator a CSR on the device (``spmv``'s own route).  The hierarchy goes
    to ``device`` (default: where ``a``'s tensors are, the CUDA device for
    host numpy arrays)."""
    device = plan_device(a.data, device)
    np_dt = None if dtype is None else numpy_dtype(dtype)
    a_sp = to_scipy(a).tocsr().astype(np.float64)
    levels: List[AmgLevel] = []

    def put(mat_sp, row_panel: int = 4096, tile_slots: int = 2048):
        mat_sp = mat_sp.tocsr()
        if route == "auto" and max(mat_sp.shape) <= dense_cutoff:
            apply_dt = np_dt if np_dt is not None else mat_sp.dtype
            return torch.as_tensor(mat_sp.toarray().astype(apply_dt), device=device)
        csr = from_scipy(mat_sp, format="csr")
        if np_dt is not None:
            csr = csr.astype(np_dt)
        if route != "auto":
            return csr.to(device)
        if estimate_dia_traffic(csr) is not None:
            return dia_plan(csr, device=device)
        return poh_plan(csr, tile_slots=tile_slots, row_panel=row_panel, device=device)

    while a_sp.shape[0] > coarse_size and len(levels) < max_levels:
        strength = _strength_graph(a_sp, theta)
        agg = _aggregate(strength)
        n_agg = int(agg.max()) + 1
        if n_agg >= a_sp.shape[0]:  # no coarsening possible (e.g. diagonal)
            break
        n = a_sp.shape[0]
        tent = sp.csr_matrix((np.ones(n), (np.arange(n), agg)), shape=(n, n_agg))
        rho = None
        if smooth:
            dvals = a_sp.diagonal()
            dinv_h = np.where(dvals == 0, 0.0, 1.0 / np.where(dvals == 0, 1.0, dvals))
            da = sp.diags(dinv_h) @ a_sp
            rho = float(abs(da).sum(axis=1).max())  # bounds the spectral radius
            prol = (tent - (4.0 / 3.0 / rho) * (da @ tent)).tocsr()
        else:
            prol = tent
        a_coarse = (prol.T @ a_sp @ prol).tocsr()
        a_coarse.sum_duplicates()

        dvals = a_sp.diagonal()
        dinv = np.where(dvals == 0, 0.0, 1.0 / np.where(dvals == 0, 1.0, dvals))
        apply_dtype = np_dt if np_dt is not None else a_sp.dtype
        a_dev = put(a_sp)
        dinv_dev = torch.as_tensor(dinv.astype(apply_dtype), device=device)
        if smooth and route == "auto" and n > dense_cutoff:
            # the smoothed P and R in factored form over one-hot tentative
            # packs; 16384-row panels for these tall one-slot-a-row packs
            fp = dict(tent=put(tent, row_panel=16384, tile_slots=8192),
                      tent_t=put(tent.T.tocsr(), row_panel=16384, tile_slots=8192),
                      a=a_dev, dinv=dinv_dev, omega_s=4.0 / 3.0 / rho)
            p_dev = _FactoredApply(kind="p", **fp)
            r_dev = _FactoredApply(kind="r", **fp)
        else:
            p_dev = put(prol)
            r_dev = put(prol.T.tocsr())
        levels.append(AmgLevel(a=a_dev, p=p_dev, r=r_dev, dinv=dinv_dev))
        a_sp = a_coarse

    coarse = np.linalg.inv(a_sp.toarray())
    if np_dt is not None:
        coarse = coarse.astype(np_dt)
    return AmgPrecond(levels=levels, coarse_inv=torch.as_tensor(coarse, device=device),
                      omega=omega, nu_pre=nu_pre, nu_post=nu_post,
                      poh_precision=poh_precision)
