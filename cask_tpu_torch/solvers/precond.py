"""Preconditioners: Jacobi, block Jacobi, IC(0), SSOR, the Chebyshev
polynomial, and the spectrum estimates it needs.

The PyTorch counterparts of :mod:`cask_tpu.solvers.precond`, with
``shard_ilu0``, the block ILU(0) of a distributed operator; ILU(0) lives
in :mod:`cask_tpu_torch.ops.ilu`.  Each is a callable ``r → M⁻¹r`` (or has an
``apply``) on the device, for the Krylov solvers.  IC(0) and SSOR apply
through the same level-scheduled triangular-solve plans as ILU(0), so on
the card each apply is a Python loop of small launches per level (about
2·√n levels for a 2-D stencil); IC(0)'s ``method='jacobi'`` apply is a
few DIA SpMV launches instead.  Block Jacobi applies its host-inverted
blocks as one batched product; the Chebyshev preconditioner is ``degree``
operator applications.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from cask_tpu_torch.formats.convert import coo_from_arrays, coo_to_csr, from_scipy, to_scipy
from cask_tpu_torch.formats.matrix import CSR, host, to_device, torch_dtype
from cask_tpu_torch.ops.ilu import _split_lu, ilu0, ilu0_lu
from cask_tpu_torch.ops.spmv import operand_device, spmv
from cask_tpu_torch.ops.trisolve import TriSolvePlan, jacobi_trisolve_plan, trisolve_plan
from cask_tpu_torch.utils.platform import plan_device, require_full_fp32


def extract_diagonal(a: CSR) -> np.ndarray:
    indptr = host(a.indptr).astype(np.int64)
    indices = host(a.indices).astype(np.int64)
    data = host(a.data)
    n = min(a.shape)
    rows = np.repeat(np.arange(a.shape[0], dtype=np.int64), np.diff(indptr))
    on = (rows == indices) & (rows < n)
    d = np.zeros(n, dtype=data.dtype)
    d[rows[on]] = data[on]
    return d


def jacobi(a: CSR, *, device=None):
    """Diagonal (Jacobi) preconditioner: ``r → r / diag(A)``, with the
    inverse diagonal on ``device`` (default: where ``a``'s tensors are, the
    CUDA device for host numpy arrays)."""
    device = plan_device(a.data, device)
    d = extract_diagonal(a)
    if np.any(d == 0):
        raise ValueError("Jacobi preconditioner requires a nonzero diagonal")
    inv = torch.as_tensor(1.0 / d, device=device)

    def apply(r):
        if r.ndim == 1:
            return r * inv
        return r * inv[:, None]

    return apply


def block_jacobi(a: CSR, block: int = 64, *, device=None):
    """Dense-inverted diagonal blocks: ``r → blkdiag(A)⁻¹ r``.

    The blocks are inverted once on the host (LU, a zero on a block's
    diagonal patched to 1, the padding of the last block the identity) and
    applied as one batched product (``torch.bmm``) on ``device`` (default:
    where ``a``'s tensors are, the CUDA device for host numpy arrays), to a
    vector or an (n, s) block.  A CUDA float32 apply refuses to run under
    ``allow_tf32``."""
    device = plan_device(a.data, device)
    n = a.shape[0]
    nb = -(-n // block)
    data = host(a.data)
    dense = np.zeros((nb, block, block), dtype=data.dtype)
    indptr = host(a.indptr).astype(np.int64)
    indices = host(a.indices).astype(np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    inblk = rows // block == indices // block
    r, c, v = rows[inblk], indices[inblk], data[inblk]
    dense[r // block, r % block, c % block] = v
    for b in range(nb):
        hi = min(block, n - b * block)
        blk = dense[b, :hi, :hi]
        if np.any(np.diag(blk) == 0):
            np.fill_diagonal(blk, np.where(np.diag(blk) == 0, 1.0, np.diag(blk)))
        dense[b, :hi, :hi] = np.linalg.inv(blk)
        if hi < block:  # identity on padding
            for i in range(hi, block):
                dense[b, i, i] = 1.0
    inv = torch.as_tensor(dense, device=device)

    def apply(r):
        vec = r.ndim == 1
        dt = torch.promote_types(inv.dtype, r.dtype)
        r2 = (r[:, None] if vec else r).to(dt)
        require_full_fp32(r2, "block_jacobi")
        rp = torch.nn.functional.pad(r2, (0, 0, 0, nb * block - n))
        out = torch.bmm(inv.to(dt), rp.reshape(nb, block, -1)).reshape(nb * block, -1)[:n]
        return out[:, 0] if vec else out

    return apply


@dataclasses.dataclass(frozen=True, eq=False)
class IC0Factors:
    """IC(0) factor ``L_c`` with ``A ≈ L_c L_cᵀ`` (host numpy, ``l``) plus
    cached solve plans and each plan's values on the plans' device."""

    l: CSR  # lower-triangular Cholesky factor (diag included)  # noqa: E741
    _lower_plan: TriSolvePlan
    _upper_plan: TriSolvePlan
    _lower_data: torch.Tensor
    _upper_data: torch.Tensor

    @property
    def device(self) -> torch.device:
        return self._lower_plan.device

    def apply(self, b, *, method: str = "levels", sweeps: int = 5) -> torch.Tensor:
        """Preconditioner solve ``x = L_c⁻ᵀ L_c⁻¹ b`` (symmetric).

        ``method='jacobi'`` uses sweep solves (see
        :meth:`cask_tpu_torch.ops.ilu.ILU0Factors.apply`)."""
        if method == "jacobi":
            lp, up = self._jacobi_plans()
            return up.solve(lp.solve(b, sweeps=sweeps), sweeps=sweeps)
        y = self._lower_plan.solve(self._lower_data, b)
        return self._upper_plan.solve(self._upper_data, y)

    def jacobi_applier(self, sweeps: int = 5):
        """``r → M⁻¹r`` via Jacobi–Richardson sweep solves."""
        lp, up = self._jacobi_plans()
        return lambda r: up.solve(lp.solve(r, sweeps=sweeps), sweeps=sweeps)

    def _jacobi_plans(self):
        cached = getattr(self, "_jacobi_cache", None)
        if cached is None:
            lct = from_scipy(to_scipy(self.l).T.tocsr())
            cached = (jacobi_trisolve_plan(self.l, lower=True, unit_diag=False,
                                           device=self.device),
                      jacobi_trisolve_plan(lct, lower=False, unit_diag=False,
                                           device=self.device))
            object.__setattr__(self, "_jacobi_cache", cached)
        return cached


def ic0(a: CSR, *, device=None) -> IC0Factors:
    """Incomplete Cholesky IC(0) for SPD ``a`` with a symmetric pattern.

    Built through the identity that ILU(0) on a symmetric matrix/pattern
    yields ``U = D Lᵀ``, hence ``L_c = L D^{1/2}`` satisfies ``A ≈ L_c L_cᵀ``
    on A's pattern.  Unlike raw ILU(0) the ``apply`` is a *symmetric*
    operator, the form CG requires of ``M``, at the cost of the ILU(0)
    apply.  Raises if a pivot is nonpositive (not SPD on its own pattern):
    fall back to :func:`cask_tpu_torch.ops.ilu.ilu0` then.  The plans and
    values go to ``device`` (default: where ``a``'s tensors are, the CUDA
    device for host numpy arrays)."""
    device = plan_device(a.data, device)
    low, up = _split_lu(ilu0_lu(a))  # L has an explicit unit diagonal; U carries D
    d = extract_diagonal(up)
    if np.any(d <= 0):
        raise ValueError("IC(0): nonpositive pivot — matrix is not SPD on its own pattern")
    sq = np.sqrt(d)
    lc = CSR(data=host(low.data) * sq[host(low.indices).astype(np.int64)],
             indices=low.indices, indptr=low.indptr, shape=low.shape)
    lct = from_scipy(to_scipy(lc).T.tocsr())  # host planning only
    return IC0Factors(l=lc,
                      _lower_plan=trisolve_plan(lc, lower=True, unit_diag=False, device=device),
                      _upper_plan=trisolve_plan(lct, lower=False, unit_diag=False,
                                                device=device),
                      _lower_data=to_device(lc.data, device),
                      _upper_data=to_device(lct.data, device))


def ssor(a: CSR, omega: float = 1.0, *, device=None):
    """SSOR preconditioner ``M = (D+ωL) D⁻¹ (D+ωU) / (ω(2−ω))``.

    Factorization-free (A's own triangles, so it never breaks down where
    ILU can), symmetric for symmetric A; ω ∈ (0, 2), ω = 1 giving
    symmetric Gauss–Seidel.  The apply is two level-scheduled triangular
    sweeps plus a diagonal scale, on ``device`` as :func:`ic0`."""
    if not 0.0 < omega < 2.0:
        raise ValueError("SSOR requires 0 < omega < 2")
    device = plan_device(a.data, device)
    indptr = host(a.indptr).astype(np.int64)
    indices = host(a.indices).astype(np.int64)
    data = host(a.data)
    n = a.shape[0]
    d = extract_diagonal(a)
    if np.any(d == 0):
        raise ValueError("SSOR requires a nonzero diagonal")
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    diag_idx = np.arange(n, dtype=np.int64)

    def tri(strict_mask):
        r = np.concatenate([rows[strict_mask], diag_idx])
        c = np.concatenate([indices[strict_mask], diag_idx])
        v = np.concatenate([omega * data[strict_mask], d])
        return coo_to_csr(coo_from_arrays(v, r, c, a.shape), sum_duplicates=False)

    low = tri(indices < rows)
    up = tri(indices > rows)
    lowplan = trisolve_plan(low, lower=True, unit_diag=False, device=device)
    upplan = trisolve_plan(up, lower=False, unit_diag=False, device=device)
    low_data = to_device(low.data, device)
    up_data = to_device(up.data, device)
    dj = torch.as_tensor(d, device=device)
    scale = omega * (2.0 - omega)

    def apply(r):
        y = lowplan.solve(low_data, r)
        y = y * dj if y.ndim == 1 else y * dj[:, None]
        return scale * upplan.solve(up_data, y)

    return apply


def _operator(a):
    return a if callable(a) and not hasattr(a, "shape") else (lambda v: spmv(a, v))


def _start_vector(n: int, dtype, seed: int, device) -> torch.Tensor:
    """The power and Lanczos iterations' start: ``n`` standard normal
    values of ``dtype`` from a ``torch.Generator`` seeded with ``seed`` (on
    the CPU, so every device draws the same vector), on ``device``.  (The
    reference draws ``jax.random.normal(PRNGKey(seed))``, which torch
    cannot reproduce.)"""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, generator=g, dtype=dtype).to(device)


def _widened(a, v: torch.Tensor) -> torch.Tensor:
    """``v`` in the wider of its type and the matrix's, as the reference's
    product promotes it (a callable's operand stays as it is)."""
    dt = getattr(a, "dtype", None)
    return v if dt is None else v.to(torch.promote_types(v.dtype, torch_dtype(dt)))


def estimate_lmax(a, n: int, *, iters: int = 20, seed: int = 0, device=None) -> float:
    """Largest-eigenvalue estimate by ``iters`` power iterations from a
    float32 start vector (float32 whatever ``a``'s type; the products
    promote as in the reference), inflated ×1.05 for use as Chebyshev's
    ``lmax``.  ``a`` is a matrix or an ``x → A@x`` callable over length-``n``
    vectors; the vector lives on ``device`` (default: the matrix's or
    operator's, the CUDA device for host arrays or a plain callable)."""
    op = _operator(a)
    device = torch.device(device) if device is not None else operand_device(a)
    v = _start_vector(n, torch.float32, seed, device)
    for _ in range(iters):
        w = op(_widened(a, v))
        v = (w / torch.linalg.vector_norm(w)).to(torch.float32)
    av = op(_widened(a, v))
    return float(torch.vdot(_widened(a, v), av) / torch.vdot(v, v)) * 1.05


def lanczos_extremal(a, n: int, *, iters: int = 30, seed: int = 0, device=None):
    """Extremal-eigenvalue estimates ``(lmin, lmax)`` for symmetric ``a``.

    ``iters`` Lanczos steps with full reorthogonalization against the
    stored basis, in ``a``'s type (float32 for a callable), then
    ``eigvalsh`` of the small tridiagonal; the pair is nudged outward
    (lmin ×0.95, lmax ×1.05; the other way for negative values) for use as
    Chebyshev bounds.  ``lmax`` is accurate within a few percent at
    ``iters≈30``; ``lmin`` of an ill-conditioned operator lands above the
    true minimum.  The vectors live on ``device`` as in
    :func:`estimate_lmax`."""
    op = _operator(a)
    device = torch.device(device) if device is not None else operand_device(a)
    m = int(min(iters, n))
    dt = torch_dtype(a.dtype) if hasattr(a, "dtype") else torch.float32
    v0 = _start_vector(n, dt, seed, device)
    V = v0.new_zeros((m + 1, n))
    V[0] = v0 / torch.linalg.vector_norm(v0)
    beta = v0.new_zeros(())
    alphas, betas = [], []
    for j in range(m):
        vj = V[j]
        w = op(vj).to(dt) - beta * V[j - 1]  # V[-1], the zero last row, at j = 0
        alpha = torch.vdot(vj, w)
        w = w - alpha * vj
        Vj = V[:j + 1]
        w = w - Vj.T @ (Vj @ w)  # full reorthogonalization over the filled rows
        beta = torch.linalg.vector_norm(w)
        V[j + 1] = w / torch.where(beta == 0, torch.ones_like(beta), beta)
        alphas.append(alpha)
        betas.append(beta)
    al, be = torch.stack(alphas), torch.stack(betas)[:-1]
    t = torch.diag(al) + torch.diag(be, 1) + torch.diag(be, -1)
    evals = torch.linalg.eigvalsh(t).cpu()
    lmin, lmax = float(evals[0]), float(evals[-1])
    lmin *= 0.95 if lmin > 0 else 1.05
    lmax *= 1.05 if lmax > 0 else 0.95
    return lmin, lmax


def chebyshev_precond(a, *, lmin: float, lmax: float, degree: int = 8, M=None):
    """Polynomial preconditioner ``r → p(A) r ≈ A⁻¹ r``: ``degree`` fixed
    Chebyshev steps over ``[lmin, lmax]``, each one operator application
    and an axpy, with no inner product or triangular solve.  A fixed degree
    makes it a linear SPD operator, so a valid CG preconditioner.  ``M`` is
    an optional inner preconditioner (e.g. :func:`jacobi`) applied in each
    step."""
    op = _operator(a)
    inner = M or (lambda r: r)
    theta = (lmax + lmin) / 2.0
    delta = (lmax - lmin) / 2.0

    def apply(r):
        x = torch.zeros_like(r)
        alpha = 1.0 / theta
        d = inner(r) * alpha
        rr = r
        for _ in range(degree):
            x = x + d
            rr = rr - op(d)
            beta = (delta * alpha / 2.0) ** 2
            alpha_new = 1.0 / (theta - beta / alpha)
            d = alpha_new * (inner(rr) + beta * d / alpha)
            alpha = alpha_new
        return x + d

    return apply


def shard_ilu0(a: CSR, dist):
    """Additive-Schwarz block ILU(0) of a distributed operator: each rank
    factors its own diagonal block ``A_ss`` (padded with the identity to
    ``mloc`` rows, as the reference pads its stacked plans) and applies
    ``U_s⁻¹ L_s⁻¹`` to its shard with the level-scheduled triangular
    solves, with no communication.  No rank holds another rank's plans.

    ``dist`` is a :class:`cask_tpu_torch.parallel.DistSpmv`; the result is
    the bound ``apply`` of this rank's :class:`ILU0Factors` (its
    ``__self__``), for the operator's padded shards:
    ``cg(dist.padded_op, dist.padded(b), M=shard_ilu0(a, dist))``.  Needs
    A's diagonal present in every local block."""
    import scipy.sparse as sp

    plan, mesh = dist.plan, dist.mesh
    s, mloc, m = mesh.rank, plan.mloc, a.shape[0]
    r0, r1 = s * mloc, min((s + 1) * mloc, m)
    spa = to_scipy(a).tocsr()
    blk = spa[r0:r1, r0:r1].tocsr() if r1 > r0 else sp.csr_matrix((0, 0))
    pad = mloc - blk.shape[0]
    if pad:
        blk = sp.block_diag([blk, sp.identity(pad, format="csr")], format="csr")
    blk.sort_indices()
    return ilu0(from_scipy(blk, format="csr"), device=mesh.device).apply
