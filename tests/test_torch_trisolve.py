"""The port's triangular solves, ILU(0) (host and Chow–Patel), IC(0) and SSOR
against the JAX package's, on the CPU.

Plan arrays are compared for equality; ILU(0)'s host values bit for bit
(the same C++ on the same input).  f64 solves, factors and applies agree
with the reference and scipy within 1e-12 normwise (the same operations;
the level sweep's sums in the same order), f32 within 1e-5.  Jacobi
sweeps are exact after n sweeps and their error decays as the reference's
tests hold.  Preconditioned CG takes the reference's iteration count ±1.
"""

import importlib

import jax  # noqa: F401  (kept on the CPU with x64 by conftest)
import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import cask_tpu.formats.convert as jconv
import cask_tpu.solvers.krylov as jkrylov
import cask_tpu.solvers.precond as jprecond
import cask_tpu_torch as ct
import cask_tpu_torch.formats.convert as tconv
import cask_tpu_torch.formats.generate as tgen
from cask_tpu_torch import interop
from cask_tpu_torch.ops.dia import DiaMatrix
from cask_tpu_torch.solvers import cg

jtri = importlib.import_module("cask_tpu.ops.trisolve")
ttri = importlib.import_module("cask_tpu_torch.ops.trisolve")
jilu = importlib.import_module("cask_tpu.ops.ilu")
tilu = importlib.import_module("cask_tpu_torch.ops.ilu")
CPU = "cpu"
LEVEL_FIELDS = ("lvl_rows", "lvl_diag_idx", "lvl_ent_local", "lvl_ent_col", "lvl_ent_idx",
                "lvl_ent_valid")
PAIR_FIELDS = ("pair_out", "pair_l", "pair_u", "diag_of_col", "is_lower", "low_src", "up_src")


def _tri_scipy(n, density, lower=True, seed=0, unit=False):
    rs = np.random.RandomState(seed)
    s = sp.random(n, n, density=density, format="csr", random_state=rs)
    s = sp.tril(s, k=-1) if lower else sp.triu(s, k=1)
    diag = np.ones(n) if unit else (rs.rand(n) + 1.0)
    s = (s + sp.diags(diag)).tocsr()
    s.sum_duplicates()
    return s


def _both(s):
    """The same scipy matrix as a reference CSR and a port CSR."""
    return jconv.from_scipy(s), tconv.from_scipy(s)


def _rel(x, ref) -> float:
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    ref = np.asarray(ref)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def _b(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape)


TRIANGLES = {
    "random lower": lambda: (_tri_scipy(150, 0.05, True, 1), True, False),
    "random upper": lambda: (_tri_scipy(150, 0.05, False, 1), False, False),
    "unit lower": lambda: (_tri_scipy(100, 0.05, True, 3, unit=True), True, True),
    "chain (300 levels)": lambda: ((_tri_scipy(300, 0.0, True, 5)
                                    + sp.diags(np.ones(299), -1)).tocsr(), True, False),
    "diagonal only": lambda: (sp.diags(np.arange(1.0, 51.0)).tocsr(), True, False),
    "stencil lower": lambda: (sp.tril(tconv.to_scipy(tgen.stencil_2d(12))).tocsr(), True,
                              False),
    "stencil upper": lambda: (sp.triu(tconv.to_scipy(tgen.stencil_2d(12))).tocsr(), False,
                              False),
}


@pytest.mark.parametrize("name", sorted(TRIANGLES))
def test_level_plan_arrays_equal_the_references(name):
    s, lower, unit = TRIANGLES[name]()
    aj, at = _both(s)
    pj = jtri.trisolve_plan(aj, lower=lower, unit_diag=unit)
    pt = ttri.trisolve_plan(at, lower=lower, unit_diag=unit, device=CPU)
    assert (pt.nlevels, pt.max_rows, pt.max_ents) == (pj.nlevels, pj.max_rows, pj.max_ents)
    for f in LEVEL_FIELDS:
        got, ref = getattr(pt, f), getattr(pj, f)
        assert got.dtype == ref.dtype and np.array_equal(got, ref), f


@pytest.mark.parametrize("name", sorted(TRIANGLES))
@pytest.mark.parametrize("k", [None, 3])
def test_level_solve_matches_the_reference_and_scipy(name, k):
    s, lower, unit = TRIANGLES[name]()
    aj, at = _both(s)
    b = _b(s.shape[0] if k is None else (s.shape[0], k), 2)
    x = ct.trisolve(at, torch.from_numpy(b), lower=lower, unit_diag=unit)
    assert x.shape == b.shape
    xr = np.asarray(jtri.trisolve(aj, b, lower=lower, unit_diag=unit))
    assert _rel(x, xr) <= 1e-12
    assert _rel(x, spla.spsolve_triangular(s, b, lower=lower, unit_diagonal=unit)) <= 1e-12


@pytest.mark.parametrize("lower", [True, False])
def test_level_solve_in_f32(lower):
    s = _tri_scipy(150, 0.05, lower, 4)
    at = tconv.from_scipy(s.astype(np.float32))
    b = _b(150, 5).astype(np.float32)
    x = ct.trisolve(at, torch.from_numpy(b), lower=lower)
    assert x.dtype == torch.float32
    assert _rel(x.double(), spla.spsolve_triangular(s, b.astype(np.float64), lower=lower)) <= 1e-5


def test_pad_slot_stays_zero_after_a_padded_solve():
    # a stencil triangle's levels are anti-diagonals of 1..12 rows: every
    # level but the widest is padded with writes into slot n
    s, lower, _ = TRIANGLES["stencil lower"]()
    p = ttri.trisolve_plan(tconv.from_scipy(s), lower=lower, device=CPU)
    assert (p.lvl_rows == p.n).sum() > 0 and (~p.lvl_ent_valid).sum() > 0
    for shape in ((s.shape[0],), (s.shape[0], 4)):
        b = torch.from_numpy(_b(shape, 6))
        xe = ttri._level_sweep(torch.from_numpy(s.data), b, p.dev["rows"], p.dev["diag"],
                               p.dev["ent_local"], p.dev["ent_col"], p.dev["ent_idx"],
                               p.dev["ent_valid"], n=p.n, max_rows=p.max_rows,
                               unit_diag=False)
        assert xe.shape[0] == p.n + 1 and bool((xe[p.n] == 0).all())


def test_plan_from_the_references_arrays_solves_alike():
    s, lower, unit = TRIANGLES["random upper"]()
    aj, at = _both(s)
    pj = jtri.trisolve_plan(aj, lower=lower, unit_diag=unit)
    pt = interop.trisolve_plan_from_arrays(*(getattr(pj, f) for f in LEVEL_FIELDS), n=pj.n,
                                           lower=lower, unit_diag=unit, device=CPU)
    b = _b(s.shape[0], 7)
    assert _rel(pt.solve(s.data, torch.from_numpy(b)), pj.solve(s.data, b)) <= 1e-12


@pytest.mark.parametrize("case", ["wrong side", "missing diagonal", "not square",
                                  "unknown method"])
@pytest.mark.parametrize("method", ["levels", "jacobi"])
def test_errors_raise_as_the_reference(case, method):
    if case == "wrong side":
        s, kw = _tri_scipy(20, 0.1, True, 7), dict(lower=False)
    elif case == "missing diagonal":
        s, kw = sp.csr_matrix(np.array([[1.0, 0.0], [1.0, 0.0]])), dict(lower=True)
    elif case == "not square":
        s, kw = sp.csr_matrix(np.ones((2, 3))), dict(lower=True)
    else:
        s, kw = _tri_scipy(20, 0.1, True, 7), dict(lower=True)
        method = "spsv"
    aj, at = _both(s)
    b = np.ones(s.shape[0])
    with pytest.raises(ValueError):
        jtri.trisolve(aj, b, method=method, **kw)
    with pytest.raises(ValueError):
        ct.trisolve(at, torch.from_numpy(b), method=method, **kw)


def test_zero_diagonal_value_raises_for_jacobi():
    s = sp.csr_matrix((np.array([1.0, 1.0, 0.0]), (np.array([0, 1, 1]), np.array([0, 0, 1]))),
                      shape=(2, 2))  # the diagonal's (1, 1) stored, but zero
    assert s.nnz == 3
    aj, at = _both(s)
    with pytest.raises(ValueError):
        jtri.jacobi_trisolve_plan(aj)
    with pytest.raises(ValueError):
        ttri.jacobi_trisolve_plan(at, device=CPU)


def test_a_host_matrix_plans_on_the_card_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = _tri_scipy(30, 0.1, True, 8)
    at = tconv.from_scipy(s)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttri.trisolve_plan(at)
    with pytest.raises(RuntimeError, match="CUDA"):
        ct.trisolve(at, np.ones(30))
    with pytest.raises(RuntimeError, match="CUDA"):
        ct.ilu0(tgen.stencil_2d(4))
    x = ct.trisolve(at, torch.ones(30, dtype=torch.float64))  # a CPU tensor asks for the CPU
    assert x.device.type == "cpu"


# -- Jacobi–Richardson sweeps ------------------------------------------------


@pytest.mark.parametrize("lower", [True, False])
def test_jacobi_is_exact_after_n_sweeps(lower):
    s = _tri_scipy(60, 0.08, lower, 5)
    aj, at = _both(s)
    b = _b(60, 6)
    x = ct.trisolve(at, torch.from_numpy(b), lower=lower, method="jacobi", sweeps=60)
    xr = np.asarray(jtri.trisolve(aj, b, lower=lower, method="jacobi", sweeps=60))
    assert _rel(x, xr) <= 1e-12
    assert _rel(x, spla.spsolve_triangular(s, b, lower=lower)) <= 1e-9


def test_jacobi_error_decays_with_sweeps():
    s = (_tri_scipy(200, 0.03, True, 7) + 5.0 * sp.eye(200)).tocsr()
    aj, at = _both(s)
    b = _b(200, 8)
    ref = spla.spsolve_triangular(s, b, lower=True)
    errs = []
    for sweeps in (1, 3, 6):
        x = ct.trisolve(at, torch.from_numpy(b), method="jacobi", sweeps=sweeps)
        xr = np.asarray(jtri.trisolve(aj, b, method="jacobi", sweeps=sweeps))
        assert _rel(x, xr) <= 1e-12
        errs.append(_rel(x, ref))
    assert errs[1] < errs[0] * 0.3
    assert errs[2] < errs[1] * 0.3


def test_jacobi_unit_diag_and_batch():
    s = _tri_scipy(80, 0.05, True, 9, unit=True)
    aj, at = _both(s)
    B = _b((80, 3), 10)
    X = ct.trisolve(at, torch.from_numpy(B), unit_diag=True, method="jacobi", sweeps=80)
    Xr = np.asarray(jtri.trisolve(aj, B, unit_diag=True, method="jacobi", sweeps=80))
    assert _rel(X, Xr) <= 1e-12
    assert _rel(X, spla.spsolve_triangular(s, B, lower=True)) <= 1e-9


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("k", [None, 4])
def test_banded_triangle_routes_through_a_dia_plan(lower, k):
    s = tconv.to_scipy(tgen.stencil_2d(12))
    s = (sp.tril(s) if lower else sp.triu(s)).tocsr()
    aj, at = _both(s)
    pt = ttri.jacobi_trisolve_plan(at, lower=lower, device=CPU)
    pj = jtri.jacobi_trisolve_plan(aj, lower=lower)
    assert isinstance(pt.strict, DiaMatrix) and pt.strict.offsets == pj.strict.offsets
    assert pt.strict.rem_data.shape[0] == 0
    b = _b(144 if k is None else (144, k), 11)
    for sweeps in (5, 144):
        x = pt.solve(torch.from_numpy(b), sweeps=sweeps)
        assert _rel(x, pj.solve(b, sweeps=sweeps)) <= 1e-12
    assert _rel(x, spla.spsolve_triangular(s, b, lower=lower)) <= 1e-8


def test_unbanded_triangle_takes_a_csr():
    s = _tri_scipy(120, 0.05, True, 12)
    pt = ttri.jacobi_trisolve_plan(tconv.from_scipy(s), device=CPU)
    assert isinstance(pt.strict, ct.CSR) and isinstance(pt.strict.data, torch.Tensor)


# -- ILU(0) on the host --------------------------------------------------------


ILU_MATRICES = {
    "stencil_2d(10)": lambda: tconv.to_scipy(tgen.stencil_2d(10)),
    "banded(200, 4)": lambda: tconv.to_scipy(tgen.banded(200, 4, seed=8, spd=True)),
    "power_law(150)": lambda: (lambda s: (s + sp.diags(abs(s).sum(1).A1 + 1)).tocsr())(
        tconv.to_scipy(tgen.power_law(150, avg_degree=5, seed=3))),
}


def _pattern_residual(s, f):
    """‖(L·U − A)‖ restricted to A's pattern: the ILU(0) invariant."""
    low, up = f.split()
    prod = (tconv.to_scipy(low) @ tconv.to_scipy(up)).tocsr()
    mask = s.copy()
    mask.data = np.ones_like(mask.data)
    diff = prod.multiply(mask) - s
    return 0.0 if diff.nnz == 0 else abs(diff).max()


@pytest.mark.parametrize("name", sorted(ILU_MATRICES))
def test_ilu0_values_and_apply_match_the_reference(name):
    s = ILU_MATRICES[name]()
    aj, at = _both(s)
    fj = jilu.ilu0(aj)
    ft = ct.ilu0(at, device=CPU)
    assert np.array_equal(ft.lu.data, np.asarray(fj.lu.data))  # native: bit for bit
    assert np.array_equal(ct.ilu0(at, use_native=False, device=CPU).lu.data,
                          np.asarray(jilu.ilu0(aj, use_native=False).lu.data))
    assert _pattern_residual(s, ft) < 1e-10
    for plan in ("_lower_plan", "_upper_plan"):
        for f in LEVEL_FIELDS:
            assert np.array_equal(getattr(getattr(ft, plan), f), getattr(getattr(fj, plan), f))
    for shape in (s.shape[0], (s.shape[0], 3)):
        b = _b(shape, 9)
        assert _rel(ft.apply(torch.from_numpy(b)), fj.apply(b)) <= 1e-12
        assert _rel(ft.apply(torch.from_numpy(b), method="jacobi", sweeps=4),
                    fj.apply(b, method="jacobi", sweeps=4)) <= 1e-12


def test_ilu0_apply_in_f32():
    s = ILU_MATRICES["stencil_2d(10)"]()
    ft = ct.ilu0(tconv.from_scipy(s.astype(np.float32)), device=CPU)
    f64 = jilu.ilu0(jconv.from_scipy(s))
    b = _b(s.shape[0], 10)
    z = ft.apply(torch.from_numpy(b.astype(np.float32)))
    assert z.dtype == torch.float32
    assert _rel(z.double(), f64.apply(b)) <= 1e-5


def test_ilu0_is_exact_for_a_no_fill_pattern():
    s = tconv.to_scipy(tgen.banded(100, 1, seed=10, spd=True))
    f = ct.ilu0(tconv.from_scipy(s), device=CPU)
    b = _b(100, 11)
    assert _rel(f.apply(torch.from_numpy(b)), np.linalg.solve(s.toarray(), b)) <= 1e-12


def test_ilu0_factors_from_the_references_arrays():
    s = ILU_MATRICES["banded(200, 4)"]()
    fj = jilu.ilu0(jconv.from_scipy(s))
    ft = interop.ilu0_factors_from_arrays(fj.lu.data, fj.lu.indices, fj.lu.indptr, s.shape,
                                          device=CPU)
    b = _b(s.shape[0], 12)
    assert _rel(ft.apply(torch.from_numpy(b)), fj.apply(b)) <= 1e-12


@pytest.mark.parametrize("use_native", [None, False, True])
def test_ilu0_errors_raise_as_the_reference(use_native):
    missing = sp.csr_matrix(np.array([[1.0, 1.0], [1.0, 0.0]]))
    missing.eliminate_zeros()
    zero_pivot = sp.csr_matrix(np.array([[1.0, 1.0], [1.0, 1.0]]))
    for s, exc in ((missing, ValueError if use_native is not True else ZeroDivisionError),
                   (zero_pivot, ZeroDivisionError)):
        aj, at = _both(s)
        with pytest.raises(exc):
            jilu.ilu0(aj, use_native=use_native)
        with pytest.raises(exc):
            ct.ilu0(at, use_native=use_native, device=CPU)
    with pytest.raises(TypeError):
        ct.ilu0(tconv.csr_to_coo(tgen.stencil_2d(3)), device=CPU)


# -- Chow–Patel ILU(0) on the device --------------------------------------------


DEVICE_MATRICES = {
    **ILU_MATRICES,
    "stencil_2d(16)": lambda: tconv.to_scipy(tgen.stencil_2d(16)),
    "banded(200, 4), not dominant": lambda: tconv.to_scipy(tgen.banded(200, 4, seed=7)),
    "stiff2d_576.mtx": lambda: tconv.to_scipy(ct.read_mtx("tests/data/stiff2d_576.mtx")),
}


@pytest.mark.parametrize("name", sorted(DEVICE_MATRICES))
def test_device_plan_arrays_equal_the_references(name):
    s = DEVICE_MATRICES[name]()
    aj, at = _both(s)
    pj = jilu.ilu0_device_plan(aj)
    pt = tilu.ilu0_device_plan(at, device=CPU)
    for f in PAIR_FIELDS:
        got, ref = getattr(pt, f).numpy(), np.asarray(getattr(pj, f))
        assert got.dtype == ref.dtype and np.array_equal(got, ref), f
    for plan in ("lower_plan", "upper_plan"):
        for f in LEVEL_FIELDS:
            assert np.array_equal(getattr(getattr(pt, plan), f), getattr(getattr(pj, plan), f))
    vt, vj = pt.factorize(sweeps=6), np.asarray(pj.factorize(sweeps=6))
    if np.isfinite(vj).all():
        assert _rel(vt, vj) <= 1e-12
        assert abs(float(pt.residual(vt)) - float(pj.residual(vj))) <= 1e-12 * max(
            1.0, float(pj.residual(vj)))


def test_device_factorize_converges_to_the_host_factors():
    s = DEVICE_MATRICES["stencil_2d(16)"]()
    at = tconv.from_scipy(s)
    host = ct.ilu0(at, device=CPU)
    plan = tilu.ilu0_device_plan(at, device=CPU)
    v = plan.factorize(sweeps=25)
    np.testing.assert_allclose(v.numpy(), host.lu.data, rtol=1e-9, atol=1e-9)
    assert float(plan.residual(v)) < 1e-9
    # values re-bind without re-planning
    v2 = plan.factorize(s.data * 2.0, sweeps=25)
    np.testing.assert_allclose(v2.numpy(), ct.ilu0(tconv.from_scipy(s * 2.0), device=CPU).lu.data,
                               rtol=1e-9, atol=1e-9)


def test_device_apply_matches_the_reference_and_the_host():
    s = ILU_MATRICES["banded(200, 4)"]()
    aj, at = _both(s)
    dj = jilu.ilu0_device(aj, sweeps=25)
    dt = tilu.ilu0_device(at, sweeps=25, device=CPU)
    b = _b(s.shape[0], 1)
    z = dt.apply(torch.from_numpy(b))
    assert _rel(z, dj.apply(b)) <= 1e-12
    assert _rel(z, ct.ilu0(at, device=CPU).apply(torch.from_numpy(b))) <= 1e-8


def test_device_residual_flags_divergence():
    s = DEVICE_MATRICES["banded(200, 4), not dominant"]()
    plan = tilu.ilu0_device_plan(tconv.from_scipy(s), device=CPU)
    res = float(plan.residual(plan.factorize(sweeps=15)))
    assert not np.isfinite(res) or res > 1e-2


def test_device_plan_missing_diagonal_raises():
    s = sp.csr_matrix((np.ones(2), (np.array([0, 1]), np.array([1, 0]))), shape=(2, 2))
    aj, at = _both(s)
    with pytest.raises(ValueError, match="missing diagonal in row 0"):
        jilu.ilu0_device_plan(aj)
    with pytest.raises(ValueError, match="missing diagonal in row 0"):
        tilu.ilu0_device_plan(at, device=CPU)


# -- IC(0) and SSOR ---------------------------------------------------------------


def test_ic0_factor_and_applies_match_the_reference():
    s = ILU_MATRICES["stencil_2d(10)"]()
    aj, at = _both(s)
    fj = jprecond.ic0(aj)
    ft = ct.solvers.ic0(at, device=CPU)
    assert np.array_equal(ft.l.indices, np.asarray(fj.l.indices))
    assert np.abs(ft.l.data - np.asarray(fj.l.data)).max() == 0.0
    b = _b(s.shape[0], 14)
    assert _rel(ft.apply(torch.from_numpy(b)), fj.apply(b)) <= 1e-12
    assert _rel(ft.apply(torch.from_numpy(b), method="jacobi", sweeps=s.shape[0]),
                ft.apply(torch.from_numpy(b))) <= 1e-9
    assert _rel(ft.jacobi_applier(3)(torch.from_numpy(b)),
                fj.jacobi_applier(3)(b)) <= 1e-12


def test_ic0_nonpositive_pivot_raises():
    s = sp.csr_matrix(np.array([[1.0, 2.0], [2.0, 1.0]]))  # ILU pivot 1 - 4 = -3
    aj, at = _both(s)
    with pytest.raises(ValueError, match="nonpositive pivot"):
        jprecond.ic0(aj)
    with pytest.raises(ValueError, match="nonpositive pivot"):
        ct.solvers.ic0(at, device=CPU)


@pytest.mark.parametrize("omega", [1.0, 1.4])
@pytest.mark.parametrize("k", [None, 2])
def test_ssor_apply_matches_the_reference(omega, k):
    s = ILU_MATRICES["power_law(150)"]()
    aj, at = _both(s)
    b = _b(s.shape[0] if k is None else (s.shape[0], k), 15)
    assert _rel(ct.solvers.ssor(at, omega, device=CPU)(torch.from_numpy(b)),
                jprecond.ssor(aj, omega)(b)) <= 1e-12


@pytest.mark.parametrize("omega", [0.0, 2.0, -1.0])
def test_ssor_omega_out_of_range_raises(omega):
    aj, at = _both(ILU_MATRICES["stencil_2d(10)"]())
    with pytest.raises(ValueError):
        jprecond.ssor(aj, omega)
    with pytest.raises(ValueError):
        ct.solvers.ssor(at, omega, device=CPU)


def test_ssor_zero_diagonal_raises():
    s = sp.csr_matrix(np.array([[1.0, 1.0], [1.0, 0.0]]))
    aj, at = _both(s)
    with pytest.raises(ValueError):
        jprecond.ssor(aj)
    with pytest.raises(ValueError):
        ct.solvers.ssor(at, device=CPU)


# -- preconditioned CG, the slice as a whole ------------------------------------


def _system(nx):
    """S = I + stencil_2d(nx): the card's [ilu-cg] system, at a small size."""
    st = tconv.to_scipy(tgen.stencil_2d(nx))
    return (sp.identity(st.shape[0], format="csr") + st).tocsr()


PRECONDITIONERS = {
    "ilu0 levels": (lambda a: jilu.ilu0(a).apply, lambda a: ct.ilu0(a, device=CPU).apply),
    "ilu0 jacobi(5)": (lambda a: jilu.ilu0(a).jacobi_applier(5),
                       lambda a: ct.ilu0(a, device=CPU).jacobi_applier(5)),
    "ic0": (lambda a: jprecond.ic0(a).apply, lambda a: ct.solvers.ic0(a, device=CPU).apply),
    "ssor(1.0)": (lambda a: jprecond.ssor(a, 1.0), lambda a: ct.solvers.ssor(a, 1.0,
                                                                            device=CPU)),
    "ilu0_device(8)": (lambda a: jilu.ilu0_device(a, sweeps=8).apply,
                       lambda a: tilu.ilu0_device(a, sweeps=8, device=CPU).apply),
    "none": (lambda a: None, lambda a: None),
}


@pytest.mark.parametrize("name", sorted(PRECONDITIONERS))
def test_preconditioned_cg_iterations_match_the_reference(name):
    s = _system(24)
    aj, at = _both(s)
    mj, mt = PRECONDITIONERS[name]
    b = _b(s.shape[0], 16)
    ref = jkrylov.cg(aj, b, tol=1e-10, maxiter=500, M=mj(aj))
    res = cg(at, torch.from_numpy(b), tol=1e-10, maxiter=500, M=mt(at))
    assert res.converged and bool(ref.converged)
    assert abs(res.iterations - int(ref.iterations)) <= 1
    assert np.linalg.norm(b - s @ res.x.numpy()) / np.linalg.norm(b) <= 1e-9
    assert _rel(res.x, np.asarray(ref.x)) <= 1e-9
