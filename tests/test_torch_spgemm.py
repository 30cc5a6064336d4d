"""The port's SpGEMM and sparse add against the JAX package's, on the CPU.

``SpGEMMPlan``'s five arrays and ``AddPlan``'s four equal the reference's;
f64 products and sums agree with the reference and scipy within 1e-12
normwise (the same products summed in the same order), f32 within 1e-5;
``PohNumeric`` (the POH SpMV over the expansion map) within the
reference's own 1e-3, and within 1e-12 of the gather numeric in f64.
"""

import importlib
from pathlib import Path

import jax  # noqa: F401  (kept on the CPU with x64 by conftest)
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cask_tpu.formats.convert as jconv
import cask_tpu_torch as ct
import cask_tpu_torch.formats.convert as tconv
import cask_tpu_torch.formats.generate as tgen
from cask_tpu_torch import interop

jspgemm = importlib.import_module("cask_tpu.ops.spgemm")
tspgemm = importlib.import_module("cask_tpu_torch.ops.spgemm")
jadd = importlib.import_module("cask_tpu.ops.add")
tadd = importlib.import_module("cask_tpu_torch.ops.add")
DATA = Path(__file__).resolve().parent / "data"
CPU = "cpu"
PLAN_FIELDS = ("src_a", "src_b", "out_id", "c_indices", "c_indptr")
ADD_FIELDS = ("c_indices", "c_indptr", "a_dst", "b_dst")


def _empty_rows():
    s = sp.lil_matrix((5, 5))
    s[1, 2] = 3.0
    return s.tocsr()


PRODUCTS = {  # (A, B) as scipy f64; B None is A·A
    "aa power_law(300)": lambda: (tconv.to_scipy(tgen.power_law(300, avg_degree=5, seed=1)),
                                  None),
    "aa stencil_2d(15)": lambda: (tconv.to_scipy(tgen.stencil_2d(15)), None),
    "aa fem_blocks(5, dof=3)": lambda: (tconv.to_scipy(tgen.fem_blocks(5, dof=3)), None),
    "ab rectangular": lambda: (tconv.to_scipy(tgen.random_uniform(80, 120, density=0.05,
                                                                  seed=2)),
                               tconv.to_scipy(tgen.random_uniform(120, 60, density=0.05,
                                                                  seed=3))),
    "aa empty rows": lambda: (_empty_rows(), None),
    "aa graph_pattern_120.mtx": lambda: (tconv.to_scipy(ct.read_mtx(
        DATA / "graph_pattern_120.mtx")), None),
}


def _pair(name, dtype=np.float64):
    a, b = PRODUCTS[name]()
    b = a if b is None else b
    a, b = a.astype(dtype), b.astype(dtype)
    return a, b


def _rel_csr(c, ref) -> float:
    got = tconv.to_scipy(c).astype(np.float64)
    ref = sp.csr_matrix(ref).astype(np.float64)
    d = abs(got - ref)
    scale = max(abs(ref).max() if ref.nnz else 0.0, 1e-300)
    return 0.0 if d.nnz == 0 else float(sp.linalg.norm(d) / max(sp.linalg.norm(ref), scale))


@pytest.mark.parametrize("name", sorted(PRODUCTS))
def test_plan_arrays_equal_the_references(name):
    a, b = _pair(name)
    pj = jspgemm.spgemm_plan(jconv.from_scipy(a), jconv.from_scipy(b))
    pt = tspgemm.spgemm_plan(tconv.from_scipy(a), tconv.from_scipy(b), device=CPU)
    assert pt.shape == pj.shape and pt.expansion == pj.expansion and pt.nnz == pj.nnz
    for f in PLAN_FIELDS:
        got, ref = getattr(pt, f), np.asarray(getattr(pj, f))
        assert got.dtype == ref.dtype and np.array_equal(got, ref), f
    assert (np.diff(pt.out_id) >= 0).all()


@pytest.mark.parametrize("name", sorted(PRODUCTS))
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-12), (np.float32, 1e-5)])
def test_product_matches_the_reference_and_scipy(name, dtype, tol):
    a, b = _pair(name, dtype)
    at, bt = tconv.from_scipy(a), tconv.from_scipy(b)
    c = ct.spgemm(at, bt, backend="plan", device=CPU)
    assert isinstance(c.data, torch.Tensor) and c.data.dtype == torch.from_numpy(a.data).dtype
    ref64 = a.astype(np.float64) @ b.astype(np.float64)
    assert _rel_csr(c, ref64) <= tol
    cj = jspgemm.spgemm(jconv.from_scipy(a), jconv.from_scipy(b), backend="plan")
    assert np.array_equal(c.indices.numpy(), np.asarray(cj.indices))
    assert _rel_csr(c, jconv.to_scipy(cj)) <= tol


def test_plan_reuse_across_values():
    rs = np.random.RandomState(0)
    s1 = sp.random(70, 70, density=0.08, format="csr", random_state=rs)
    s2 = s1.copy()
    s2.data = rs.standard_normal(s2.nnz)
    a1, a2 = tconv.from_scipy(s1), tconv.from_scipy(s2)
    plan = tspgemm.spgemm_plan(a1, a1, device=CPU)
    assert _rel_csr(plan.numeric(a1.data, a1.data), s1 @ s1) <= 1e-12
    assert _rel_csr(ct.spgemm(a2, plan=plan), s2 @ s2) <= 1e-12


def test_plan_from_the_references_arrays_computes_alike():
    a, b = _pair("ab rectangular")
    pj = jspgemm.spgemm_plan(jconv.from_scipy(a), jconv.from_scipy(b))
    pt = interop.spgemm_plan_from_arrays(*(getattr(pj, f) for f in PLAN_FIELDS),
                                         shape=pj.shape, device=CPU)
    assert _rel_csr(pt.numeric(a.data, b.data), a @ b) <= 1e-12


@pytest.mark.parametrize("case", ["dimension mismatch", "not csr"])
def test_errors_raise_as_the_reference(case):
    a = tgen.random_uniform(10, 20, density=0.2)
    b = tgen.random_uniform(30, 10, density=0.2)
    if case == "not csr":
        a, b, exc = tconv.csr_to_coo(a), None, TypeError
        ja = None
    else:
        exc = ValueError
        ja, jb = jconv.from_scipy(tconv.to_scipy(a)), jconv.from_scipy(tconv.to_scipy(b))
    with pytest.raises(exc):
        ct.spgemm(a, b, device=CPU)
    if ja is not None:
        with pytest.raises(exc):
            jspgemm.spgemm(ja, jb)
        with pytest.raises(exc):
            tspgemm.spgemm_plan(a, b, device=CPU)


@pytest.mark.parametrize("name", ["aa power_law(300)", "ab rectangular"])
def test_native_backend_matches_the_reference_and_the_plan(name):
    a, b = _pair(name)
    c = ct.spgemm(tconv.from_scipy(a), tconv.from_scipy(b), backend="native")
    cj = jspgemm.spgemm_native(jconv.from_scipy(a), jconv.from_scipy(b))
    for f in ("indptr", "indices", "data"):  # a host CSR, as the reference's
        assert isinstance(getattr(c, f), np.ndarray)
        assert np.array_equal(getattr(c, f), np.asarray(getattr(cj, f)))
    assert _rel_csr(c, a @ b) <= 1e-12


def test_auto_takes_native_above_the_threshold_and_the_plan_below(monkeypatch):
    a, b = _pair("aa stencil_2d(15)")
    at = tconv.from_scipy(a)
    assert tspgemm.expansion_size(at, at) == jspgemm.expansion_size(
        jconv.from_scipy(a), jconv.from_scipy(a))
    below = ct.spgemm(at, device=CPU)
    assert isinstance(below.data, torch.Tensor)
    monkeypatch.setattr(tspgemm, "_NATIVE_THRESHOLD", tspgemm.expansion_size(at, at) - 1)
    above = ct.spgemm(at, device=CPU)
    assert isinstance(above.data, np.ndarray)
    assert _rel_csr(above, a @ a) <= 1e-12 and _rel_csr(below, a @ a) <= 1e-12
    assert tspgemm._NATIVE_THRESHOLD != jspgemm._NATIVE_THRESHOLD  # patched here only


def test_the_threshold_is_the_references():
    assert tspgemm._NATIVE_THRESHOLD == jspgemm._NATIVE_THRESHOLD == 30_000_000


# -- the POH numeric (A's values bound) ----------------------------------------


@pytest.mark.parametrize("name", ["aa power_law(300)", "ab rectangular"])
def test_poh_numeric_matches_the_reference_and_scipy(name):
    a, b = _pair(name, np.float32)
    pj = jspgemm.spgemm_plan(jconv.from_scipy(a), jconv.from_scipy(b))
    pt = tspgemm.spgemm_plan(tconv.from_scipy(a), tconv.from_scipy(b), device=CPU)
    bound = pt.bind_poh(a.data, nnz_b=b.nnz)
    for seed in (0, 1):  # B's values stream; A's are bound
        bd = np.random.default_rng(seed).standard_normal(b.nnz).astype(np.float32)
        c = bound(torch.from_numpy(bd))
        bs = sp.csr_matrix((bd, b.indices, b.indptr), shape=b.shape)
        ref = (a @ bs).tocsr()
        d = abs(tconv.to_scipy(c) - ref)
        assert d.nnz == 0 or d.max() < 1e-3  # the reference's own bound
        assert _rel_csr(c, ref.astype(np.float64)) <= 1e-5
    cj = pj.bind_poh(a.data, nnz_b=b.nnz)(bd)  # the reference's POH kernel, interpreted
    assert _rel_csr(c, jconv.to_scipy(cj)) <= 1e-5


def test_poh_numeric_in_f64_equals_the_gather_numeric():
    a, b = _pair("aa fem_blocks(5, dof=3)")
    pt = tspgemm.spgemm_plan(tconv.from_scipy(a), tconv.from_scipy(b), device=CPU)
    bound = pt.bind_poh(a.data)
    assert bound._poh.shape == (pt.nnz, b.nnz)
    c = bound(b.data)
    assert c.data.dtype == torch.float64
    assert _rel_csr(c, tconv.to_scipy(pt.numeric(a.data, b.data))) <= 1e-12
    assert _rel_csr(bound.to(CPU)(b.data), a @ b) <= 1e-12


# -- sparse add -------------------------------------------------------------------


ADDS = {
    "random 60": lambda: (tgen.random_uniform(60, 60, density=0.05, seed=30),
                          tgen.random_uniform(60, 60, density=0.05, seed=31)),
    "stencil + its square": lambda: (tgen.stencil_2d(8), tconv.from_scipy(
        tconv.to_scipy(tgen.stencil_2d(8)) @ tconv.to_scipy(tgen.stencil_2d(8)))),
    "rectangular": lambda: (tgen.random_uniform(40, 70, density=0.06, seed=32),
                            tgen.random_uniform(40, 70, density=0.06, seed=33)),
}


@pytest.mark.parametrize("name", sorted(ADDS))
def test_add_plan_arrays_and_sums_match_the_reference(name):
    at, bt = ADDS[name]()
    aj, bj = (jconv.from_scipy(tconv.to_scipy(x)) for x in (at, bt))
    pj = jadd.add_plan(aj, bj)
    pt = tadd.add_plan(at, bt, device=CPU)
    for f in ADD_FIELDS:
        got, ref = getattr(pt, f), np.asarray(getattr(pj, f))
        assert got.dtype == ref.dtype and np.array_equal(got, ref), f
    c = ct.sp_add(at, bt, alpha=2.0, beta=-0.5, plan=pt)
    cj = jadd.sp_add(aj, bj, alpha=2.0, beta=-0.5)
    assert np.array_equal(c.data.numpy(), np.asarray(cj.data))
    assert _rel_csr(c, 2.0 * tconv.to_scipy(at) - 0.5 * tconv.to_scipy(bt)) <= 1e-12
    c2 = interop.add_plan_from_arrays(*(getattr(pj, f) for f in ADD_FIELDS), shape=pj.shape,
                                      device=CPU).numeric(np.asarray(at.data) * 3, bt.data)
    assert _rel_csr(c2, 3 * tconv.to_scipy(at) + tconv.to_scipy(bt)) <= 1e-12


def test_add_promotes_and_keeps_f32():
    a = tgen.random_uniform(50, 50, density=0.06, seed=34, dtype=np.float32)
    b = tgen.random_uniform(50, 50, density=0.06, seed=35, dtype=np.float32)
    c = ct.sp_add(a, b, device=CPU)
    assert c.data.dtype == torch.float32
    ref = tconv.to_scipy(a).astype(np.float64) + tconv.to_scipy(b).astype(np.float64)
    assert _rel_csr(c, ref) <= 1e-6
    assert ct.sp_add(a, b.astype(np.float64), device=CPU).data.dtype == torch.float64


def test_add_shape_mismatch_raises():
    a = tgen.random_uniform(5, 6, density=0.3)
    b = tgen.random_uniform(6, 5, density=0.3)
    with pytest.raises(ValueError):
        jadd.add_plan(jconv.from_scipy(tconv.to_scipy(a)), jconv.from_scipy(tconv.to_scipy(b)))
    with pytest.raises(ValueError):
        ct.sp_add(a, b, device=CPU)


@pytest.mark.parametrize("sigma", [-2.5, 1.0])
def test_shift_identity_matches_the_reference(sigma):
    a = tgen.power_law(80, avg_degree=4, seed=34)
    c = ct.shift_identity(a, sigma, device=CPU)
    cj = jadd.shift_identity(jconv.from_scipy(tconv.to_scipy(a)), sigma)
    assert np.array_equal(c.data.numpy(), np.asarray(cj.data))
    assert _rel_csr(c, tconv.to_scipy(a) + sigma * sp.eye(80)) <= 1e-12
