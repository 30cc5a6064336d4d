"""Parity of the port's DIA plan, plain twins, operator and dispatch with the
JAX package, on the CPU (the kernels on the card: tests/test_torch_gpu.py).

Both packages get the same host matrix, built with scipy from a numpy seed.
The packed plan arrays must equal the reference's exactly.  The reference's
Pallas kernels run as tests/test_pallas_kernels.py runs them: in interpret
mode on the CPU.  Tolerances: f64 ≤ 1e-12 normwise (the same products in
the same diagonal order), f32 ≤ 1e-5.
"""

import importlib

import jax  # noqa: F401  (kept on the CPU with x64 by conftest)
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cask_tpu.formats.convert as jconv
import cask_tpu.formats.generate as jgen
import cask_tpu.ops.dia as jdia
import cask_tpu.solvers.krylov as jkrylov
import cask_tpu_torch as ct
import cask_tpu_torch.formats.convert as tconv
import cask_tpu_torch.formats.generate as tgen
import cask_tpu_torch.ops.dia as tdia
from cask_tpu.ops.pallas import dia_kernels as jdk
from cask_tpu.ops.spmv import spmv as jax_spmv
from cask_tpu.ops.spmv import transposed as jax_transposed
from cask_tpu_torch import interop
from cask_tpu_torch.ops.kernels.dia_kernels import dia_kernel_ok, dia_spmv, dia_spmv_reference
from cask_tpu_torch.ops.spmv import PlanCache, spmv, transposed
from cask_tpu_torch.solvers import cg, jacobi

# the module itself: ``cask_tpu_torch.ops.spmv`` as an attribute is the function
spmv_mod = importlib.import_module("cask_tpu_torch.ops.spmv")
TOL = {np.float32: 1e-5, np.float64: 1e-12}


def _relerr(y, ref):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(y - ref) / np.linalg.norm(ref)


def _diags(m, n, offsets, seed):
    """Random values on the given diagonals of an m×n matrix (scipy CSR)."""
    rng = np.random.default_rng(seed)
    lens = [min(m, n - k) if k >= 0 else min(m + k, n) for k in offsets]
    return sp.diags([rng.standard_normal(ln) for ln in lens], offsets, shape=(m, n)).tocsr()


def _remainder_matrix():
    """A dense 5-diagonal band, a thin far band whose diagonals fall below the
    density floor, and scattered entries: a plan with a COO remainder."""
    s = tconv.to_scipy(tgen.banded(9000, 2, seed=1))
    s = s + tconv.to_scipy(tgen.banded(9000, 12, density=0.02, seed=3))
    rng = np.random.default_rng(4)
    r, c = rng.integers(0, 9000, 20), rng.integers(0, 9000, 20)
    return (s + sp.csr_matrix((rng.standard_normal(20), (r, c)), shape=s.shape)).tocsr()


# name -> scipy matrix (f64); ≤ 9025 rows
CASES = {
    "stencil95": lambda: tconv.to_scipy(tgen.stencil_2d(95)),
    "banded": lambda: tconv.to_scipy(tgen.banded(9000, 3, seed=2)),
    "remainder": _remainder_matrix,
    "asym_up": lambda: _diags(2000, 2000, [1, 3, 7], 7),
    "asym_down": lambda: _diags(2000, 2000, [-5, -2, 0], 8),
    "rect_tall": lambda: _diags(3000, 1200, [-1500, -2, 0, 1, 700], 9),
    "rect_wide": lambda: _diags(1200, 3000, [-700, -1, 0, 2, 1500], 10),
}


def _tall():
    """20000×5000 with two diagonals: more padded rows than padded columns."""
    return _diags(20000, 5000, [0, -1], 11)


def _pair(s, dtype=np.float64):
    s = s.astype(dtype)
    return jconv.from_scipy(s), tconv.from_scipy(s)


def _plans(name, dtype=np.float64, **kw):
    j, t = _pair(CASES[name](), dtype)
    return jdia.dia_plan(j, **kw), tdia.dia_plan(t, device="cpu", **kw)


def _same(jv, tv):
    jv, tv = np.asarray(jv), tv.numpy()
    assert jv.dtype == tv.dtype and np.array_equal(jv, tv)


def _same_plan(jp, tp):
    for f in ("vals", "rem_data", "rem_row", "rem_col"):
        _same(getattr(jp, f), getattr(tp, f))
    assert (tp.offsets, tp.shape, tp.m_pad, tp.ndiags) == (jp.offsets, jp.shape, jp.m_pad,
                                                           jp.ndiags)
    assert tp.offsets_dev.tolist() == list(jp.offsets)


class TestPlan:
    @pytest.mark.parametrize("name", list(CASES))
    def test_packs_exactly_like_the_reference(self, name):
        jp, tp = _plans(name, with_vals_t=True)
        _same_plan(jp, tp)
        _same(jp.vals_t, tp.vals_t)
        assert tp.traffic_bytes == jp.traffic_bytes
        if name == "remainder":
            assert 0 < tp.rem_data.shape[0] <= 0.1 * CASES[name]().nnz

    @pytest.mark.parametrize("kw", [dict(min_density=0.5), dict(max_diags=3),
                                    dict(min_density=2.0)])
    def test_options_pack_like_the_reference(self, kw):
        jp, tp = _plans("remainder", **kw)
        _same_plan(jp, tp)
        assert tp.vals_t is None and jp.vals_t is None

    @pytest.mark.parametrize("name", [*CASES, "power_law"])
    def test_estimate_dia_traffic(self, name):
        if name == "power_law":
            j, t = jgen.power_law(3000, seed=5), tgen.power_law(3000, seed=5)
        else:
            j, t = _pair(CASES[name]())
        est = tdia.estimate_dia_traffic(t)
        assert est == jdia.estimate_dia_traffic(j)
        assert (est is None) == (name == "power_law")
        assert tdia.estimate_dia_traffic(t, max_diags=2) == \
            jdia.estimate_dia_traffic(j, max_diags=2)

    @pytest.mark.parametrize("name", list(CASES))
    def test_transpose_plan_matches_the_reference(self, name):
        jp, tp = _plans(name)
        jt, tt = jdia.transpose_plan(jp), tdia.transpose_plan(tp)
        _same_plan(jt, tt)
        assert tt.vals_t is None
        s = CASES[name]()
        x = np.random.default_rng(12).standard_normal(s.shape[0])
        assert _relerr(tt.spmv(torch.from_numpy(x)), s.T @ x) <= TOL[np.float64]

    def test_transpose_plan_of_a_tall_plan(self):
        # the reference cannot build this (ROADMAP Queue C 5); the port can
        s = _tall()
        j, t = _pair(s)
        jp, tp = jdia.dia_plan(j), tdia.dia_plan(t, device="cpu")
        with pytest.raises(ValueError):
            jdia.transpose_plan(jp)
        x = np.random.default_rng(13).standard_normal(s.shape[0])
        xt = torch.from_numpy(x)
        tt = tdia.transpose_plan(tp)
        assert tt.shape == (5000, 20000) and tt.m_pad == 8192
        for y in (tt.spmv(xt), spmv(tp, xt, transpose=True), spmv(t, xt, transpose=True,
                                                                  method="dia")):
            assert _relerr(y, s.T @ x) <= TOL[np.float64]
        # and back: (Aᵀ)ᵀ packs like the plan it came from
        back = tdia.transpose_plan(tt)
        assert torch.equal(back.vals, tp.vals) and back.offsets == tp.offsets

    def test_to_astype_and_device(self):
        _, tp = _plans("remainder")
        p32 = tp.astype(np.float32).to("cpu")
        assert p32.dtype == torch.float32 and p32.rem_row.dtype == torch.int32
        assert p32.offsets_dev.dtype == torch.int32 and p32.device.type == "cpu"
        # bf16 and f16 values take the half paths
        assert dia_kernel_ok(p32) and dia_kernel_ok(tp.astype(torch.bfloat16))
        assert dia_kernel_ok(tp.astype(torch.float16))

    def test_interop_plan_computes_the_same_y(self):
        jp, tp = _plans("remainder", with_vals_t=True)
        ip = interop.dia_from_arrays(np.asarray(jp.vals), np.asarray(jp.rem_data),
                                     np.asarray(jp.rem_row), np.asarray(jp.rem_col),
                                     jp.offsets, jp.shape, vals_t=np.asarray(jp.vals_t),
                                     device="cpu")
        _same_plan(jp, ip)
        x = torch.from_numpy(np.random.default_rng(14).standard_normal(jp.shape[1]))
        assert torch.equal(ip.spmv(x), tp.spmv(x))
        with pytest.raises(ValueError):
            interop.dia_from_arrays(np.asarray(jp.vals)[:-1], jp.rem_data, jp.rem_row,
                                    jp.rem_col, jp.offsets, jp.shape, device="cpu")
        with pytest.raises(ValueError):
            interop.dia_from_arrays(jp.vals, jp.rem_data, jp.rem_row, jp.rem_col,
                                    jp.offsets, jp.shape, vals_t=np.asarray(jp.vals),
                                    device="cpu")


class TestTwinAgainstReference:
    @pytest.mark.parametrize("name", list(CASES))
    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_matches_spmv_xla(self, name, dtype):
        jp, tp = _plans(name, dtype)
        x = np.random.default_rng(1).standard_normal(jp.shape[1]).astype(dtype)
        y_ref = np.asarray(jp._spmv_xla(x))
        y = tp._spmv_reference(torch.from_numpy(x))
        assert y.dtype == torch.from_numpy(x).dtype and y.shape == y_ref.shape
        assert _relerr(y, y_ref) <= TOL[dtype]
        # the wrapper on a CPU tensor is the twin; it launches nothing
        before = dia_spmv.launches
        assert torch.equal(tp.spmv(torch.from_numpy(x)), y)
        assert dia_spmv.launches == before

    @pytest.mark.parametrize("name", ["stencil95", "banded", "remainder", "asym_up",
                                      "asym_down", "rect_tall"])
    def test_matches_pallas_padded_kernel(self, name):
        # B8 (dia_spmv_pallas_padded via dia_spmv_pallas), interpret mode, f64:
        # the packed part against the kernel alone
        jp, tp = _plans(name)
        x = np.random.default_rng(2).standard_normal(jp.shape[1])
        y_kernel = np.asarray(jdk.dia_spmv_pallas(jp, jnp.asarray(x)))
        assert _relerr(dia_spmv_reference(tp, torch.from_numpy(x)), y_kernel) \
            <= TOL[np.float64]

    def test_matches_pallas_windowed_kernel(self, monkeypatch):
        # B8's windowed-x body (_spmv_window_kernel), forced as the JAX tests do
        jp, tp = _plans("stencil95")
        monkeypatch.setattr(jdk, "_X_VMEM_BUDGET", 1 << 16)
        x = np.random.default_rng(3).standard_normal(jp.shape[1])
        y_kernel = np.asarray(jdk.dia_spmv_pallas(jp, jnp.asarray(x)))
        assert _relerr(tp.spmv(torch.from_numpy(x)), y_kernel) <= TOL[np.float64]

    @pytest.mark.parametrize("name", ["stencil95", "banded"])
    def test_matches_pallas_layout_kernel(self, name):
        # B9 (dia_spmv_pallas_layout), decoded with from_layout, chained twice;
        # the port's operator runs in natural order
        jp, tp = _plans(name)
        x = np.random.default_rng(4).standard_normal(jp.shape[1])
        y1 = jdk.dia_spmv_pallas_layout(jp, jdk.to_layout(jp, jnp.asarray(x)))
        y2 = jdk.dia_spmv_pallas_layout(jp, y1)
        op = tdia.DiaOperator(tp)
        z1 = op(op.to_padded(torch.from_numpy(x)))
        z2 = op.from_padded(op(z1))
        assert _relerr(z1, np.asarray(jdk.from_layout(jp, y1))) <= TOL[np.float64]
        assert _relerr(z2, np.asarray(jdk.from_layout(jp, y2))) <= TOL[np.float64]

    @pytest.mark.parametrize("name", ["stencil95", "banded"])
    @pytest.mark.parametrize("kernel", ["interleaved", "il_stream"])
    def test_matches_pallas_interleaved_kernels(self, name, kernel):
        # B10 (dia_spmv_pallas_interleaved) and B11 (dia_spmv_pallas_il_stream)
        jp, tp = _plans(name)
        assert jdk.interleaved_ok(jp, jnp.float64)
        fn = (jdk.dia_spmv_pallas_interleaved if kernel == "interleaved"
              else jdk.dia_spmv_pallas_il_stream)
        x = np.random.default_rng(5).standard_normal(jp.shape[1])
        yI = fn(jp, jdk.to_interleaved(jp, jnp.asarray(x)), jdk.pack_vals_interleaved(jp))
        y = np.asarray(jdk.from_interleaved(jp, yI))
        assert _relerr(tdia.DiaOperator(tp)(torch.from_numpy(x)), y) <= TOL[np.float64]

    def test_matches_pallas_kernel_f32(self):
        jp, tp = _plans("stencil95", np.float32)
        x = np.random.default_rng(6).standard_normal(jp.shape[1]).astype(np.float32)
        y_ref = np.asarray(jdk.dia_spmv_pallas(jp, jnp.asarray(x)))
        assert _relerr(tp.spmv(torch.from_numpy(x)), y_ref) <= TOL[np.float32]


class TestOperatorAndCg:
    def test_operator_modes_and_identities(self):
        _, t = _pair(CASES["remainder"]())
        op = tdia.solver_operator(t, device="cpu")
        assert isinstance(op, tdia.DiaOperator) and op.mode == "reference"
        x = torch.from_numpy(np.random.default_rng(7).standard_normal(t.shape[1]))
        assert torch.equal(op.from_padded(op.to_padded(x)), x)
        assert torch.equal(op(x), op.dia.spmv(x))
        assert tdia.DiaOperator(op.dia).dia is op.dia
        with pytest.raises(TypeError):
            tdia.DiaOperator(tgen.fem_blocks(3, dof=2, return_bsr=True))

    def test_cg_matches_the_reference(self):
        # reference: cg over its DiaOperator (the interleaved Pallas kernel,
        # interpret mode) in its padded layout; port: natural order
        j, t = jgen.stencil_2d(95), tgen.stencil_2d(95)
        b = np.random.default_rng(8).standard_normal(j.shape[0])
        jop = jdia.DiaOperator(j)
        ref = jkrylov.cg(jop, jop.to_padded(b), tol=1e-10, maxiter=1000)
        op = ct.solver_operator(t, device="cpu")
        res = cg(op, op.to_padded(torch.from_numpy(b)), tol=1e-10, maxiter=1000)
        assert res.converged and bool(ref.converged)
        assert abs(res.iterations - int(ref.iterations)) <= 1
        xr = np.asarray(jop.from_padded(ref.x))
        x = op.from_padded(res.x).numpy()
        assert np.linalg.norm(x - xr) / np.linalg.norm(xr) <= 1e-9
        assert np.linalg.norm(b - tconv.to_scipy(t) @ x) / np.linalg.norm(b) <= 1e-9

    def test_slice_end_to_end_on_cpu(self):
        # generator -> CSR -> spmv / spmm (public entries) -> plan -> PCG
        t = ct.generate.stencil_2d(40)
        s = tconv.to_scipy(t)
        x = torch.from_numpy(np.random.default_rng(9).standard_normal(t.shape[1]))
        assert _relerr(ct.spmv(t, x, method="dia"), s @ x.numpy()) <= 1e-12
        assert _relerr(ct.spmm(t, x[:, None].repeat(1, 3), method="dia"),
                       s @ x.numpy()[:, None].repeat(3, 1)) <= 1e-12
        res = cg(ct.solver_operator(t, device="cpu"), x, tol=1e-8,
                 M=jacobi(t, device="cpu"))
        assert res.converged
        assert np.linalg.norm(x.numpy() - s @ res.x.numpy()) / x.norm().item() <= 1e-7


class TestDeviceDefault:
    def test_host_matrices_plan_on_the_card_or_raise(self, monkeypatch):
        # with no CUDA device, nothing falls back to the CPU unless asked
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        csr = tgen.stencil_2d(6)
        bsr = tgen.fem_blocks(3, dof=2, return_bsr=True)
        for build in (lambda: ct.bdia_plan(bsr), lambda: ct.dia_plan(csr),
                      lambda: ct.BdiaOperator(bsr), lambda: ct.DiaOperator(csr),
                      lambda: ct.solver_operator(csr), lambda: jacobi(csr)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build()
        # asked for, or given tensors, they stay where they are told
        assert ct.dia_plan(csr, device="cpu").device.type == "cpu"
        assert ct.dia_plan(csr.to("cpu")).device.type == "cpu"
        assert ct.bdia_plan(bsr.to("cpu")).device.type == "cpu"
        assert ct.DiaOperator(csr.to("cpu")).mode == "reference"


class TestDispatch:
    def test_cpu_csr_takes_the_gather_route(self, monkeypatch):
        plans = PlanCache()
        monkeypatch.setattr(spmv_mod, "default_plan_cache", plans)
        j, t = _pair(CASES["banded"]())
        x = np.random.default_rng(10).standard_normal(j.shape[1])
        before = dia_spmv.launches
        y = spmv(t.to("cpu"), torch.from_numpy(x))
        assert len(plans._plans) == 0 and dia_spmv.launches == before
        assert _relerr(y, np.asarray(jax_spmv(j, x))) <= TOL[np.float64]

    @pytest.mark.parametrize("transpose", [False, True])
    def test_method_dia_and_plan_operand_match_the_reference(self, transpose):
        j, t = _pair(CASES["rect_tall"]())
        jp, tp = jdia.dia_plan(j), tdia.dia_plan(t, device="cpu")
        x = np.random.default_rng(11).standard_normal(j.shape[0] if transpose else j.shape[1])
        y_ref = np.asarray(jax_spmv(j, x, transpose=transpose, method="dia"))
        xt = torch.from_numpy(x)
        for y in (spmv(t, xt, transpose=transpose, method="dia"),
                  spmv(tp, xt, transpose=transpose), spmv(tp, xt, transpose=transpose,
                                                          method="xla")):
            assert _relerr(y, y_ref) <= TOL[np.float64]
        assert _relerr(y_ref, np.asarray(jax_spmv(jp, x, transpose=transpose))) <= 1e-12

    def test_transposed(self):
        jp, tp = _plans("asym_down")
        _same_plan(jax_transposed(jp), transposed(tp))

    def test_plan_cache_holds_csr_plans_and_rebuilds_after_an_in_place_change(self):
        j, t = _pair(CASES["remainder"]())
        t = t.to("cpu")
        plans = PlanCache()
        p = plans.get(t)
        assert isinstance(p, tdia.DiaMatrix) and plans.get(t) is p
        _same_plan(jdia.dia_plan(j), p)
        t.data.mul_(2.0)  # the plan holds a copy of the old values
        p2 = plans.get(t)
        assert p2 is not p and plans.get(t) is p2
        assert torch.equal(p2.vals, 2.0 * p.vals) and torch.equal(p2.rem_data, 2.0 * p.rem_data)

    def test_plan_cache_gate(self):
        plans = PlanCache()
        # unstructured: the traffic estimate declines, no plan is built
        u = tgen.power_law(400, seed=3).to("cpu")
        assert plans.get(u) is None
        # more than 10 % of the entries in the remainder
        s = tconv.to_scipy(tgen.banded(3000, 1, seed=1)) + \
            tconv.to_scipy(tgen.banded(3000, 40, density=0.02, seed=2))
        t = tconv.from_scipy(s.tocsr()).to("cpu")
        assert tdia.estimate_dia_traffic(t) is not None
        assert tdia.dia_plan(t).rem_data.shape[0] > 0.1 * t.nnz
        assert plans.get(t) is None and len(plans._plans) == 2
