"""Parity of the port's bf16 value path with the JAX package, on the CPU (the
kernels on the card: tests/test_torch_gpu.py).

The same matrices, made from a numpy seed, go to both packages with bf16
values.  The port plans a bf16 matrix from the exact f32 of its values and
casts the packs back, so its packs must equal the reference's bit for bit
(compared as uint16).  The reference's XLA formulations run as they are, its
Pallas kernels in interpret mode, as tests/test_bdia.py and
tests/test_pallas_kernels.py run them.

Tolerances: against the reference, normwise ≤ 1e-6 with an f32 output (both
sum the same bf16 products in f32, in other orders) and ≤ 1 bf16 ulp per
element with a bf16 output (one rounding of nearly the same f32 sum);
against the original f32 matrix, the reference's own bf16 tolerances (rtol
0.05, atol 0.1 for SpMV, 2e-2·max|ref| for the bf16 chain).
"""

import dataclasses

import jax  # noqa: F401  (kept on the CPU with x64 by conftest)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cask_tpu.formats.convert as jconv
import cask_tpu.ops.bdia as jbdia
import cask_tpu.ops.dia as jdia
import cask_tpu.ops.pallas.bdia_slab as jslab
import cask_tpu.solvers.krylov as jkrylov
import cask_tpu_torch as ct
import cask_tpu_torch.formats.convert as tconv
import cask_tpu_torch.formats.generate as tgen
import cask_tpu_torch.ops.bdia as tbdia
import cask_tpu_torch.ops.bdia_slab as tslab
import cask_tpu_torch.ops.dia as tdia
from cask_tpu.ops.pallas import dia_kernels as jdk
from cask_tpu.ops.pallas.bdia_kernels import bdia_spmm_pallas_ring, bdia_spmv_pallas_fused
from cask_tpu.ops.spmm import spmm as jax_spmm
from cask_tpu_torch import interop
from cask_tpu_torch.formats.matrix import host, to_device, torch_dtype, value_dtype
from cask_tpu_torch.ops.kernels import bdia_kernels as bk
from cask_tpu_torch.ops.kernels.bdia_kernels import (bdia_spmm_ring, bdia_spmm_ring_reference,
                                                     bdia_spmv, check_out_dtype, check_types,
                                                     kernel_types_ok)
from cask_tpu_torch.ops.kernels.bdia_slab_kernels import (bdia_spmm_slab,
                                                          bdia_spmm_slab_reference)
from cask_tpu_torch.ops.kernels.dia_kernels import dia_spmm, dia_spmm_reference, dia_spmv
from cask_tpu_torch.ops.spmv import PlanCache

BF16, F32 = torch.bfloat16, torch.float32
TOL_F32_OUT = 1e-6


def _relerr(y, ref):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(y - ref) / np.linalg.norm(ref)


def _f64(y):
    """A port or reference result (any float type) as f64 numpy."""
    if isinstance(y, torch.Tensor):
        return y.double().numpy()
    return np.asarray(jnp.asarray(y, jnp.float64))


def _bits(a) -> np.ndarray:
    """A bf16 array (torch or numpy) as its uint16 bits."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == BF16
        return a.view(torch.int16).numpy().view(np.uint16)
    a = np.asarray(a)
    assert a.dtype.name == "bfloat16"
    return a.view(np.uint16)


def _within_one_ulp(y: torch.Tensor, ref) -> bool:
    """Every element of bf16 ``y`` within one bf16 ulp of ``ref`` (f64)."""
    ref = np.asarray(ref, np.float64)
    ulp = np.ldexp(1.0, np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))).astype(int) - 7)
    return bool(np.all(np.abs(y.double().numpy() - ref) <= ulp * (1 + 1e-9)))


def _remainder_scipy(seed=16):
    """fem_blocks(6, dof=4) plus scattered 4×4 blocks that spill to the COO
    remainder (tests/test_bdia.py::test_fused_with_remainder)."""
    s = tconv.to_scipy(tgen.fem_blocks(6, dof=4, dtype=np.float64)).tolil()
    rng = np.random.default_rng(seed)
    for _ in range(6):
        bi, bj = int(rng.integers(0, 20)), int(rng.integers(0, 20))
        s[bi * 4 : bi * 4 + 4, bj * 4 : bj * 4 + 4] = rng.standard_normal((4, 4))
    return s.tocsr()


BSR_CASES = {  # name -> (scipy f64 matrix, blocksize)
    "fem6": lambda: (tconv.to_scipy(tgen.fem_blocks(6, dof=4)), 4),
    "fem10": lambda: (tconv.to_scipy(tgen.fem_blocks(10, dof=4, seed=3)), 4),
    "fem8_dof2": lambda: (tconv.to_scipy(tgen.fem_blocks(8, dof=2, seed=5)), 2),
    "remainder": lambda: (_remainder_scipy(), 4),
}
CSR_CASES = {  # name -> scipy f64 matrix
    "stencil_2d(20)": lambda: tconv.to_scipy(tgen.stencil_2d(20)),
    "stencil_2d(95)": lambda: tconv.to_scipy(tgen.stencil_2d(95)),
    "banded+scatter": lambda: (tconv.to_scipy(tgen.banded(3000, 2, seed=1))
                               + tconv.to_scipy(tgen.random_uniform(3000, density=2e-4,
                                                                    seed=2))).tocsr(),
}


def _bf16_scipy(s):
    """The matrix with its values rounded to bf16 (as f64 scipy), and those
    bf16 values as the reference takes them."""
    vals = np.asarray(s.data, np.float32).astype(jnp.bfloat16)
    out = s.copy()
    out.data = vals.astype(np.float64)
    return out, vals


def _bsr_pair(name, torch_values=True):
    """(reference BSR, port BSR on the CPU, bf16-rounded scipy) with bf16
    values: the port's as a bf16 tensor, or (``torch_values=False``) as the
    reference's numpy bf16 array, which it must take without ml_dtypes."""
    s, b = BSR_CASES[name]()
    sb, _ = _bf16_scipy(s)
    jb = jconv.csr_to_bsr(jconv.from_scipy(sb), (b, b))
    jb = dataclasses.replace(jb, data=np.asarray(jb.data).astype(jnp.bfloat16))
    tb = tconv.csr_to_bsr(tconv.from_scipy(sb), (b, b))
    data = np.asarray(jb.data)
    tb = dataclasses.replace(tb, data=to_device(data, "cpu") if torch_values else data)
    return jb, tb, sb


def _csr_pair(name):
    s = CSR_CASES[name]()
    sb, vals = _bf16_scipy(s)
    jc = dataclasses.replace(jconv.from_scipy(sb), data=vals)
    tc = dataclasses.replace(tconv.from_scipy(sb), data=to_device(vals, "cpu"))
    return jc, tc, sb


def _same_bdia(jp, tp):
    assert tp.dtype == BF16 and tp.block_offsets == tuple(jp.block_offsets)
    assert tp.ts == jp.ts and tp.shape == tuple(jp.shape)
    assert np.array_equal(_bits(tp.vals), _bits(jp.vals))
    assert np.array_equal(_bits(tp.rem_data), _bits(jp.rem_data))
    assert np.array_equal(tp.rem_row.numpy(), np.asarray(jp.rem_row))
    assert np.array_equal(tp.rem_col.numpy(), np.asarray(jp.rem_col))


def _same_dia(jp, tp):
    assert tp.dtype == BF16 and tp.offsets == tuple(jp.offsets) and tp.shape == tuple(jp.shape)
    assert np.array_equal(_bits(tp.vals), _bits(jp.vals))
    assert np.array_equal(_bits(tp.rem_data), _bits(jp.rem_data))
    assert np.array_equal(tp.rem_row.numpy(), np.asarray(jp.rem_row))
    assert np.array_equal(tp.rem_col.numpy(), np.asarray(jp.rem_col))


# -- the host arrays ---------------------------------------------------------


class TestHostArrays:
    def test_bf16_widens_exactly_and_crosses_as_bits(self):
        vals = np.random.default_rng(0).standard_normal(1000).astype(jnp.bfloat16)
        t = to_device(vals, "cpu")
        assert t.dtype == BF16 and np.array_equal(_bits(t), vals.view(np.uint16))
        for a in (vals, t):
            h = host(a)
            assert h.dtype == np.float32 and np.array_equal(h, vals.astype(np.float32))
            assert value_dtype(a) == BF16
        assert torch_dtype(np.dtype(jnp.bfloat16)) == BF16 and torch_dtype("bfloat16") == BF16
        assert to_device(vals.astype(np.float32), "cpu", BF16).equal(t)


# -- planning: bit-equal packs ------------------------------------------------


class TestPlanning:
    @pytest.mark.parametrize("name", list(BSR_CASES))
    @pytest.mark.parametrize("torch_values", [True, False])
    def test_bdia_plan_packs_equal_the_reference(self, name, torch_values):
        jb, tb, _ = _bsr_pair(name, torch_values)
        b = jb.blocksize
        jp = jbdia.bdia_plan(jb, b)
        tp = tbdia.bdia_plan(tb, b, device="cpu")
        _same_bdia(jp, tp)
        # astype of the f32 plan packs the same bits
        tp32 = tbdia.bdia_plan(tb.astype(np.float32) if not torch_values else
                               dataclasses.replace(tb, data=tb.data.float()), b, device="cpu")
        assert np.array_equal(_bits(tp32.astype(BF16).vals), _bits(jp.vals))

    @pytest.mark.parametrize("name", list(BSR_CASES))
    def test_scalar_dia_and_transpose_equal_the_reference(self, name):
        jb, tb, _ = _bsr_pair(name)
        jp = jbdia.bdia_plan(jb, jb.blocksize)
        tp = tbdia.bdia_plan(tb, tb.blocksize, device="cpu")
        _same_dia(jbdia.bdia_scalar_dia(jp), PlanCache().get(tp))
        _same_bdia(jbdia.transpose_plan(jp), tbdia.transpose_plan(tp))
        _same_bdia(jbdia.transpose_plan(jp), ct.transposed(tp))

    @pytest.mark.parametrize("name", list(CSR_CASES))
    def test_dia_plan_and_transpose_equal_the_reference(self, name):
        jc, tc, _ = _csr_pair(name)
        jp = jdia.dia_plan(jc, with_vals_t=True)
        tp = tdia.dia_plan(tc, with_vals_t=True, device="cpu")
        _same_dia(jp, tp)
        assert np.array_equal(_bits(tp.vals_t), _bits(jp.vals_t))
        _same_dia(jdia.transpose_plan(jp), tdia.transpose_plan(tp))

    @pytest.mark.parametrize("name,g", [("fem6", 4), ("fem10", 8), ("fem8_dof2", 16),
                                        ("remainder", 4)])
    def test_slab_plans_equal_the_reference(self, name, g):
        jb, tb, _ = _bsr_pair(name)
        jp = jbdia.bdia_plan(jb, jb.blocksize)
        tp = tbdia.bdia_plan(tb, tb.blocksize, device="cpu")
        # a bf16 plan's slabs, and an f32 plan's slabs stored as bf16
        jp32 = jp.astype(jnp.float32)
        tp32 = tp.astype(F32)
        for jsl, tsl in ((jslab.bdia_slab_plan(jp, g), tslab.bdia_slab_plan(tp, g)),
                         (jslab.bdia_slab_plan(jp32, g, dtype=jnp.bfloat16),
                          tslab.bdia_slab_plan(tp32, g, dtype=np.dtype(jnp.bfloat16)))):
            assert tsl.dtype == BF16 and tsl.far_offsets == tuple(jsl.far_offsets)
            assert np.array_equal(_bits(tsl.slabs), _bits(jsl.slabs))

    def test_slab_auto_plan_sizes_by_bf16_bytes(self, monkeypatch):
        # a cap between the bf16 and the f32 slabs of g = 16: only bf16 keeps g = 16
        _, tb, _ = _bsr_pair("fem10")
        tp = tbdia.bdia_plan(tb, tb.blocksize, device="cpu")
        sl32 = tslab.slab_auto_plan(tp.astype(F32))
        nbytes = sl32.slabs.numel() * 4
        monkeypatch.setattr(tslab, "SLAB_MAX_BYTES", nbytes - 1)
        assert tslab.slab_auto_plan(tp).g == sl32.g
        assert tslab.slab_auto_plan(tp.astype(F32)).g < sl32.g

    def test_interop_takes_the_reference_bf16_arrays(self):
        jb, tb, _ = _bsr_pair("remainder")
        jp = jbdia.bdia_plan(jb, jb.blocksize)
        ip = interop.bdia_from_arrays(np.asarray(jp.vals), np.asarray(jp.rem_data),
                                      np.asarray(jp.rem_row), np.asarray(jp.rem_col),
                                      block_offsets=jp.block_offsets, shape=jp.shape,
                                      blocksize=jp.blocksize, ts=jp.ts, device="cpu")
        _same_bdia(jp, ip)
        jd = jdia.dia_plan(_csr_pair("banded+scatter")[0], with_vals_t=True)
        idp = interop.dia_from_arrays(np.asarray(jd.vals), np.asarray(jd.rem_data),
                                      np.asarray(jd.rem_row), np.asarray(jd.rem_col),
                                      jd.offsets, jd.shape, vals_t=np.asarray(jd.vals_t),
                                      device="cpu")
        _same_dia(jd, idp)
        jsl = jslab.bdia_slab_plan(jp, 4)
        isl = interop.slabs_from_arrays(np.asarray(jsl.slabs), g=jsl.g, blocksize=jsl.blocksize,
                                        shape=jsl.shape, far_offsets=jsl.far_offsets,
                                        nb_pad=jsl.nb_pad, device="cpu")
        assert isl.dtype == BF16 and np.array_equal(_bits(isl.slabs), _bits(jsl.slabs))
        ic = interop.csr_from_arrays(np.asarray(jd.vals)[0], np.arange(jd.m_pad),
                                     np.arange(jd.m_pad + 1), (jd.m_pad, jd.m_pad),
                                     device="cpu")
        assert ic.data.dtype == BF16


# -- the twins against the reference --------------------------------------------


def _x(n, seed, dtype, k=None):
    shape = (n,) if k is None else (n, k)
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return x if dtype == F32 else x.astype(jnp.bfloat16)


def _torch(x):
    return to_device(x, "cpu")


class TestTwins:
    @pytest.mark.parametrize("name", list(BSR_CASES))
    @pytest.mark.parametrize("xdt", [F32, BF16])
    def test_bdia_spmv_equals_the_reference_xla(self, name, xdt):
        jb, tb, sb = _bsr_pair(name)
        jp = jbdia.bdia_plan(jb, jb.blocksize)
        tp = tbdia.bdia_plan(tb, tb.blocksize, device="cpu")
        x = _x(sb.shape[1], 1, xdt)
        y = tp.spmv(_torch(x))
        ref = jp._spmv_xla(jnp.asarray(x))
        assert y.dtype == F32 and ref.dtype == jnp.float32
        if not tp.rem_data.shape[0] or xdt == F32:  # the reference sums a bf16
            assert _relerr(y, _f64(ref)) <= TOL_F32_OUT  # remainder in bf16
        # against the f32 matrix, the reference's bf16 tolerance (tests/test_bdia.py:133)
        s, _ = BSR_CASES[name]()
        np.testing.assert_allclose(y.numpy(), s @ x.astype(np.float64), rtol=0.05, atol=0.1)

    @pytest.mark.parametrize("xdt", [F32, BF16])
    def test_bdia_spmv_equals_the_reference_kernel(self, xdt):
        jb, tb, sb = _bsr_pair("fem6")
        jp = jbdia.bdia_plan(jb, jb.blocksize)
        tp = tbdia.bdia_plan(tb, tb.blocksize, device="cpu")
        x = _x(sb.shape[1], 12, xdt)
        ref = bdia_spmv_pallas_fused(jp, jnp.asarray(x))
        y = bdia_spmv(tp, _torch(x))
        assert y.dtype == F32 and ref.dtype == jnp.float32
        assert _relerr(y, _f64(ref)) <= TOL_F32_OUT

    @pytest.mark.parametrize("name", list(CSR_CASES))
    def test_dia_spmv_and_spmm_equal_the_reference_xla(self, name):
        jc, tc, sb = _csr_pair(name)
        jp, tp = jdia.dia_plan(jc), tdia.dia_plan(tc, device="cpu")
        x = _x(sb.shape[1], 3, F32)
        y = tp.spmv(_torch(x))
        assert y.dtype == F32 and _relerr(y, _f64(jp._spmv_xla(jnp.asarray(x)))) <= TOL_F32_OUT
        for k in (12, 65):
            X = _x(sb.shape[1], 4, F32, k)
            Y = tp.spmm(_torch(X))
            assert Y.dtype == F32
            assert _relerr(Y, _f64(jp._spmm_xla(jnp.asarray(X)))) <= TOL_F32_OUT

    @pytest.mark.parametrize("out", [None, BF16])
    def test_dia_spmm_bf16_chain_equals_the_reference_kernel(self, out):
        # the reference's fully-bf16 ring (tests/test_pallas_kernels.py:240-262)
        jc, tc, sb = _csr_pair("stencil_2d(95)")
        jp, tp = jdia.dia_plan(jc), tdia.dia_plan(tc, device="cpu")
        X = _x(sb.shape[1], 3, BF16, 128)
        xp = jdk.to_spmm_ring(jp, jnp.asarray(X))
        yp = jdk.dia_spmm_pallas_ring_padded(jp, xp, out_dtype=None if out is None
                                             else jnp.bfloat16)
        ref = jdk.from_spmm_ring(jp, yp, 128)
        Y = dia_spmm(tp, _torch(X), out_dtype=out)
        assert Y.dtype == (F32 if out is None else BF16)
        assert ref.dtype == (jnp.float32 if out is None else jnp.bfloat16)
        twin32 = dia_spmm_reference(tp, _torch(X))
        if out is None:
            assert _relerr(Y, _f64(ref)) <= TOL_F32_OUT
        else:
            assert _within_one_ulp(Y, twin32.double().numpy())
            assert _within_one_ulp(Y, _f64(ref))
        s = CSR_CASES["stencil_2d(95)"]()
        ref32 = s.astype(np.float32) @ X.astype(np.float32)
        assert np.abs(Y.float().numpy() - ref32).max() < 2e-2 * np.abs(ref32).max()

    @pytest.mark.parametrize("xdt,out", [(BF16, None), (BF16, BF16), (F32, None)])
    def test_ring_equals_the_reference_kernel(self, xdt, out):
        # tests/test_bdia.py:333-349: bf16 plan, bf16 X, f32 out and the bf16 chain
        jb, tb, sb = _bsr_pair("fem10")
        jp = jbdia.bdia_plan(jb, jb.blocksize)
        tp = tbdia.bdia_plan(tb, tb.blocksize, device="cpu")
        X = _x(sb.shape[1], 22, xdt, 128)
        ref = bdia_spmm_pallas_ring(jp, jnp.asarray(X),
                                    out_dtype=None if out is None else jnp.bfloat16)
        Y = bdia_spmm_ring(tp, _torch(X), out_dtype=out)
        assert Y.dtype == (F32 if out is None else BF16)
        if out is None:
            assert _relerr(Y, _f64(ref)) <= TOL_F32_OUT
        else:
            assert ref.dtype == jnp.bfloat16
            assert _within_one_ulp(Y, bdia_spmm_ring_reference(tp, _torch(X)).double().numpy())
            assert _within_one_ulp(Y, _f64(ref))
        s, _ = BSR_CASES["fem10"]()
        np.testing.assert_allclose(Y.float().numpy(), s @ X.astype(np.float64), rtol=0.05,
                                   atol=0.2)

    @pytest.mark.parametrize("k", [32, 128])
    def test_spmm_on_a_bf16_plan_equals_the_reference(self, k):
        # the reference's CPU route at both k: scalar DIA in XLA; the port's at
        # k = 128: the slab twin.  Both f32, the same bf16 products.
        jb, tb, sb = _bsr_pair("fem10")
        jp = jbdia.bdia_plan(jb, jb.blocksize)
        tp = tbdia.bdia_plan(tb, tb.blocksize, device="cpu")
        X = _x(sb.shape[1], 5, F32, k)
        ref = jax_spmm(jp, jnp.asarray(X))
        Y = ct.spmm(tp, _torch(X))
        assert Y.dtype == F32 and ref.dtype == jnp.float32
        assert _relerr(Y, _f64(ref)) <= TOL_F32_OUT
        assert _relerr(Y, sb @ X.astype(np.float64)) <= TOL_F32_OUT

    @pytest.mark.parametrize("xdt,out", [(F32, None), (BF16, BF16)])
    def test_slab_equals_the_reference_kernel(self, xdt, out):
        jb, tb, sb = _bsr_pair("fem6")
        jp = jbdia.bdia_plan(jb, jb.blocksize)
        tp = tbdia.bdia_plan(tb, tb.blocksize, device="cpu")
        jsl, tsl = jslab.bdia_slab_plan(jp, 4), tslab.bdia_slab_plan(tp, 4)
        X = _x(sb.shape[1], 6, xdt, 128)
        ref = jslab.bdia_spmm_pallas_slab(jsl, jnp.asarray(X), precision="highest",
                                          out_dtype=None if out is None else jnp.bfloat16)
        Y = bdia_spmm_slab(tsl, _torch(X), out_dtype=out)
        assert Y.dtype == (F32 if out is None else BF16)
        if out is None:
            assert _relerr(Y, _f64(ref)) <= TOL_F32_OUT
        else:
            assert _within_one_ulp(Y, bdia_spmm_slab_reference(tsl, _torch(X)).double().numpy())
            assert _within_one_ulp(Y, _f64(ref))


# -- dispatch --------------------------------------------------------------------


class TestDispatch:
    def test_spmm_at_k32_returns_f32(self):
        _, tb, sb = _bsr_pair("fem6")
        tp = tbdia.bdia_plan(tb, tb.blocksize, device="cpu")
        Y = ct.spmm(tp, torch.ones((sb.shape[1], 32)))
        assert Y.dtype == F32 and PlanCache().get(tp).dtype == BF16

    def test_the_auto_route_plans_bf16(self, monkeypatch):
        # the cached plan of a bf16 BSR and CSR is bf16, and the route takes it
        # for an f32 or bf16 operand (an operand that says it is on the card)
        import importlib
        import types

        spmv_mod = importlib.import_module("cask_tpu_torch.ops.spmv")  # the module
        _, tb, _ = _bsr_pair("fem6")
        _, tc, _ = _csr_pair("stencil_2d(20)")
        plans = PlanCache()
        monkeypatch.setattr(spmv_mod, "default_plan_cache", plans)
        for a in (tb, tc):
            for xdt in (F32, BF16):
                x = types.SimpleNamespace(is_cuda=True, device=torch.device("cpu"), dtype=xdt)
                p = spmv_mod.cached_plan(a, x)
                assert p is plans.get(a) and p.dtype == BF16
            x = types.SimpleNamespace(is_cuda=True, device=torch.device("cpu"),
                                      dtype=torch.float64)
            assert spmv_mod.cached_plan(a, x) is None  # no kernel: the gather formulation
        with pytest.raises(TypeError):
            check_types(BF16, torch.float64)

    @pytest.mark.parametrize("vdt,xdt", [(BF16, BF16), (BF16, F32), (F32, BF16)])
    def test_output_types_follow_the_policy(self, vdt, xdt):
        _, tb, sb = _bsr_pair("fem6")
        tp = tbdia.bdia_plan(tb, tb.blocksize, device="cpu").astype(vdt)
        _, tc, sc = _csr_pair("stencil_2d(20)")
        dp = tdia.dia_plan(tc, device="cpu").astype(vdt)
        sl = tslab.slab_auto_plan(tp)
        x = torch.ones(sb.shape[1], dtype=xdt)
        X = torch.ones((sb.shape[1], 12), dtype=xdt)
        Xd = torch.ones((sc.shape[1], 12), dtype=xdt)
        assert kernel_types_ok(vdt, xdt)
        assert bdia_spmv(tp, x).dtype == F32
        assert dia_spmv(dp, torch.ones(sc.shape[1], dtype=xdt)).dtype == F32
        for out in (None, F32, BF16):
            want = F32 if out is None else out
            check_out_dtype(vdt, xdt, want)
            assert bdia_spmm_ring(tp, X, out_dtype=out).dtype == want
            assert bdia_spmm_slab(sl, X, out_dtype=out).dtype == want
            assert dia_spmm(dp, Xd, out_dtype=out).dtype == want
            assert ct.spmm(sl, X, accum_dtype=out).dtype == want

    @pytest.mark.parametrize("vdt,xdt,out", [
        (torch.float16, torch.float64, None), (BF16, torch.float16, None),
        (torch.float64, torch.float16, None), (BF16, torch.float64, None),
        (torch.float64, BF16, None),
        (BF16, F32, torch.float64), (BF16, BF16, torch.float16), (F32, F32, BF16)])
    def test_other_combinations_raise(self, vdt, xdt, out):
        want = bk.result_dtype(vdt, xdt, out)
        with pytest.raises(TypeError, match=str(vdt)):
            check_out_dtype(vdt, xdt, want)
        if out is None:
            assert not kernel_types_ok(vdt, xdt)
            with pytest.raises(TypeError, match=str(xdt)):
                check_types(vdt, xdt)

    def test_kernel_gates_take_bf16_and_f16(self):
        _, tb, _ = _bsr_pair("fem6")
        tp = tbdia.bdia_plan(tb, tb.blocksize, device="cpu")
        assert bk.bdia_kernel_ok(tp) and bk.bdia_kernel_ok(tp.astype(torch.float16))
        assert tbdia.BdiaOperator(tp).mode == "reference"


# -- CG over bf16 operators ------------------------------------------------------


def _spd(s):
    from cask_tpu_torch.formats.generate import _diag_shift

    return tconv.to_scipy(_diag_shift(tconv.from_scipy((s + s.T).tocsr()), 1.1))


def test_cg_over_a_bf16_bdia_operator_matches_the_reference():
    s = _spd(tconv.to_scipy(tgen.fem_blocks(8, dof=4)))
    sb, vals = _bf16_scipy(s)
    jb = jconv.csr_to_bsr(dataclasses.replace(jconv.from_scipy(sb), data=vals), (4, 4))
    tb = tconv.csr_to_bsr(tconv.from_scipy(sb), (4, 4))
    tb = dataclasses.replace(tb, data=to_device(np.asarray(jb.data), "cpu"))
    jop = jbdia.BdiaOperator(jbdia.bdia_plan(jb, (4, 4)))
    top = tbdia.BdiaOperator(tbdia.bdia_plan(tb, (4, 4), device="cpu"))
    assert top.bdia.dtype == BF16 and jop.bdia.vals.dtype == jnp.bfloat16
    b = np.random.default_rng(7).standard_normal(sb.shape[0]).astype(np.float32)
    ref = jkrylov.cg(jop, jnp.asarray(b), tol=1e-5, maxiter=300)
    res = ct.solvers.cg(top, torch.from_numpy(b), tol=1e-5, maxiter=300)
    assert res.converged and bool(ref.converged) and res.x.dtype == F32
    assert abs(res.iterations - int(ref.iterations)) <= 1
    # the solution of the bf16-rounded matrix
    assert _relerr(sb @ res.x.double().numpy(), b) <= 2e-5


def test_cg_over_a_bf16_solver_operator_matches_the_reference():
    s = tconv.to_scipy(tgen.stencil_2d(40))
    s = (s + 8.0 * __import__("scipy.sparse", fromlist=["identity"]).identity(s.shape[0])).tocsr()
    sb, vals = _bf16_scipy(s)
    jc = dataclasses.replace(jconv.from_scipy(sb), data=vals)
    tc = dataclasses.replace(tconv.from_scipy(sb), data=to_device(vals, "cpu"))
    jop = jdia.DiaOperator(jc, method="xla")
    top = ct.solver_operator(tc, device="cpu")
    assert top.dia.dtype == BF16 and top.mode == "reference"
    b = np.random.default_rng(8).standard_normal(sb.shape[0]).astype(np.float32)
    ref = jkrylov.cg(jop, jnp.asarray(b), tol=1e-5, maxiter=300)
    res = ct.solvers.cg(top, top.to_padded(torch.from_numpy(b)), tol=1e-5, maxiter=300)
    assert res.converged and bool(ref.converged)
    assert abs(res.iterations - int(ref.iterations)) <= 1
    assert _relerr(sb @ res.x.double().numpy(), b) <= 2e-5
