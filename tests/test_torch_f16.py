"""Parity of the port's f16 value path of the block and banded kernels (BDIA
SpMV B1-B3, BDIA ring B4, slab B5/B6, DIA SpMV B8-B11 and SpMM B12-B15) with
the JAX package, on the CPU (the kernels on the card: tests/test_torch_gpu.py).

The same matrices, made from a numpy seed, go to both packages with f16
values: the pin's ``fem_blocks(16, dof=4)`` and ``stencil_2d(95)``, a BSR
with a COO remainder, one whose FEM values round to f16 subnormals, and a
band with scattered entries.  The port plans an f16 matrix from its f16
values, so its packs must equal the reference's bit for bit (compared as
uint16).  The reference's Pallas kernels run in interpret mode.

Type policy (the reference's): values and operand each f16 or f32, at least
one f16; the output f16 for f16 · f16, f32 when either side is f32; the SpMM
kernels also take ``out_dtype`` f32 or f16.  The port sums in f32 everywhere.

Tolerances.  The reference sums f16 · f16 in f16 in B1-B3, B8-B12 and B14,
so its result there is less exact than the port's f32 sum: the port is held
to one f16 ulp of its twin's f32 sum, and to an error against scipy f64 of
the f16-rounded inputs no larger than the reference's own plus 1e-3
normwise.  Where the reference sums in f32 (B4, B5/B6, B13), an f16 output
is held to it at 2e-3 normwise and an f32 output at 1e-5.  B15 rounds its
near band to bf16 (``dia_kernels.py:1290-1302``): there only the scipy bound
holds.  An f16 ``y`` plus an f16 remainder rounds twice, as the reference's:
≤ 1e-3 normwise against scipy.
"""

import dataclasses

import jax  # noqa: F401  (kept on the CPU with x64 by conftest)
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
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
from cask_tpu.ops.pallas import bdia_kernels as jbk
from cask_tpu.ops.pallas import dia_kernels as jdk
from cask_tpu_torch.formats.matrix import to_device
from cask_tpu_torch.ops.kernels import bdia_kernels as bk
from cask_tpu_torch.ops.kernels.bdia_kernels import (bdia_spmm_ring, bdia_spmm_ring_reference,
                                                     bdia_spmv, bdia_spmv_reference)
from cask_tpu_torch.ops.kernels.bdia_slab_kernels import (bdia_spmm_slab,
                                                          bdia_spmm_slab_padded,
                                                          bdia_spmm_slab_reference)
from cask_tpu_torch.ops.kernels.dia_kernels import (dia_spmm, dia_spmm_reference, dia_spmv,
                                                    dia_spmv_reference)
from cask_tpu_torch.ops.spmv import PlanCache

F16, F32, F64, BF16 = torch.float16, torch.float32, torch.float64, torch.bfloat16
COMBOS = [(F16, F16), (F16, F32), (F32, F16)]  # values, operand: at least one f16
COMBO_IDS = ["f16-f16", "f16-f32", "f32-f16"]
TOL_F32_OUT = 1e-5  # f32 out: the same products summed in f32, in another order
TOL_REF = 2e-3  # f16 out, the twin against a reference that sums in f32
TOL_OVER_REF = 1e-3  # the port's error against scipy, beyond the reference's own
TOL_F16_COMPOSED = 1e-3  # f16 y plus an f16 remainder: two roundings
K_NARROW, K_WIDE = 32, 128


def _relerr(y, ref):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(y - ref) / np.linalg.norm(ref)


def _f64(y):
    """A port or reference result (any float type) as f64 numpy."""
    if isinstance(y, torch.Tensor):
        return y.double().numpy()
    return np.asarray(jnp.asarray(y, jnp.float64))


def _bits(a) -> np.ndarray:
    """An f16 array (torch or numpy) as its uint16 bits."""
    if isinstance(a, torch.Tensor):
        assert a.dtype == F16
        return a.view(torch.int16).numpy().view(np.uint16)
    a = np.asarray(a)
    assert a.dtype == np.float16
    return a.view(np.uint16)


def _ulps(y: torch.Tensor, ref) -> float:
    """The largest distance of f16 ``y`` from f64 ``ref``, in f16 ulps at
    each element, beyond 2^-20 of the largest |ref| (the f32 rounding by
    which two f32 sums of the same products may differ)."""
    ref = np.asarray(ref, np.float64)
    e = np.maximum(np.floor(np.log2(np.maximum(np.abs(ref), 1e-300))), -14)
    ulp = np.ldexp(1.0, e.astype(int) - 10)
    excess = np.maximum(np.abs(y.double().numpy() - ref) - 2.0 ** -20 * np.abs(ref).max(), 0)
    return float((excess / ulp).max())


def _f16_scipy(s):
    """The matrix with its values rounded to f16 (as f64 scipy), and those
    f16 values."""
    vals = np.asarray(s.data, np.float32).astype(np.float16)
    out = s.astype(np.float64)
    out.data = vals.astype(np.float64)
    return out, vals


def _remainder_scipy(seed=16):
    """fem_blocks(6, dof=4) plus scattered 4×4 blocks that spill to the COO
    remainder (tests/test_bdia.py::test_fused_with_remainder)."""
    s = tconv.to_scipy(tgen.fem_blocks(6, dof=4, dtype=np.float64)).tolil()
    rng = np.random.default_rng(seed)
    for _ in range(6):
        bi, bj = int(rng.integers(0, 20)), int(rng.integers(0, 20))
        s[bi * 4 : bi * 4 + 4, bj * 4 : bj * 4 + 4] = rng.standard_normal((4, 4))
    return s.tocsr()


BSR_CASES = {  # name -> scipy f64, 4×4 blocks
    "fem16": lambda: tconv.to_scipy(tgen.fem_blocks(16, dof=4)),
    "remainder": _remainder_scipy,
    # FEM values scaled by 2^-8: most round to f16 subnormals (below 2^-14)
    "subnormal": lambda: tconv.to_scipy(tgen.fem_blocks(16, dof=4)) * 2.0 ** -8,
}
CSR_CASES = {
    "stencil_2d(95)": lambda: tconv.to_scipy(tgen.stencil_2d(95)),
    "banded+scatter": lambda: (tconv.to_scipy(tgen.banded(3000, 2, seed=1))
                               + tconv.to_scipy(tgen.random_uniform(3000, density=2e-4,
                                                                    seed=2))).tocsr(),
}


def _bsr_pair(s, torch_values=True):
    """(reference BSR, port BSR on the CPU, f16-rounded scipy) with f16
    values: the port's as an f16 tensor or (``torch_values=False``) as the
    reference's numpy f16 array."""
    sh, _ = _f16_scipy(s)
    jb = jconv.csr_to_bsr(jconv.from_scipy(sh), (4, 4))
    jb = dataclasses.replace(jb, data=np.asarray(jb.data).astype(np.float16))
    tb = tconv.csr_to_bsr(tconv.from_scipy(sh), (4, 4))
    data = np.asarray(jb.data)
    return jb, dataclasses.replace(tb, data=to_device(data, "cpu") if torch_values else data), sh


def _csr_pair(s):
    sh, vals = _f16_scipy(s)
    jc = dataclasses.replace(jconv.from_scipy(sh), data=vals)
    tc = dataclasses.replace(tconv.from_scipy(sh), data=to_device(vals, "cpu"))
    return jc, tc, sh


@pytest.fixture(scope="module")
def bsrs():
    return {name: _bsr_pair(make()) for name, make in BSR_CASES.items()}


@pytest.fixture(scope="module")
def csrs():
    return {name: _csr_pair(make()) for name, make in CSR_CASES.items()}


@pytest.fixture(scope="module")
def pin(bsrs, csrs):
    """The f16 plans of the pin's matrices, the reference's and the port's:
    BDIA (jp, tp), slab at the auto route's g (jsl, tsl), DIA (jd, td), and
    the f16-rounded scipy matrices (sb, sd)."""
    jb, tb, sb = bsrs["fem16"]
    jc, tc, sd = csrs["stencil_2d(95)"]
    jp, tp = jbdia.bdia_plan(jb, (4, 4)), tbdia.bdia_plan(tb, (4, 4), device="cpu")
    tsl = tslab.slab_auto_plan(tp)
    jsl = jslab.bdia_slab_plan(jp, tsl.g)
    jd, td = jdia.dia_plan(jc), tdia.dia_plan(tc, device="cpu")
    assert not tp.rem_data.shape[0] and not td.rem_data.shape[0]  # the kernels' products alone
    return dict(jp=jp, tp=tp, jsl=jsl, tsl=tsl, jd=jd, td=td, sb=sb, sd=sd)


def _operand(shape, dt, seed):
    """(reference array, port CPU tensor, f64 numpy) of one operand in
    ``dt``, from a numpy seed."""
    t = torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                         .astype(np.float32)).to(dt)
    return jnp.asarray(t.float().numpy().astype(np.float16 if dt == F16 else np.float32)), t, \
        t.double().numpy()


def _same(jp, tp, fields):
    for f in fields:
        j, t = getattr(jp, f), getattr(tp, f)
        if t.dtype == F16:
            assert np.array_equal(_bits(t), _bits(j)), f
        else:
            assert np.array_equal(t.numpy(), np.asarray(j)), f


# -- planning: bit-equal packs ---------------------------------------------------


class TestPacks:
    @pytest.mark.parametrize("name", list(BSR_CASES))
    @pytest.mark.parametrize("torch_values", [True, False])
    def test_bdia_plan_equals_the_reference(self, name, torch_values):
        jb, tb, _ = _bsr_pair(BSR_CASES[name](), torch_values)
        jp, tp = jbdia.bdia_plan(jb, (4, 4)), tbdia.bdia_plan(tb, (4, 4), device="cpu")
        assert tp.dtype == F16 and tp.block_offsets == tuple(jp.block_offsets)
        assert (tp.ts, tp.shape) == (jp.ts, tuple(jp.shape))
        _same(jp, tp, ("vals", "rem_data", "rem_row", "rem_col"))
        assert (tp.rem_data.shape[0] > 0) == (name == "remainder")

    def test_subnormal_values_keep_their_bits(self, bsrs):
        jb, tb, _ = bsrs["subnormal"]
        tp = tbdia.bdia_plan(tb, (4, 4), device="cpu")
        bits = _bits(tp.vals)
        sub = (bits & 0x7C00 == 0) & (bits & 0x03FF != 0)  # exponent 0, mantissa not
        assert sub.sum() > 100
        assert np.array_equal(bits, _bits(jbdia.bdia_plan(jb, (4, 4)).vals))
        sd = PlanCache().get(tp)  # the scalar-DIA plan keeps them too
        assert np.array_equal(_bits(sd.vals), _bits(jbdia.bdia_scalar_dia(
            jbdia.bdia_plan(jb, (4, 4))).vals))

    @pytest.mark.parametrize("name", list(BSR_CASES))
    def test_scalar_dia_and_transpose_equal_the_reference(self, bsrs, name):
        jb, tb, _ = bsrs[name]
        jp, tp = jbdia.bdia_plan(jb, (4, 4)), tbdia.bdia_plan(tb, (4, 4), device="cpu")
        jd, td = jbdia.bdia_scalar_dia(jp), PlanCache().get(tp)
        assert td.dtype == F16 and td.offsets == tuple(jd.offsets)
        _same(jd, td, ("vals", "rem_data", "rem_row", "rem_col"))
        jt, tt = jbdia.transpose_plan(jp), ct.transposed(tp)
        assert tt.dtype == F16 and tt.block_offsets == tuple(jt.block_offsets)
        _same(jt, tt, ("vals", "rem_data", "rem_row", "rem_col"))

    @pytest.mark.parametrize("name", list(CSR_CASES))
    def test_dia_plan_and_transpose_equal_the_reference(self, csrs, name):
        jc, tc, _ = csrs[name]
        jp = jdia.dia_plan(jc, with_vals_t=True)
        tp = tdia.dia_plan(tc, with_vals_t=True, device="cpu")
        assert tp.dtype == F16 and tp.offsets == tuple(jp.offsets) and tp.shape == jp.shape
        _same(jp, tp, ("vals", "vals_t", "rem_data", "rem_row", "rem_col"))
        assert (tp.rem_data.shape[0] > 0) == (name == "banded+scatter")
        jt, tt = jdia.transpose_plan(jp), tdia.transpose_plan(tp)
        _same(jt, tt, ("vals", "rem_data", "rem_row", "rem_col"))

    @pytest.mark.parametrize("name", list(BSR_CASES))
    def test_slab_plans_equal_the_reference(self, bsrs, name):
        # at the g the auto route picks: an f16 plan's slabs, and an f32
        # plan's slabs stored as f16 (the reference's dtype=float16)
        jb, tb, _ = bsrs[name]
        jp, tp = jbdia.bdia_plan(jb, (4, 4)), tbdia.bdia_plan(tb, (4, 4), device="cpu")
        g = tslab.slab_auto_plan(tp).g
        for jsl, tsl in ((jslab.bdia_slab_plan(jp, g), tslab.bdia_slab_plan(tp, g)),
                         (jslab.bdia_slab_plan(jp.astype(jnp.float32), g, dtype=jnp.float16),
                          tslab.bdia_slab_plan(tp.astype(F32), g, dtype=np.float16))):
            assert tsl.dtype == F16 and tsl.far_offsets == tuple(jsl.far_offsets)
            assert np.array_equal(_bits(tsl.slabs), _bits(jsl.slabs))


# -- the twins against the reference's kernels (interpret mode) -------------------


def _check(y, y_ref, exact, want, twin32=None, ref_sums_f32=True):
    """Hold the port's ``y`` (the twin on the CPU) to the reference's
    ``y_ref`` as the module docstring states; ``twin32`` is the twin's f32
    sum, for an f16 output."""
    assert y.dtype == want and np.asarray(y_ref).dtype == np.dtype(
        np.float16 if want == F16 else np.float32)
    e_port, e_ref = _relerr(_f64(y), exact), _relerr(_f64(y_ref), exact)
    assert e_port <= e_ref + TOL_OVER_REF, (e_port, e_ref)
    if want == F16:
        assert _ulps(y, twin32) <= 1.0
        if ref_sums_f32:
            assert _relerr(_f64(y), _f64(y_ref)) <= TOL_REF
    elif ref_sums_f32:
        assert _relerr(_f64(y), _f64(y_ref)) <= TOL_F32_OUT
    else:
        assert e_port <= TOL_F32_OUT


def _spmv_out(vdt, xdt):
    return F16 if (vdt, xdt) == (F16, F16) else F32


SPMV = {  # name -> (BDIA?, reference entry, port entry)
    "B1 bdia_spmv_pallas_fused": (True, lambda p, x: jbk.bdia_spmv_pallas_fused(p, x),
                                  lambda p, x: bdia_spmv(p, x)),
    "B2 bdia_spmv_pallas_resident": (True, lambda p, x: p.from_resident(
        jbk.bdia_spmv_pallas_resident(p, p.to_resident(x))),
        lambda p, x: tbdia.BdiaOperator(p)(x)),
    "B3 bdia_spmv_pallas": (True, lambda p, x: p.from_bdia(jbk.bdia_spmv_pallas(
        p, p.to_bdia(x))), lambda p, x: ct.spmv(p, x)),
    "B8 dia_spmv_pallas_padded": (False, lambda p, x: jdk.dia_spmv_pallas(p, x),
                                  lambda p, x: dia_spmv(p, x)),
    "B9 dia_spmv_pallas_layout": (False, lambda p, x: jdk.from_layout(
        p, jdk.dia_spmv_pallas_layout(p, jdk.to_layout(p, x))),
        lambda p, x: tdia.DiaOperator(p)(x)),
    "B10 dia_spmv_pallas_interleaved": (False, lambda p, x: jdk.from_interleaved(
        p, jdk.dia_spmv_pallas_interleaved(p, jdk.to_interleaved(p, x),
                                           jdk.pack_vals_interleaved(p))),
        lambda p, x: p.spmv(x)),
    "B11 dia_spmv_pallas_il_stream": (False, lambda p, x: jdk.from_interleaved(
        p, jdk.dia_spmv_pallas_il_stream(p, jdk.to_interleaved(p, x),
                                         jdk.pack_vals_interleaved(p))),
        lambda p, x: ct.spmv(p, x)),
}


@pytest.mark.parametrize("vdt,xdt", COMBOS, ids=COMBO_IDS)
@pytest.mark.parametrize("name", list(SPMV))
def test_spmv_twin_against_the_reference_kernel(pin, name, vdt, xdt):
    # every one of these reference kernels sums f16 · f16 in f16, f16 · f32 in f32
    bdia, ref_call, port_call = SPMV[name]
    jp, tp, s = (pin["jp"], pin["tp"], pin["sb"]) if bdia else (pin["jd"], pin["td"], pin["sd"])
    if vdt == F32:
        jp, tp = jp.astype(jnp.float32), tp.astype(F32)
    jx, tx, x64 = _operand(s.shape[1], xdt, 1)
    y_ref = ref_call(jp, jx)
    y = port_call(tp, tx)
    twin32 = (bdia_spmv_reference if bdia else dia_spmv_reference)(tp.astype(F32), tx.float())
    want = _spmv_out(vdt, xdt)
    _check(y, y_ref, s @ x64, want, twin32.double().numpy(), ref_sums_f32=want == F32)


def _slab_padded(p, sl, x, out):
    return sl.from_padded(bdia_spmm_slab_padded(sl, sl.to_padded(x), out_dtype=out), x.shape[1])


SPMM = {  # name -> (operand, k, reference sums f32?, reference entry, port entry)
    "B4 bdia_spmm_pallas_ring": ("bdia", K_WIDE, True,
                                 lambda p, sl, x, o: jbk.bdia_spmm_pallas_ring(p, x, out_dtype=o),
                                 lambda p, sl, x, o: bdia_spmm_ring(p, x, out_dtype=o)),
    "B5 bdia_spmm_slab_padded": ("bdia", K_WIDE, True,
                                 lambda p, sl, x, o: sl.from_padded(jslab.bdia_spmm_slab_padded(
                                     sl, sl.to_padded(x), precision="highest", out_dtype=o),
                                     x.shape[1]),
                                 _slab_padded),
    "B6 _slab_ring_call": ("bdia", K_WIDE, True,
                           lambda p, sl, x, o: jslab.bdia_spmm_pallas_slab(
                               sl, x, precision="highest", out_dtype=o),
                           lambda p, sl, x, o: ct.spmm(sl, x, accum_dtype=o)),
    "B12 dia_spmm_pallas_padded": ("dia", K_NARROW, False,
                                   lambda p, sl, x, o: jdk.dia_spmm_pallas(p, x),
                                   lambda p, sl, x, o: dia_spmm(p, x)),
    "B13 dia_spmm_pallas_ring_padded": ("dia", K_WIDE, True,
                                        lambda p, sl, x, o: jdk.from_spmm_ring(
                                            p, jdk.dia_spmm_pallas_ring_padded(
                                                p, jdk.to_spmm_ring(p, x, out_dtype=o),
                                                out_dtype=o), x.shape[1],
                                            layout_dtype=x.dtype),
                                        lambda p, sl, x, o: dia_spmm(p, x, out_dtype=o)),
    "B14 dia_spmm_pallas_kt_padded": ("dia", K_NARROW, False,
                                      lambda p, sl, x, o: jdk.dia_spmm_pallas_kt(p, x),
                                      lambda p, sl, x, o: ct.spmm(p, x)),
    "B15 dia_spmm_pallas_ring_mxu_padded": ("dia", K_WIDE, None,
                                            lambda p, sl, x, o: jdk.from_spmm_ring(
                                                p, jdk.dia_spmm_pallas_ring_mxu_padded(
                                                    p, jdk.to_spmm_ring(p, x, out_dtype=o),
                                                    out_dtype=o), x.shape[1],
                                                layout_dtype=x.dtype),
                                            lambda p, sl, x, o: dia_spmm(p, x, out_dtype=o)),
}
# the explicit out_dtype of the kernels that take one, where it is not the
# default: f32 out of f16 values and X, f16 out of f16 values with f32 X
# (the ring's, whose interpretation takes longest, on the card only)
SPMM_CASES = [(n, v, x, None) for n in SPMM for v, x in COMBOS] + [
    (n, F16, x, o) for n in SPMM for x, o in ((F16, F32), (F32, F16))
    if n.split()[0] in ("B5", "B13")] + [(n, F16, F16, F32) for n in SPMM
                                       if n.split()[0] == "B15"]


@pytest.mark.parametrize("name,vdt,xdt,out", SPMM_CASES,
                         ids=[f"{n.split()[0]}-{str(v)[6:]}-{str(x)[6:]}-{o and str(o)[6:]}"
                              for n, v, x, o in SPMM_CASES])
def test_spmm_twin_against_the_reference_kernel(pin, name, vdt, xdt, out):
    what, k, ref_f32, ref_call, port_call = SPMM[name]
    if what == "bdia":
        jp, tp, s, jsl, tsl = pin["jp"], pin["tp"], pin["sb"], pin["jsl"], pin["tsl"]
        if vdt == F32:
            jp, tp = jp.astype(jnp.float32), tp.astype(F32)
            jsl = dataclasses.replace(jsl, slabs=jsl.slabs.astype(jnp.float32))
            tsl = dataclasses.replace(tsl, slabs=tsl.slabs.float())
    else:
        jp, tp, s, jsl, tsl = pin["jd"], pin["td"], pin["sd"], None, None
        if vdt == F32:
            jp, tp = jp.astype(jnp.float32), tp.astype(F32)
    jx, tx, x64 = _operand((s.shape[1], k), xdt, 2)
    y_ref = ref_call(jp, jsl, jx, None if out is None else jnp.dtype(str(out)[6:]))
    y = port_call(tp, tsl, tx, out)
    want = bk.result_dtype(vdt, xdt, out)
    twin32 = None
    if want == F16:
        twin32 = (dia_spmm_reference(tp, tx, out_dtype=F32) if what == "dia"
                  else bdia_spmm_ring_reference(tp, tx, out_dtype=F32)).double().numpy()
    if ref_f32 is None:  # B15: the reference's near band in bf16
        assert y.dtype == want and np.asarray(y_ref).dtype == np.dtype(str(want)[6:])
        e_port, e_ref = _relerr(_f64(y), s @ x64), _relerr(_f64(y_ref), s @ x64)
        assert e_port <= e_ref + TOL_OVER_REF and e_port <= (TOL_F32_OUT if want == F32
                                                             else TOL_REF)
        if twin32 is not None:
            assert _ulps(y, twin32) <= 1.0
        return
    _check(y, y_ref, s @ x64, want, twin32, ref_sums_f32=ref_f32 or want == F32)


# -- the routes on the CPU against scipy ----------------------------------------------


def _against_scipy(y, ref, composed=False):
    if y.dtype == F32:
        assert _relerr(_f64(y), ref) <= TOL_F32_OUT
    elif composed:  # the kernels' f16 y plus the f16 remainder
        assert _relerr(_f64(y), ref) <= TOL_F16_COMPOSED
    else:
        assert _ulps(y, ref) <= 1.0


@pytest.mark.parametrize("vdt,xdt", COMBOS, ids=COMBO_IDS)
@pytest.mark.parametrize("name", list(BSR_CASES) + list(CSR_CASES))
def test_spmv_routes_against_scipy(bsrs, csrs, name, vdt, xdt):
    if name in BSR_CASES:
        _, tm, sh = bsrs[name]
        p = tbdia.bdia_plan(tm, (4, 4), device="cpu")
    else:
        _, tm, sh = csrs[name]
        p = tdia.dia_plan(tm, device="cpu")
    p = p.astype(vdt)
    _, tx, x64 = _operand(sh.shape[1], xdt, 3)
    y = ct.spmv(p, tx)
    assert y.dtype == _spmv_out(vdt, xdt)
    _against_scipy(y, sh @ x64, composed=p.rem_data.shape[0] > 0)


@pytest.mark.parametrize("vdt,xdt", COMBOS, ids=COMBO_IDS)
@pytest.mark.parametrize("k", [1, 12, 32, 65, 128])
@pytest.mark.parametrize("name", ["fem16", "remainder", "banded+scatter"])
def test_spmm_routes_against_scipy(bsrs, csrs, name, k, vdt, xdt):
    # BDIA: scalar DIA at k <= 64, the slab above; DIA: its SpMM at every k
    if name in BSR_CASES:
        _, tm, sh = bsrs[name]
        p = tbdia.bdia_plan(tm, (4, 4), device="cpu").astype(vdt)
    else:
        _, tm, sh = csrs[name]
        p = tdia.dia_plan(tm, device="cpu").astype(vdt)
    _, tX, X64 = _operand((sh.shape[1], k), xdt, 4 + k)
    Y = ct.spmm(p, tX)
    assert Y.dtype == bk.result_dtype(vdt, xdt) and Y.shape == (sh.shape[0], k)
    _against_scipy(Y, sh @ X64, composed=p.rem_data.shape[0] > 0)


def test_the_auto_routes_take_f16_matrices(bsrs, csrs, monkeypatch):
    # the cached plan of an f16 BSR and CSR is f16, and the route takes it for
    # an f16 or f32 operand (an operand that says it is on the card); an f64
    # operand has no kernel and takes the gather formulation
    import importlib
    import types

    spmv_mod = importlib.import_module("cask_tpu_torch.ops.spmv")  # the module
    plans = PlanCache()
    monkeypatch.setattr(spmv_mod, "default_plan_cache", plans)
    for a in (bsrs["fem16"][1], csrs["stencil_2d(95)"][1]):
        for xdt in (F16, F32, F64):
            x = types.SimpleNamespace(is_cuda=True, device=torch.device("cpu"), dtype=xdt)
            p = spmv_mod.cached_plan(a, x)
            assert (p is None) if xdt == F64 else (p is plans.get(a) and p.dtype == F16)
    # a CPU operand takes the gather formulation, f32 as the reference's
    # (cask_tpu/ops/spmv.py:_spmv_xla_bsr); its plan takes the kernels' policy
    x = torch.ones(bsrs["fem16"][2].shape[1], dtype=F16)
    assert ct.spmv(bsrs["fem16"][1], x).dtype == F32
    assert ct.spmv(plans.get(bsrs["fem16"][1]), x).dtype == F16


# -- the f16 twins sum in f32 ---------------------------------------------------------


def _losing_rows(nb=64):
    """Block rows I of 4×4 blocks; row 4I + r holds 2048 at column 4(I - 1)
    and 1 at columns 4I + r and 4(I + 1): in the plans' sum order (block
    offset, then column; diagonal offset) the 2048 comes first, so an f16
    running sum drops both ones (2048 + 1 ties to 2048), where the f32 sum
    is 2050, an f16 value."""
    i = np.arange(4 * nb)
    blk = i // 4
    rows = np.concatenate([i, i, i])
    cols = np.concatenate([4 * (blk - 1), i, 4 * (blk + 1)])
    vals = np.concatenate([np.full(i.size, 2048.0), np.ones(i.size), np.ones(i.size)])
    ok = (cols >= 0) & (cols < 4 * nb)
    return sp.csr_matrix((vals[ok], (rows[ok], cols[ok])), shape=(4 * nb, 4 * nb))


def test_the_f16_twins_sum_in_f32():
    s = _losing_rows()
    c = dataclasses.replace(tconv.from_scipy(s), data=torch.from_numpy(s.data).to(F16))
    dp = tdia.dia_plan(c, device="cpu")
    bp = tbdia.bdia_plan(c, (4, 4), device="cpu")
    sl = tslab.bdia_slab_plan(bp, 4)
    x = torch.ones(s.shape[1], dtype=F16)
    X = torch.ones((s.shape[1], 3), dtype=F16)
    inner = slice(4, s.shape[0] - 4)  # the block rows with all three entries
    want = torch.full((s.shape[0] - 8,), 2050.0)
    for y in (dia_spmv_reference(dp, x), bdia_spmv_reference(bp, x),
              dia_spmm_reference(dp, X)[:, 0], bdia_spmm_ring_reference(bp, X)[:, 0],
              bdia_spmm_slab_reference(sl, X)[:, 0]):
        assert y.dtype == F16 and torch.equal(y[inner].float(), want)


# -- the type gate ---------------------------------------------------------------------


@pytest.mark.parametrize("vdt,xdt", COMBOS, ids=COMBO_IDS)
def test_output_types_follow_the_policy(pin, vdt, xdt):
    tp, td, tsl = pin["tp"].astype(vdt), pin["td"].astype(vdt), pin["tsl"]
    tsl = dataclasses.replace(tsl, slabs=tsl.slabs.to(vdt))
    assert bk.kernel_types_ok(vdt, xdt) and bk.bdia_kernel_ok(tp)
    x = torch.ones(tp.shape[1], dtype=xdt)
    assert bdia_spmv(tp, x).dtype == _spmv_out(vdt, xdt)
    assert dia_spmv(td, torch.ones(td.shape[1], dtype=xdt)).dtype == _spmv_out(vdt, xdt)
    X = torch.ones((tp.shape[1], 12), dtype=xdt)
    Xd = torch.ones((td.shape[1], 12), dtype=xdt)
    for out in (None, F32, F16):
        want = bk.result_dtype(vdt, xdt, out)
        assert want == (out or _spmv_out(vdt, xdt))
        bk.check_out_dtype(vdt, xdt, want)
        assert bdia_spmm_ring(tp, X, out_dtype=out).dtype == want
        assert bdia_spmm_slab(tsl, X, out_dtype=out).dtype == want
        assert dia_spmm(td, Xd, out_dtype=out).dtype == want
        assert ct.spmm(tsl, X, accum_dtype=out).dtype == want


@pytest.mark.parametrize("vdt,xdt,out", [
    (F16, BF16, None), (BF16, F16, None), (F16, F64, None), (F64, F16, None),
    (F16, F16, BF16), (F16, F32, BF16), (F16, F16, F64), (F32, F16, F64)])
def test_other_combinations_raise(vdt, xdt, out):
    want = bk.result_dtype(vdt, xdt, out)
    with pytest.raises(TypeError, match=str(vdt)):
        bk.check_out_dtype(vdt, xdt, want)
    if out is None:
        assert not bk.kernel_types_ok(vdt, xdt)
        with pytest.raises(TypeError, match=str(xdt)):
            bk.check_types(vdt, xdt)


# -- CG over f16 operators ------------------------------------------------------------


def test_cg_over_an_f16_bdia_operator_matches_the_reference():
    from cask_tpu_torch.formats.generate import _diag_shift

    s = tconv.to_scipy(tgen.fem_blocks(8, dof=4))
    s = tconv.to_scipy(_diag_shift(tconv.from_scipy((s + s.T).tocsr()), 1.1))
    jb, tb, sh = _bsr_pair(s)
    jop = jbdia.BdiaOperator(jbdia.bdia_plan(jb, (4, 4)))
    top = tbdia.BdiaOperator(tbdia.bdia_plan(tb, (4, 4), device="cpu"))
    assert top.bdia.dtype == F16 and jop.bdia.vals.dtype == jnp.float16
    b = np.random.default_rng(7).standard_normal(sh.shape[0]).astype(np.float32)
    ref = jkrylov.cg(jop, jnp.asarray(b), tol=1e-5, maxiter=300)
    res = ct.solvers.cg(top, torch.from_numpy(b), tol=1e-5, maxiter=300)
    assert res.converged and bool(ref.converged) and res.x.dtype == F32
    assert abs(res.iterations - int(ref.iterations)) <= 2
    # the true residual of the f16-rounded system, in f64
    assert _relerr(sh @ res.x.double().numpy(), b) <= 2e-5


def test_cg_over_an_f16_solver_operator_matches_the_reference():
    s = tconv.to_scipy(tgen.stencil_2d(40))
    s = (s + 8.0 * sp.identity(s.shape[0])).tocsr()
    jc, tc, sh = _csr_pair(s)
    jop = jdia.DiaOperator(jc, method="xla")
    top = ct.solver_operator(tc, device="cpu")
    assert top.dia.dtype == F16 and top.mode == "reference"
    b = np.random.default_rng(8).standard_normal(sh.shape[0]).astype(np.float32)
    ref = jkrylov.cg(jop, jnp.asarray(b), tol=1e-5, maxiter=300)
    res = ct.solvers.cg(top, top.to_padded(torch.from_numpy(b)), tol=1e-5, maxiter=300)
    assert res.converged and bool(ref.converged) and res.x.dtype == F32
    assert abs(res.iterations - int(ref.iterations)) <= 2
    assert _relerr(sh @ top.from_padded(res.x).double().numpy(), b) <= 2e-5
