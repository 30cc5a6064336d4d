"""Parity of the port's half-precision paths of BSR SpMM (B7), POH SpMV and
SpMM (B16-B17) and LELL (B18) with the JAX package, on the CPU (the kernels
on the card: tests/test_torch_gpu.py).

The same matrices, made from a numpy seed, go to both packages with bf16 or
f16 values.  The port plans a half matrix from the exact f32 of its values
(bf16) or from the f16 values themselves and casts the packs back, so its
packs must equal the reference's bit for bit (compared as uint16).  The
reference's Pallas kernels run in interpret mode, as tests/test_poh.py and
tests/test_pallas_kernels.py run them.

Type combinations: values and operand each H or f32, at least one H, for H
in bf16 and f16.  Output types are the reference's: f32 for POH, LELL's
``_out_dtype`` (f16 for f16 values and x, else f32), the values' type for
BSR SpMM.

Tolerances: the port's plain twins against the reference's kernels,
normwise ≤ 1e-2 where H is bf16 and ≤ 2e-3 where it is f16 (about 4x the
reference's own error against f64: the TPU kernels round their half
products or sums where the port sums in f32); against scipy f64 of the
half-rounded inputs, ≤ 1e-5 normwise with an f32 output and, with a half
output, each element within one ulp of the output type of the exact sum,
beyond the f32 rounding by which two f32 sums of the same products may
differ (2^-20 of the largest |sum|).  LELL's f16 y rounds twice where a row
also has a remainder or hub part (the lane sums are the kernel's output):
there ≤ 1e-3 normwise, two f16 roundings.
"""

import ast
import dataclasses
from pathlib import Path

import jax  # noqa: F401  (kept on the CPU with x64 by conftest)
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cask_tpu.formats.convert as jconv
import cask_tpu.formats.generate as jgen
import cask_tpu.solvers.krylov as jkrylov
from cask_tpu.ops.pallas import lell_kernels as jlell
from cask_tpu.ops.pallas import poh_kernels as jpoh
from cask_tpu.ops.pallas.bsr_kernels import BsrSpmmKernel as JBsrSpmmKernel
from cask_tpu.solvers.precond import jacobi as jjacobi
import cask_tpu_torch as ct
import cask_tpu_torch.formats.convert as tconv
from cask_tpu_torch.formats.matrix import to_device
from cask_tpu_torch.ops.bsr_spmm import BsrSpmmKernel
from cask_tpu_torch.ops.kernels import bdia_kernels as bk
from cask_tpu_torch.ops.kernels.bsr_kernels import bsr_spmm, bsr_spmm_reference
from cask_tpu_torch.ops.kernels.lell_kernels import lell_lane_sums, lell_lane_sums_reference
from cask_tpu_torch.ops.kernels.poh_kernels import (poh_spmm, poh_spmm_reference, poh_spmv,
                                                    poh_spmv_reference)
from cask_tpu_torch.ops.lell import lell_plan, lell_plan_hyb
from cask_tpu_torch.ops.poh import poh_plan, poh_transpose_plan
from cask_tpu_torch.solvers import jacobi

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32
HALVES = {"bf16": (BF16, jnp.bfloat16), "f16": (F16, np.float16)}
TOL_REF = {"bf16": 1e-2, "f16": 2e-3}  # twin vs the reference's kernel, normwise
TOL_F32_OUT = 1e-5  # twin vs scipy f64 of the rounded inputs, f32 output
CPU = torch.device("cpu")


def _relerr(y, ref):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    den = np.linalg.norm(ref)
    return np.linalg.norm(y - ref) / den if den else np.linalg.norm(y)


def _f64(y):
    """A port or reference result (any float type) as f64 numpy."""
    if isinstance(y, torch.Tensor):
        return y.double().numpy()
    return np.asarray(jnp.asarray(y, jnp.float64))


def _bits(a) -> np.ndarray:
    """A bf16 or f16 array (torch or numpy) as its uint16 bits."""
    if isinstance(a, torch.Tensor):
        assert a.dtype in (BF16, F16)
        return a.view(torch.int16).numpy().view(np.uint16)
    a = np.asarray(a)
    assert a.dtype.name in ("bfloat16", "float16")
    return a.view(np.uint16)


def _ulps(y: torch.Tensor, ref) -> float:
    """The largest distance of half ``y`` from f64 ``ref``, in ulps of
    ``y``'s type at each element, beyond 2^-20 of the largest |ref| (the f32
    rounding by which two f32 sums of the same products may differ)."""
    mant, emin = (7, -126) if y.dtype == BF16 else (10, -14)
    ref = np.asarray(ref, np.float64)
    if ref.size == 0:
        return 0.0
    e = np.maximum(np.floor(np.log2(np.maximum(np.abs(ref), 1e-300))), emin)
    ulp = np.ldexp(1.0, e.astype(int) - mant)
    excess = np.maximum(np.abs(y.double().numpy() - ref) - 2.0 ** -20 * np.abs(ref).max(), 0)
    return float((excess / ulp).max())


def _half(s, h):
    """The scipy matrix with its values rounded to the half type ``h`` (as
    f64 scipy), and those half values as numpy (bf16 as the reference's
    numpy bf16)."""
    vals = np.asarray(s.data, np.float32).astype(HALVES[h][1])
    out = s.astype(np.float64)
    out.data = vals.astype(np.float64)
    return out, vals


def _csr_pair(s, h):
    """(reference CSR, port CSR on the CPU, half-rounded scipy f64) with
    values in the half type ``h``, or f32 for ``h`` None."""
    if h is None:
        s = s.astype(np.float32)
        return jconv.from_scipy(s), tconv.from_scipy(s), s.astype(np.float64)
    sh, vals = _half(s, h)
    jc = dataclasses.replace(jconv.from_scipy(sh), data=vals)
    tc = dataclasses.replace(tconv.from_scipy(sh), data=to_device(vals, "cpu"))
    return jc, tc, sh


def _operand(shape, dt, seed):
    """(numpy for the reference, CPU tensor for the port, f64 numpy) of one
    operand in ``dt`` (a torch type), from a numpy seed."""
    x32 = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(x32).to(dt)
    jx = t.float().numpy().astype(jnp.bfloat16 if dt == BF16 else
                                  np.float16 if dt == F16 else np.float32)
    return jx, t, t.double().numpy()


def _hub_row():
    """4,000 rows of about 4 entries and row 5 with 3,000: a hub row that
    owns most of its panel (the POH SpMM kernel cuts that panel) and goes to
    LELL's hub tier."""
    s = jconv.to_scipy(jgen.random_uniform(4000, 4000, density=1e-3, seed=47))
    rng = np.random.default_rng(48)
    hub = sp.csr_matrix((rng.standard_normal(3000),
                         (np.full(3000, 5), rng.choice(4000, 3000, replace=False))),
                        shape=s.shape)
    return (s + hub).tocsr()


def _trailing_empty():
    s = jconv.to_scipy(jgen.random_uniform(1500, 900, density=0.01, seed=7)).tolil()
    s[1400:, :] = 0
    return s.tocsr()


def _holes():
    s = jconv.to_scipy(jgen.random_uniform(400, 400, density=0.02, seed=8)).tolil()
    s[100:200, :] = 0
    s[:, 100:200] = 0
    return s.tocsr()


POH_CASES = {  # name -> scipy f64 CSR: the reference's test_poh.py::test_bf16 matrix first
    "power_law(2000, seed=13)": lambda: jconv.to_scipy(jgen.power_law(2000, avg_degree=8,
                                                                      seed=13)),
    "wide": lambda: jconv.to_scipy(jgen.random_uniform(2000, 2700, density=0.003, seed=2)),
    "tall": lambda: jconv.to_scipy(jgen.random_uniform(2700, 1100, density=0.003, seed=3)),
    "empty_rows_cols": _holes,
    "all_zero": lambda: sp.csr_matrix((300, 500)),
    "n_below_window": lambda: jconv.to_scipy(jgen.random_uniform(3000, 300, density=0.01,
                                                                 seed=7)),
    "hub_row": _hub_row,
}
LELL_CASES = {
    "uniform": lambda: jconv.to_scipy(jgen.random_uniform(2000, density=0.008, seed=3)),
    "power_law": lambda: jconv.to_scipy(jgen.power_law(3000, avg_degree=10, seed=6)),
    "trailing_empty_rows": _trailing_empty,
    "hub_row": _hub_row,
}
BSR_CASES = {  # name -> (scipy f64, blocksize)
    "fem 4x4": lambda: (jconv.to_scipy(jgen.fem_blocks(8, dof=4)), (4, 4)),
    "fem (4,2)": lambda: (jconv.to_scipy(jgen.fem_blocks(6, dof=4, seed=2)), (4, 2)),
}


def _combos(h):
    """(values, operand) torch types of the half path of ``h``."""
    t = HALVES[h][0]
    return [(t, t), (t, F32), (F32, t)]


def _combo_id(c):
    return f"{str(c[0])[6:]}-{str(c[1])[6:]}"


COMBOS = [(h, v, x) for h in HALVES for v, x in _combos(h)]
COMBO_IDS = [f"{h}:{_combo_id((v, x))}" for h, v, x in COMBOS]


@pytest.fixture(scope="module")
def poh_mats():
    return {name: make() for name, make in POH_CASES.items()}


@pytest.fixture(scope="module")
def lell_mats():
    return {name: make() for name, make in LELL_CASES.items()}


# -- plans: bit for bit -------------------------------------------------------


class TestPacks:
    @pytest.mark.parametrize("name", list(POH_CASES))
    @pytest.mark.parametrize("h", list(HALVES))
    def test_poh_pack_equals_the_reference(self, poh_mats, name, h):
        jc, tc, _ = _csr_pair(poh_mats[name], h)
        j, t = jpoh.poh_plan(jc), poh_plan(tc, device=CPU)
        assert t.dtype == HALVES[h][0] and np.asarray(j.vals).dtype == np.dtype(HALVES[h][1])
        assert np.array_equal(_bits(t.vals), _bits(j.vals))
        for f in ("cloc", "rloc", "wlo", "whi", "panel", "first", "last"):
            assert np.array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f))), f
        assert (t.shape, t.row_panel, t.col_window, t.ntiles) == (j.shape, j.row_panel,
                                                                  j.col_window, j.ntiles)

    @pytest.mark.parametrize("h", list(HALVES))
    def test_poh_transpose_keeps_the_type_and_equals_the_reference(self, poh_mats, h):
        jc, tc, _ = _csr_pair(poh_mats["power_law(2000, seed=13)"], h)
        j, t = jpoh.poh_transpose_plan(jpoh.poh_plan(jc)), poh_transpose_plan(
            poh_plan(tc, device=CPU))
        assert t.dtype == HALVES[h][0]
        assert np.array_equal(_bits(t.vals), _bits(j.vals))
        assert np.array_equal(t.cloc.numpy(), np.asarray(j.cloc))
        assert ct.transposed(poh_plan(tc, device=CPU)).dtype == HALVES[h][0]

    @pytest.mark.parametrize("name", list(LELL_CASES))
    @pytest.mark.parametrize("h", list(HALVES))
    def test_lell_hyb_pack_equals_the_reference(self, lell_mats, name, h):
        jc, tc, _ = _csr_pair(lell_mats[name], h)
        j, t = jlell.lell_plan_hyb(jc), lell_plan_hyb(tc, device=CPU)
        for jt, tt, fields in ((j.main, t.main, ("vals", "rem_data")), (j.hub, t.hub, ("vals",))):
            for f in fields:
                assert getattr(tt, f).dtype == HALVES[h][0], f
                assert np.array_equal(_bits(getattr(tt, f)), _bits(getattr(jt, f))), f
        for f in ("idx", "rem_row", "rem_col"):
            assert np.array_equal(getattr(t.main, f).numpy(), np.asarray(getattr(j.main, f))), f
        for f in ("idx", "slot2row"):
            assert np.array_equal(getattr(t.hub, f).numpy(), np.asarray(getattr(j.hub, f))), f

    @pytest.mark.parametrize("groups", [1, 8])
    @pytest.mark.parametrize("h", list(HALVES))
    def test_lell_plan_equals_the_reference(self, lell_mats, groups, h):
        jc, tc, _ = _csr_pair(lell_mats["power_law"], h)
        j = jlell.lell_plan(jc, groups=groups, max_layers=2)
        t = lell_plan(tc, groups=groups, max_layers=2, device=CPU)
        assert t.rem_data.shape[0] > 0 and t.vals.dtype == HALVES[h][0]
        for f in ("vals", "rem_data"):
            assert np.array_equal(_bits(getattr(t, f)), _bits(getattr(j, f))), f
        assert np.array_equal(t.idx.numpy(), np.asarray(j.idx))

    @pytest.mark.parametrize("name", list(BSR_CASES))
    @pytest.mark.parametrize("h", list(HALVES))
    def test_bsr_pack_equals_the_reference(self, name, h):
        s, b = BSR_CASES[name]()
        jb, tb, _ = _bsr_pair(s, b, h)
        j, t = JBsrSpmmKernel.plan(jb, k=16), BsrSpmmKernel.plan(tb, k=16, device=CPU)
        assert t.vals.dtype == HALVES[h][0]
        assert np.array_equal(_bits(t.vals), _bits(j.vals))
        assert np.array_equal(t.cols.numpy(), np.asarray(j.cols))
        assert (t.G, t.K, t.shape, t.blocksize) == (j.G, j.K, j.shape, j.blocksize)


def _bsr_pair(s, b, h):
    """(reference BSR, port BSR on the CPU, half-rounded scipy f64) with
    blocks ``b`` and values in ``h`` (f32 for None)."""
    if h is None:
        s = s.astype(np.float32)
        return (jconv.csr_to_bsr(jconv.from_scipy(s), b), tconv.csr_to_bsr(tconv.from_scipy(s), b),
                s.astype(np.float64))
    sh, _ = _half(s, h)
    jb = jconv.csr_to_bsr(jconv.from_scipy(sh), b)
    jb = dataclasses.replace(jb, data=np.asarray(jb.data).astype(HALVES[h][1]))
    tb = tconv.csr_to_bsr(tconv.from_scipy(sh), b)
    tb = dataclasses.replace(tb, data=to_device(np.asarray(jb.data), "cpu"))
    return jb, tb, sh


def _half_of(vdt, xdt):
    return "bf16" if BF16 in (vdt, xdt) else "f16"


def _poh_pair(s, vdt):
    jc, tc, sh = _csr_pair(s, None if vdt == F32 else _half_of(vdt, vdt))
    return jpoh.poh_plan(jc), poh_plan(tc, device=CPU), sh


# -- twins against the reference's kernels (interpret mode) --------------------


class TestTwinsAgainstTheReference:
    @pytest.mark.parametrize("h,vdt,xdt", COMBOS, ids=COMBO_IDS)
    @pytest.mark.parametrize("name", ["power_law(2000, seed=13)", "hub_row"])
    def test_poh_spmv(self, poh_mats, name, h, vdt, xdt):
        jp, tp, _ = _poh_pair(poh_mats[name], vdt)
        jx, tx, _ = _operand(tp.shape[1], xdt, 1)
        y_ref = jpoh.poh_spmv_pallas(jp, jnp.asarray(jx))
        y = poh_spmv(tp, tx)
        assert y.dtype == F32 and np.asarray(y_ref).dtype == np.float32
        assert _relerr(y, _f64(y_ref)) <= TOL_REF[h]

    @pytest.mark.parametrize("h,vdt,xdt", COMBOS, ids=COMBO_IDS)
    def test_poh_spmm(self, poh_mats, h, vdt, xdt):
        jp, tp, _ = _poh_pair(poh_mats["power_law(2000, seed=13)"], vdt)
        jx, tx, _ = _operand((tp.shape[1], 8), xdt, 2)
        y_ref = jpoh.poh_spmm_pallas(jp, jnp.asarray(jx))
        y = ct.spmm(tp, tx)
        assert y.dtype == F32 and np.asarray(y_ref).dtype == np.float32
        assert _relerr(y, _f64(y_ref)) <= TOL_REF[h]

    @pytest.mark.parametrize("h,vdt,xdt", COMBOS, ids=COMBO_IDS)
    @pytest.mark.parametrize("name", ["power_law", "trailing_empty_rows", "hub_row"])
    def test_lell_hyb_spmv(self, lell_mats, name, h, vdt, xdt):
        jc, tc, _ = _csr_pair(lell_mats[name], None if vdt == F32 else h)
        j, t = jlell.lell_plan_hyb(jc), lell_plan_hyb(tc, device=CPU)
        jx, tx, _ = _operand(t.shape[1], xdt, 3)
        y_ref = j.spmv(jnp.asarray(jx))
        y = t.spmv(tx)
        want = F16 if (vdt, xdt) == (F16, F16) else F32
        assert y.dtype == want and np.asarray(y_ref).dtype == np.dtype(
            np.float16 if want == F16 else np.float32)
        m_ref = int(np.asarray(y_ref).shape[0])  # the reference's y is short past empty rows
        assert _relerr(y[:m_ref], _f64(y_ref)) <= TOL_REF[h]
        assert not torch.any(y[m_ref:])

    @pytest.mark.parametrize("h,vdt,xdt", COMBOS, ids=COMBO_IDS)
    @pytest.mark.parametrize("name", list(BSR_CASES))
    def test_bsr_spmm(self, name, h, vdt, xdt):
        s, b = BSR_CASES[name]()
        jb, tb, _ = _bsr_pair(s, b, None if vdt == F32 else h)
        jx, tx, _ = _operand((tb.shape[1], 24), xdt, 4)
        y_ref = JBsrSpmmKernel.plan(jb, k=24)(jnp.asarray(jx))
        y = ct.spmm(tb, tx, method="pallas_bsr")
        assert y.dtype == vdt and np.asarray(y_ref).dtype == np.dtype(
            {BF16: jnp.bfloat16, F16: np.float16, F32: np.float32}[vdt])
        assert _relerr(y.double(), _f64(y_ref)) <= TOL_REF[h]


# -- twins against scipy f64 of the rounded inputs ------------------------------


def _check_vs_scipy(y, ref):
    if y.dtype == F32:
        assert _relerr(y.double(), ref) <= TOL_F32_OUT
    else:
        assert _ulps(y, ref) <= 1.0


TOL_F16_COMPOSED = 1e-3  # f16 LELL y: the lane sums, rounded, plus a remainder, rounded again


class TestTwinsAgainstScipy:
    @pytest.mark.parametrize("h,vdt,xdt", COMBOS, ids=COMBO_IDS)
    @pytest.mark.parametrize("name", list(POH_CASES))
    def test_poh(self, poh_mats, name, h, vdt, xdt):
        _, tc, sh = _csr_pair(poh_mats[name], None if vdt == F32 else h)
        p = poh_plan(tc, device=CPU)
        _, tx, x64 = _operand(sh.shape[1], xdt, 5)
        _, tX, X64 = _operand((sh.shape[1], 5), xdt, 6)
        _check_vs_scipy(poh_spmv_reference(p, tx), sh @ x64)
        _check_vs_scipy(poh_spmm_reference(p, tX), sh @ X64)
        _, tt, xt64 = _operand(sh.shape[0], xdt, 7)
        _check_vs_scipy(ct.spmv(ct.transposed(p), tt), sh.T @ xt64)

    @pytest.mark.parametrize("h,vdt,xdt", COMBOS, ids=COMBO_IDS)
    @pytest.mark.parametrize("name", list(LELL_CASES))
    def test_lell(self, lell_mats, name, h, vdt, xdt):
        _, tc, sh = _csr_pair(lell_mats[name], None if vdt == F32 else h)
        _, tx, x64 = _operand(sh.shape[1], xdt, 8)
        hyb = lell_plan_hyb(tc, device=CPU)
        spill = lell_plan(tc, max_layers=1, device=CPU)  # a COO remainder
        assert spill.rem_data.shape[0] > 0
        for tier, g in ((hyb.main, hyb.main.groups), (hyb.hub, 1), (spill, spill.groups)):
            # the twin's group sums against the same products summed in f64
            exact = lell_lane_sums_reference(tier.vals.double(), tier.idx, tx.double(), g)
            _check_vs_scipy(lell_lane_sums_reference(tier.vals, tier.idx, tx, g), exact.numpy())
        for y in (hyb.spmv(tx), spill.spmv(tx)):
            if y.dtype == F16:  # two roundings where a row has a remainder or hub part
                assert _relerr(y.double(), sh @ x64) <= TOL_F16_COMPOSED
            else:
                _check_vs_scipy(y, sh @ x64)

    @pytest.mark.parametrize("h,vdt,xdt", COMBOS, ids=COMBO_IDS)
    @pytest.mark.parametrize("name", list(BSR_CASES))
    def test_bsr(self, name, h, vdt, xdt):
        s, b = BSR_CASES[name]()
        _, tb, sh = _bsr_pair(s, b, None if vdt == F32 else h)
        p = BsrSpmmKernel.plan(tb, k=40, device=CPU)
        for k in (1, 40):
            _, tX, X64 = _operand((sh.shape[1], k), xdt, 9 + k)
            y = bsr_spmm_reference(p, tX)
            assert y.dtype == vdt
            _check_vs_scipy(y, sh @ X64)


# -- the wrappers' type gates -----------------------------------------------------


class TestTypes:
    @pytest.mark.parametrize("h,vdt,xdt", COMBOS, ids=COMBO_IDS)
    def test_the_half_kernels_take_each_combination(self, h, vdt, xdt):
        assert bk.kernel_types_ok(vdt, xdt)
        bk.check_types(vdt, xdt)
        name = bk.entry("cask_poh_spmv", vdt, xdt)
        assert name in bk.entries("cask_poh_spmv", False)
        assert name == f"cask_poh_spmv_{bk._NAMES[vdt]}_{bk._NAMES[xdt]}"

    @pytest.mark.parametrize("vdt,xdt", [(BF16, F16), (F16, BF16), (F16, torch.float64),
                                         (torch.float64, BF16), (BF16, torch.float64),
                                         (F32, torch.float64)])
    def test_other_combinations_raise_and_name_it(self, vdt, xdt):
        assert not bk.kernel_types_ok(vdt, xdt)
        with pytest.raises(TypeError, match=str(vdt)):
            bk.check_types(vdt, xdt)

    def test_the_block_and_banded_kernels_take_f16(self):
        # one gate for every kernel: the block and banded kernels' f16 entries
        # (SpMV out f16 for f16 values and x, else f32; SpMM out f32 or f16)
        assert bk.kernel_types_ok(F16, F16) and bk.kernel_types_ok(F16, F32)
        assert bk.kernel_types_ok(F32, F16) and F16 in bk.VALUE_DTYPES
        assert {"cask_bdia_spmv_f16_f16", "cask_bdia_spmv_f16_f32",
                "cask_bdia_spmv_f32_f16"} <= set(bk.entries("cask_bdia_spmv", False))
        assert {f"cask_dia_spmm_{v}_{x}_{o}" for v, x in (("f16", "f16"), ("f16", "f32"),
                                                          ("f32", "f16"))
                for o in ("f32", "f16")} <= set(bk.entries("cask_dia_spmm", True))

    def test_lane_sums_output_types(self):
        s = LELL_CASES["uniform"]().astype(np.float32)
        p = lell_plan(tconv.from_scipy(s), device=CPU)
        for vdt, xdt, want in ((F16, F16, F16), (F16, F32, F32), (F32, F16, F32),
                               (BF16, BF16, F32), (BF16, F32, F32)):
            x = torch.ones(s.shape[1], dtype=xdt)
            assert lell_lane_sums(p.vals.to(vdt), p.idx, x, 8).dtype == want
            assert lell_lane_sums_reference(p.vals.to(vdt), p.idx, x, 8).dtype == want


# -- CG over a bf16 POH plan ------------------------------------------------------


def _row_shifted_spd(s):
    """``A + Aᵀ`` with each row's diagonal raised by 1.1 × its own absolute
    row sum (1.1 on an empty row): SPD, and Jacobi has work to do."""
    a = (s + s.T).tocsr()
    d = 1.1 * np.asarray(abs(a).sum(axis=1)).ravel()
    return (a + sp.diags(np.where(d > 0, d, 1.1))).tocsr()


def test_cg_over_a_bf16_poh_plan_matches_the_reference():
    s = _row_shifted_spd(POH_CASES["power_law(2000, seed=13)"]())
    jc, tc, sh = _csr_pair(s, "bf16")
    jp, tp = jpoh.poh_plan(jc), poh_plan(tc, device=CPU)
    assert tp.dtype == BF16
    d32 = tconv.from_scipy(sh.astype(np.float32))  # the same f32 diagonal for both
    b = np.random.default_rng(9).standard_normal(sh.shape[0]).astype(np.float32)
    ref = jkrylov.cg(jp, jnp.asarray(b), tol=1e-5, maxiter=300,
                     M=jjacobi(jconv.from_scipy(sh.astype(np.float32))))
    res = ct.solvers.cg(tp, torch.from_numpy(b), tol=1e-5, maxiter=300,
                        M=jacobi(d32, device=CPU))
    assert res.converged and bool(ref.converged) and res.x.dtype == F32
    assert abs(res.iterations - int(ref.iterations)) <= 2
    # the true residual of the bf16-rounded system, in f64
    assert _relerr(sh @ res.x.double().numpy(), b) <= 2e-5


# -- f16 on the block and banded kernels (B1-B5, B8-B15) ----------------------


def _f16_block_and_banded():
    """(BDIA plan, DIA plan) of f16 matrices, the reference's."""
    from cask_tpu.ops.bdia import bdia_plan as jbdia_plan
    from cask_tpu.ops.dia import dia_plan as jdia_plan

    s = jconv.to_scipy(jgen.fem_blocks(16, dof=4))
    b = jconv.csr_to_bsr(jconv.from_scipy(s), (4, 4))
    b = dataclasses.replace(b, data=np.asarray(b.data).astype(np.float16))
    st = jconv.to_scipy(jgen.stencil_2d(95))
    c = dataclasses.replace(jconv.from_scipy(st), data=np.asarray(st.data).astype(np.float16))
    return jbdia_plan(b, (4, 4)), jdia_plan(c)


def _ref_f16_entries():
    from cask_tpu.ops.pallas import bdia_kernels as jbk
    from cask_tpu.ops.pallas import bdia_slab as jbs
    from cask_tpu.ops.pallas import dia_kernels as jdk

    def vec(p, k=None):
        shape = (p.shape[1],) if k is None else (p.shape[1], k)
        return jnp.asarray(np.random.default_rng(70).standard_normal(shape).astype(np.float16))

    return {
        "B1 bdia_spmv_pallas_fused": lambda b, d: jbk.bdia_spmv_pallas_fused(b, vec(b)),
        "B2 bdia_spmv_pallas_resident": lambda b, d: jbk.bdia_spmv_pallas_resident(
            b, b.to_resident(vec(b))),
        "B3 bdia_spmv_pallas": lambda b, d: jbk.bdia_spmv_pallas(b, b.to_bdia(vec(b))),
        "B4 bdia_spmm_pallas_ring": lambda b, d: jbk.bdia_spmm_pallas_ring(b, vec(b, 128)),
        "B5 bdia_spmm_slab_padded": lambda b, d: (lambda sl: jbs.bdia_spmm_slab_padded(
            sl, sl.to_padded(vec(b, 128))))(jbs.bdia_slab_plan(b, 16)),
        "B8 dia_spmv_pallas_padded": lambda b, d: jdk.dia_spmv_pallas(d, vec(d)),
        "B9 dia_spmv_pallas_layout": lambda b, d: jdk.dia_spmv_pallas_layout(
            d, jdk.to_layout(d, vec(d))),
        "B10 dia_spmv_pallas_interleaved": lambda b, d: jdk.dia_spmv_pallas_interleaved(
            d, jdk.to_interleaved(d, vec(d)), jdk.pack_vals_interleaved(d)),
        "B11 dia_spmv_pallas_il_stream": lambda b, d: jdk.dia_spmv_pallas_il_stream(
            d, jdk.to_interleaved(d, vec(d)), jdk.pack_vals_interleaved(d)),
        "B12 dia_spmm_pallas_padded": lambda b, d: jdk.dia_spmm_pallas(d, vec(d, 32)),
        "B13 dia_spmm_pallas_ring_padded": lambda b, d: jdk.dia_spmm_pallas_ring(d, vec(d, 128)),
        "B14 dia_spmm_pallas_kt_padded": lambda b, d: jdk.dia_spmm_pallas_kt(d, vec(d, 32)),
        "B15 dia_spmm_pallas_ring_mxu_padded": lambda b, d: jdk.dia_spmm_pallas_ring_mxu_padded(
            d, jdk.to_spmm_ring(d, vec(d, 128))),
    }


@pytest.fixture(scope="module")
def f16_plans():
    return _f16_block_and_banded()


@pytest.mark.parametrize("name", list(_ref_f16_entries()))
def test_the_reference_block_and_banded_kernels_take_f16(f16_plans, name, monkeypatch):
    # the reference's kernel runs f16 values and operand to its pallas_call and
    # returns f16; the port's block and banded kernels take f16 too
    # (tests/test_torch_f16.py holds them against these kernels)
    from jax.experimental import pallas as pl

    calls = []
    real = pl.pallas_call
    monkeypatch.setattr(pl, "pallas_call", lambda *a, **k: calls.append(1) or real(*a, **k))
    y = _ref_f16_entries()[name](*f16_plans)
    assert calls and np.asarray(y).dtype == np.float16
    assert bk.kernel_types_ok(F16, F16) and bk.kernel_types_ok(F16, F32)


def test_no_port_module_nor_chip_smoke_imports_jax_or_the_reference():
    # every import statement, those inside functions too, of the port and of
    # chip_smoke.py: neither may reach JAX or the JAX package
    repo = Path(__file__).resolve().parents[1]
    files = [repo / "chip_smoke.py", *sorted((repo / "cask_tpu_torch").rglob("*.py"))]
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "cask_tpu"), (f, name)
