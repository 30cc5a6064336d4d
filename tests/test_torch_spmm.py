"""Parity of the port's SpMM formulations, DIA and BDIA ring SpMM twins and
``spmm`` dispatch with the JAX package, on the CPU (the kernels on the card:
tests/test_torch_gpu.py).

The reference's DIA SpMM Pallas kernels (B12-B15), its BDIA ring (B4) and
the wide-k ``spmm`` chain run in interpret mode, as tests/test_spmm.py,
tests/test_bdia.py and tests/test_pallas_kernels.py run them.  Tolerances:
f64 ≤ 1e-12 normwise, f32 ≤ 1e-5; B15 multiplies its near band in bf16 and
is held within its own 5e-3 (tests/test_spmm.py::TestRingMxuHybrid).
"""

import dataclasses
import importlib

import jax  # noqa: F401  (kept on the CPU with x64 by conftest)
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cask_tpu.formats.convert as jconv
import cask_tpu.formats.generate as jgen
import cask_tpu.ops.bdia as jbdia
import cask_tpu.ops.dia as jdia
import cask_tpu_torch.formats.convert as tconv
import cask_tpu_torch.formats.generate as tgen
import cask_tpu_torch.ops.bdia as tbdia
import cask_tpu_torch.ops.bdia_slab as tslab
import cask_tpu_torch.ops.dia as tdia
from cask_tpu.ops.pallas import bdia_kernels as jbk
from cask_tpu.ops.pallas import dia_kernels as jdk
from cask_tpu.ops.spmm import spmm as jax_spmm
from cask_tpu_torch.formats.matrix import torch_dtype
from cask_tpu_torch.ops.kernels.bdia_kernels import bdia_mm_ok, bdia_spmm_ring
from cask_tpu_torch.ops.kernels.dia_kernels import dia_spmm, dia_spmm_reference
from cask_tpu_torch.ops.spmm import spmm
from cask_tpu_torch.ops.spmv import PlanCache

# the module itself: ``cask_tpu_torch.ops.spmv`` as an attribute is the function
spmv_mod = importlib.import_module("cask_tpu_torch.ops.spmv")
jspmv_mod = importlib.import_module("cask_tpu.ops.spmv")
TOL = {np.float32: 1e-5, np.float64: 1e-12}


def _relerr(y, ref):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(y - ref) / np.linalg.norm(ref)


def _X(rows, k, dtype=np.float64, seed=0):
    return np.random.default_rng(seed).standard_normal((rows, k)).astype(dtype)


def _pair(fmt, dtype=np.float64):
    """The same host matrix in both packages, in format ``fmt``."""
    j = jgen.fem_blocks(7, dof=4, dtype=dtype)
    t = tgen.fem_blocks(7, dof=4, dtype=dtype)
    if fmt == "csr":
        return j, t
    if fmt == "coo":
        return jconv.csr_to_coo(j), tconv.csr_to_coo(t)
    if fmt == "bsr":
        return jconv.csr_to_bsr(j, (4, 4)), tconv.csr_to_bsr(t, (4, 4))
    if fmt == "bsr_rect":
        return jconv.csr_to_bsr(j, (4, 2)), tconv.csr_to_bsr(t, (4, 2))
    if fmt == "bsr_ragged":
        return (jconv.csr_to_bsr(jgen.stencil_2d(11, dtype=dtype), (4, 4)),
                tconv.csr_to_bsr(tgen.stencil_2d(11, dtype=dtype), (4, 4)))
    if fmt == "powerlaw":
        return jgen.power_law(400, seed=2, dtype=dtype), tgen.power_law(400, seed=2, dtype=dtype)
    raise KeyError(fmt)


@pytest.mark.parametrize("fmt", ["csr", "coo", "bsr", "bsr_rect", "bsr_ragged", "powerlaw"])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gather_formulation_matches_xla(fmt, transpose, dtype):
    j, t = _pair(fmt, dtype)
    x = _X(j.shape[0] if transpose else j.shape[1], 7, dtype, seed=1)
    y_ref = np.asarray(jax_spmm(j, x, transpose=transpose, method="xla"))
    y = spmm(t, torch.from_numpy(x), transpose=transpose, method="xla")
    assert y.shape == y_ref.shape and y.dtype == torch_dtype(y_ref.dtype)
    assert _relerr(y, y_ref) <= TOL[dtype]


def test_gather_formulation_accum_dtype():
    j, t = _pair("bsr", np.float32)
    x = _X(j.shape[1], 5, np.float32, seed=2)
    y_ref = np.asarray(jax_spmm(j, x, method="xla", accum_dtype=np.float64))
    y = spmm(t, torch.from_numpy(x), method="xla", accum_dtype=np.float64)
    assert y.dtype == torch.float64 and str(y_ref.dtype) == "float64"
    assert _relerr(y, y_ref) <= 1e-7


def _diags(m, n, offsets, seed):
    rng = np.random.default_rng(seed)
    lens = [min(m, n - k) if k >= 0 else min(m + k, n) for k in offsets]
    return sp.diags([rng.standard_normal(ln) for ln in lens], offsets, shape=(m, n)).tocsr()


DIA_CASES = {
    "stencil95": lambda: tconv.to_scipy(tgen.stencil_2d(95)),
    "banded": lambda: tconv.to_scipy(tgen.banded(9000, 2, seed=5)),
    "asym_up": lambda: _diags(2000, 2000, [1, 3, 7], 7),
    "asym_down": lambda: _diags(2000, 2000, [-5, -2, 0], 8),
    "rect_wide": lambda: _diags(1200, 3000, [-700, -1, 0, 2, 1500], 10),
}


def _dia_plans(name, dtype=np.float64):
    s = DIA_CASES[name]().astype(dtype)
    return jdia.dia_plan(jconv.from_scipy(s)), tdia.dia_plan(tconv.from_scipy(s), device="cpu")


class TestDiaTwin:
    @pytest.mark.parametrize("name", list(DIA_CASES))
    @pytest.mark.parametrize("k", [1, 20, 128])
    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_matches_spmm_xla(self, name, k, dtype):
        jp, tp = _dia_plans(name, dtype)
        x = _X(jp.shape[1], k, dtype, seed=3)
        y_ref = np.asarray(jp._spmm_xla(jnp.asarray(x)))
        y = tp._spmm_reference(torch.from_numpy(x))
        assert y.shape == y_ref.shape and y.dtype == torch_dtype(y_ref.dtype)
        assert _relerr(y, y_ref) <= TOL[dtype]
        before = dia_spmm.launches  # the wrapper on a CPU tensor is the twin
        assert torch.equal(tp.spmm(torch.from_numpy(x)), y)
        assert dia_spmm.launches == before

    def test_remainder_is_added(self):
        s = tconv.to_scipy(tgen.banded(3000, 2, seed=1)) + \
            tconv.to_scipy(tgen.banded(3000, 9, density=0.03, seed=2))
        jp, tp = jdia.dia_plan(jconv.from_scipy(s)), tdia.dia_plan(tconv.from_scipy(s),
                                                                   device="cpu")
        assert tp.rem_data.shape[0] > 0
        x = _X(s.shape[1], 9, seed=4)
        assert _relerr(tp.spmm(torch.from_numpy(x)), np.asarray(jp._spmm_xla(x))) <= 1e-12
        assert _relerr(tp.spmm(torch.from_numpy(x)), s @ x) <= 1e-12

    @pytest.mark.parametrize("k", [32, 128])
    def test_matches_pallas_padded_kernel(self, k):
        # B12 (dia_spmm_pallas_padded via dia_spmm_pallas), resident X
        jp, tp = _dia_plans("banded")
        assert jdk.pallas_ok(jp, k=k)
        x = _X(jp.shape[1], k, seed=5)
        y_kernel = np.asarray(jdk.dia_spmm_pallas(jp, jnp.asarray(x)))
        assert _relerr(dia_spmm_reference(tp, torch.from_numpy(x)), y_kernel) <= 1e-12

    def test_matches_pallas_windowed_kernel(self, monkeypatch):
        # B12's windowed-X body (_spmm_window_kernel), forced as the JAX tests do
        jp, tp = _dia_plans("banded")
        monkeypatch.setattr(jdk, "_X_VMEM_BUDGET", 1 << 18)
        x = _X(jp.shape[1], 32, seed=6)
        y_kernel = np.asarray(jdk.dia_spmm_pallas(jp, jnp.asarray(x)))
        assert _relerr(dia_spmm_reference(tp, torch.from_numpy(x)), y_kernel) <= 1e-12

    @pytest.mark.parametrize("name,k", [("stencil95", 128), ("banded", 100)])
    def test_matches_pallas_ring_kernel(self, name, k):
        # B13 (dia_spmm_pallas_ring_padded via dia_spmm_pallas_ring)
        jp, tp = _dia_plans(name)
        assert jdk.ring_ok(jp, k)
        x = _X(jp.shape[1], k, seed=7)
        y_kernel = np.asarray(jdk.dia_spmm_pallas_ring(jp, jnp.asarray(x)))
        assert _relerr(dia_spmm_reference(tp, torch.from_numpy(x)), y_kernel) <= 1e-12

    @pytest.mark.parametrize("name,k", [("banded", 8), ("banded", 20), ("banded", 32),
                                        ("banded", 64), ("asym_up", 24), ("asym_down", 24)])
    def test_matches_pallas_kt_kernel(self, name, k):
        # B14 (dia_spmm_pallas_kt_padded via dia_spmm_pallas_kt), k ≤ 64
        jp, tp = _dia_plans(name)
        assert jdk.kt_ok(jp, k)
        x = _X(jp.shape[1], k, seed=8)
        y_kernel = np.asarray(jdk.dia_spmm_pallas_kt(jp, jnp.asarray(x)))
        assert _relerr(dia_spmm_reference(tp, torch.from_numpy(x)), y_kernel) <= 1e-12

    def test_matches_pallas_ring_mxu_kernel_within_bf16(self):
        # B15 (dia_spmm_pallas_ring_mxu_padded): near band as a bf16 matmul on
        # the TPU; the port's exact-class product agrees within B15's own bound
        a = jgen.stencil_2d(64, dtype=np.float32)
        jp = jdia.dia_plan(a)
        tp = tdia.dia_plan(tgen.stencil_2d(64, dtype=np.float32), device="cpu")
        x = _X(a.shape[1], 128, np.float32, seed=9)
        xp = jdk.to_spmm_ring(jp, jnp.asarray(x))
        y_kernel = np.asarray(jdk.from_spmm_ring(jp, jdk.dia_spmm_pallas_ring_mxu_padded(jp, xp),
                                                 128, layout_dtype=np.float32))
        y = tp.spmm(torch.from_numpy(x)).numpy()
        assert np.abs(y - y_kernel).max() / np.abs(y_kernel).max() < 5e-3
        assert _relerr(y, jconv.to_scipy(a).astype(np.float64) @ x) <= TOL[np.float32]


class TestScalarDia:
    @pytest.mark.parametrize("dof", [2, 4])
    def test_equals_the_reference_and_is_cached(self, dof, monkeypatch):
        plans = PlanCache()
        monkeypatch.setattr(spmv_mod, "default_plan_cache", plans)
        a_j = jgen.fem_blocks(6, dof=dof)
        a_t = tgen.fem_blocks(6, dof=dof)
        jp, tp = jbdia.bdia_plan(a_j, (dof, dof)), tbdia.bdia_plan(a_t, (dof, dof), device="cpu")
        js, ts = jbdia.bdia_scalar_dia(jp), tbdia.bdia_scalar_dia(tp)
        for f in ("vals", "rem_data", "rem_row", "rem_col"):
            jv, tv = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
            assert jv.dtype == tv.dtype and np.array_equal(jv, tv), f
        assert (ts.offsets, ts.shape) == (js.offsets, js.shape)
        # one plan per BDIA plan, held in the one cache
        assert tbdia.bdia_scalar_dia(tp) is ts and len(plans._plans) == 1
        tp.vals.mul_(2.0)  # a plan changed in place is planned anew
        t2 = tbdia.bdia_scalar_dia(tp)
        assert t2 is not ts and torch.equal(t2.vals, 2.0 * ts.vals)

    def test_remainder_plan(self):
        s = tconv.to_scipy(tgen.fem_blocks(6, dof=4)).tolil()
        rng = np.random.default_rng(16)
        for _ in range(6):
            bi, bj = int(rng.integers(0, 20)), int(rng.integers(0, 20))
            s[bi * 4 : bi * 4 + 4, bj * 4 : bj * 4 + 4] = rng.standard_normal((4, 4))
        s = s.tocsr()
        jp = jbdia.bdia_plan(jconv.from_scipy(s), (4, 4))
        tp = tbdia.bdia_plan(tconv.from_scipy(s), (4, 4), device="cpu")
        assert tp.rem_data.shape[0] > 0
        js, ts = jbdia.bdia_scalar_dia(jp), tbdia.bdia_scalar_dia(tp)
        assert np.array_equal(np.asarray(js.vals), ts.vals.numpy())
        assert np.array_equal(np.asarray(js.rem_data), ts.rem_data.numpy())


def _pack(shape, blocksize, block_offsets, seed, *, fill=0.9, ts=1, rem=None):
    """A BDIA plan built by hand: random slots, every one of the pack (the
    pad and the slots past the matrix's edges too), a share ``fill`` of
    them nonzero, and the remainder ``rem`` = (rows, cols, values)."""
    (m, n), (br, bc) = shape, blocksize
    rng = np.random.default_rng(seed)
    tiles = -(-(-(-m // br)) // (ts * 128))
    vals = rng.standard_normal((br, tiles, len(block_offsets) * bc, ts, 128))
    vals[rng.random(vals.shape) >= fill] = 0.0
    rows, cols, data = rem if rem is not None else ([], [], [])
    return tbdia.BdiaMatrix(
        vals=torch.from_numpy(vals), rem_data=torch.tensor(data, dtype=torch.float64),
        rem_row=torch.tensor(rows, dtype=torch.int32),
        rem_col=torch.tensor(cols, dtype=torch.int32), block_offsets=tuple(block_offsets),
        shape=(m, n), blocksize=(br, bc), ts=ts)


def _zero_blocks():
    p = _pack((400, 400), (4, 4), (-7, -1, 0, 1, 7), 41)
    v = p.vals.view(4, -1, 128)  # (r, slot rows, lane): whole blocks are r × one lane
    v[:, :, 5:40] = 0.0
    v[:, 3:9, :] = -0.0
    v[1, :, 50:60] = -0.0
    return p


def _sparse_diagonal():
    p = _pack((512, 512), (4, 4), (-2, 0, 3), 42)
    keep = np.random.default_rng(43).random((4, 1, 4, 1, 128)) < 0.02
    p.vals[:, :, 8:12] *= torch.from_numpy(keep)  # block offset 3: 2 % of its slots
    return p


def _remainder_entries():
    # block offset 3 spills (2 % full); the remainder holds an entry on a kept
    # diagonal's zero slot, one on a kept diagonal off the pack, one on a slot
    # of the pack three times (2.5 + 0.01 + 0.01: bf16 rounds that sum once,
    # to 2.515625, not after each add, to 2.5), one on a spilled lane's slot
    # twice, one on a spilled diagonal off the pack, two at a new offset that
    # sum to zero, and an explicit zero at a far offset
    p = _sparse_diagonal()
    p.vals[1, 0, 4 + 2, 0, 10] = 0.0  # block row 10, r=1, block offset 0, c=2: (41, 42)
    p.vals[0, 0, 4 + 1, 0, 20] = 2.5  # block row 20, r=0, block offset 0, c=1: (80, 81)
    rows = [41, 43, 80, 80, 80, 81, 81, 12, 44, 44, 7]
    cols = [42, 45, 81, 81, 81, 93, 93, 22, 48, 48, 500]
    data = [1.5, 3.0, 0.01, 0.01, -0.0, -2.0, 0.25, 7.0, 1.0, -1.0, 0.0]
    return dataclasses.replace(p, rem_data=torch.tensor(data, dtype=torch.float64),
                               rem_row=torch.tensor(rows, dtype=torch.int32),
                               rem_col=torch.tensor(cols, dtype=torch.int32))


def _threshold():
    # scalar diagonal 20 (block offset 5, its lanes r = c) holds 37 entries of
    # its 380: just under 10 %, so it spills; three remainder entries repeat
    # its positions and must not count again
    p = _pack((400, 400), (4, 4), (0, 5), 49)
    p.vals[:, :, 4:8] = 0.0
    for k in range(37):
        p.vals[k % 4, 0, 4 + k % 4, 0, k] = 1.0 + k
    rows, cols = [0, 5, 10], [20, 25, 30]
    return dataclasses.replace(p, rem_data=torch.tensor([0.5, 0.25, -1.0], dtype=torch.float64),
                               rem_row=torch.tensor(rows, dtype=torch.int32),
                               rem_col=torch.tensor(cols, dtype=torch.int32))


def _nan_slots():
    p = _zero_blocks()
    p.vals.view(4, -1, 128)[2, 0, 70] = float("nan")
    return p


SCALAR_DIA_CASES = {  # name -> BDIA plan on the CPU in f64
    "fem2": lambda: tbdia.bdia_plan(tgen.fem_blocks(9, dof=2), (2, 2), device="cpu"),
    "fem3": lambda: tbdia.bdia_plan(tgen.fem_blocks(9, dof=3), (3, 3), device="cpu"),
    "fem4": lambda: tbdia.bdia_plan(tgen.fem_blocks(9, dof=4), (4, 4), device="cpu"),
    "ragged": lambda: _pack((301, 301), (4, 4), (-3, -1, 0, 2, 40), 44),
    "ragged_two_tiles": lambda: _pack((1197, 1197), (3, 3), (-5, 0, 1, 200), 45, ts=2),
    "rectangular": lambda: _pack((240, 410), (4, 2), (-3, 0, 2, 50, 150), 46),
    "rectangular_tall": lambda: _pack((410, 150), (2, 4), (-60, -1, 0, 5), 47),
    "rectangular_three_tiles": lambda: _pack((1500, 700), (4, 2), (-5, 0, 3, 100), 50),
    "zero_blocks_neg_zero": _zero_blocks,
    "nan_slots": _nan_slots,
    "sparse_diagonal": _sparse_diagonal,
    "remainder_entries": _remainder_entries,
    "threshold_remainder": _threshold,
    "bdia_plan_remainder": lambda: tbdia.bdia_plan(tconv.from_scipy(_with_remainder()), (4, 4),
                                                   device="cpu"),
    # 64 block offsets of 16 × 16 blocks: 1039 scalar diagonals, over 1024 of them full
    # enough, so the plan keeps the 1024 fullest
    "max_diags": lambda: _pack((1280, 1280), (16, 16), range(-32, 32), 48),
}


def _bits(t: torch.Tensor) -> torch.Tensor:
    if not t.is_floating_point():
        return t
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def _same_plan(got, want):
    """Field for field, values bit for bit (so a −0.0 or a NaN's bits count)."""
    for f in ("vals", "rem_data", "rem_row", "rem_col"):
        g, w = getattr(got, f), getattr(want, f)
        assert (g.dtype, g.shape, g.device) == (w.dtype, w.shape, w.device), f
        assert torch.equal(_bits(g), _bits(w)), f
    assert (got.offsets, got.shape, got.vals_t, want.vals_t) == \
        (want.offsets, want.shape, None, None)


class TestScalarDiaFromPack:
    """The derivation on the pack's device against the host composition it
    replaces, ``dia_plan(coo_to_csr(bdia_to_coo(a)))``."""

    @pytest.mark.parametrize("dtype", [torch.float64, torch.float32, torch.bfloat16,
                                       torch.float16])
    @pytest.mark.parametrize("name", list(SCALAR_DIA_CASES))
    def test_equals_the_host_composition(self, name, dtype):
        a = SCALAR_DIA_CASES[name]().astype(dtype)
        want = tdia.dia_plan(tconv.coo_to_csr(tbdia.bdia_to_coo(a)),
                             device=a.device).astype(a.dtype)
        _same_plan(tbdia.scalar_dia_from_pack(a), want)

    @pytest.mark.parametrize("name", ["ragged_two_tiles", "rectangular_three_tiles", "fem4"])
    def test_counts_one_tile_a_chunk(self, name, monkeypatch):
        monkeypatch.setattr(tbdia, "_COUNT_SLOTS", 1)
        a = SCALAR_DIA_CASES[name]()
        want = tdia.dia_plan(tconv.coo_to_csr(tbdia.bdia_to_coo(a)), device="cpu")
        _same_plan(tbdia.scalar_dia_from_pack(a), want)

    def test_cases_reach_what_they_name(self):
        def host(name):
            a = SCALAR_DIA_CASES[name]()
            return a, tdia.dia_plan(tconv.coo_to_csr(tbdia.bdia_to_coo(a)), device="cpu")

        a, d = host("max_diags")
        assert d.ndiags == 1024 and len(np.unique(tbdia.bdia_to_coo(a).col.astype(np.int64)
                                                  - tbdia.bdia_to_coo(a).row)) > 1024
        _, d = host("sparse_diagonal")
        assert d.rem_data.shape[0] > 0 and not {10, 11, 12, 13, 14} & set(d.offsets)
        _, d = host("remainder_entries")
        at = {(int(i), int(k)): float(v) for i, k, v in zip(d.rem_row, d.rem_col, d.rem_data)}
        assert at[44, 48] == 0.0 and at[7, 500] == 0.0 and at[12, 22] == 7.0
        assert (81, 93) in at and 12 not in d.offsets
        assert [float(d.vals[d.offsets.index(o), i]) for o, i in ((1, 41), (2, 43), (1, 80))] \
            == [1.5, 3.0, 0.0 + 2.5 + 0.01 + 0.01 - 0.0]
        _, d = host("threshold_remainder")
        assert 20 not in d.offsets and int(((d.rem_col - d.rem_row) == 20).sum()) == 37
        a, d = host("zero_blocks_neg_zero")
        assert (a.vals == 0).any() and torch.signbit(a.vals[a.vals == 0]).any()
        assert not (torch.signbit(d.vals) & (d.vals == 0)).any()

    def test_the_cache_builds_without_the_host_composition(self, monkeypatch):
        def refuse(*args, **kwargs):
            raise AssertionError("the host composition ran in a cached build")

        a = SCALAR_DIA_CASES["fem4"]()
        want = tdia.dia_plan(tconv.coo_to_csr(tbdia.bdia_to_coo(a)), device="cpu")
        for mod, name in ((tbdia, "bdia_to_coo"), (tconv, "coo_to_csr"), (tdia, "dia_plan")):
            monkeypatch.setattr(mod, name, refuse)
        _same_plan(PlanCache().get(a), want)


def _blocks_on(nb, b, offsets, seed):
    """A scipy matrix of random b×b blocks on the given block offsets."""
    rng = np.random.default_rng(seed)
    s = sp.lil_matrix((nb * b, nb * b))
    for i in range(nb):
        for d in offsets:
            if 0 <= i + d < nb:
                s[i * b : (i + 1) * b, (i + d) * b : (i + d + 1) * b] = rng.standard_normal((b, b))
    return s.tocsr()


def _with_remainder():
    """fem_blocks(8, dof=4) plus scattered 4×4 blocks that spill to the COO
    remainder."""
    s = tconv.to_scipy(tgen.fem_blocks(8, dof=4)).tolil()
    rng = np.random.default_rng(16)
    for _ in range(6):
        bi, bj = int(rng.integers(0, 64)), int(rng.integers(0, 64))
        s[bi * 4 : bi * 4 + 4, bj * 4 : bj * 4 + 4] = rng.standard_normal((4, 4))
    return s.tocsr()


BDIA_CASES = {  # name -> (scipy f64, blocksize)
    "fem2": lambda: (tconv.to_scipy(tgen.fem_blocks(8, dof=2)), 2),
    "fem3_ragged": lambda: (tconv.to_scipy(tgen.fem_blocks(7, dof=3)), 3),
    "remainder": lambda: (_with_remainder(), 4),
    "84_pairs": lambda: (_blocks_on(64, 4, range(-10, 11), 3), 4),
    "81_pairs_b3": lambda: (_blocks_on(64, 3, range(-13, 14), 5), 3),  # no slab, no ring
    "offset_1100": lambda: (_blocks_on(1200, 2, (-1100, 0, 1100), 4), 2),
}


def _bdia_plans(name, dtype=np.float64):
    """(reference BDIA plan, port BDIA plan on the CPU, scipy)."""
    s, b = BDIA_CASES[name]()
    s = s.astype(dtype)
    jp = jbdia.bdia_plan(jconv.csr_to_bsr(jconv.from_scipy(s), (b, b)), (b, b))
    tp = tbdia.bdia_plan(tconv.csr_to_bsr(tconv.from_scipy(s), (b, b)), (b, b), device="cpu")
    return jp, tp, s


class TestRingTwin:
    @pytest.mark.parametrize("name,k", [("remainder", 128), ("fem3_ragged", 65)])
    def test_matches_the_reference_ring_kernel(self, name, k):
        # B4 (bdia_spmm_pallas_ring), the remainder left out by both
        jp, tp, s = _bdia_plans(name)
        x = _X(s.shape[1], k, seed=21)
        y_ref = np.asarray(jbk.bdia_spmm_pallas_ring(jp, jnp.asarray(x)))
        y = bdia_spmm_ring(tp, torch.from_numpy(x))
        assert y.shape == y_ref.shape and _relerr(y, y_ref) <= 1e-12
        rem = sp.csr_matrix((tp.rem_data.numpy(), (tp.rem_row.numpy(), tp.rem_col.numpy())),
                            shape=s.shape)
        assert _relerr(y.numpy() + rem @ x, s @ x) <= 1e-12

    def test_types(self):
        _, tp, s = _bdia_plans("fem2", np.float32)
        x = torch.from_numpy(_X(s.shape[1], 70, np.float32, seed=22))
        y = bdia_spmm_ring(tp, x)
        assert y.dtype == torch.float32
        assert _relerr(y, s @ x.double().numpy()) <= TOL[np.float32]
        assert bdia_spmm_ring(tp, x, out_dtype=np.float64).dtype == torch.float64

    @pytest.mark.parametrize("name", list(BDIA_CASES))
    @pytest.mark.parametrize("k", [8, 128, 600])
    def test_mm_ok_equals_the_reference(self, name, k):
        jp, tp, _ = _bdia_plans(name)
        assert bdia_mm_ok(tp, k) == jbk.bdia_mm_ok(jp, k)


class TestDispatch:
    @pytest.mark.parametrize("method", ["slab", "pallas_bdia", "pallas_bsr"])
    @pytest.mark.parametrize("k", [65, 128])
    def test_wide_k_methods_match_the_reference(self, method, k, monkeypatch):
        # each explicit kernel runs (its twin on the CPU) and equals the
        # reference's spmm, with the BSR auto route forced on off the TPU
        monkeypatch.setattr(jspmv_mod, "_AUTO_BSR_PLAN_FORCE", True)
        a_j = jgen.fem_blocks(8, dof=4, return_bsr=True)
        a_t = tgen.fem_blocks(8, dof=4, return_bsr=True)
        if method == "pallas_bsr":
            j, t = a_j, a_t
        else:
            j, t = jbdia.bdia_plan(a_j), tbdia.bdia_plan(a_t, device="cpu")
        x = _X(a_j.shape[1], k, seed=23)
        y_ref = np.asarray(jax_spmm(j, jnp.asarray(x), method=method))
        y = spmm(t, torch.from_numpy(x), method=method)
        assert _relerr(y, y_ref) <= 1e-12
        assert _relerr(y, jconv.to_scipy(a_j) @ x) <= 1e-12

    @pytest.mark.parametrize("method,name", [("slab", "fem3_ragged"),
                                             ("pallas_bdia", "offset_1100"),
                                             ("pallas_bdia", "84_pairs")])
    def test_explicit_kernel_refuses_a_plan_it_cannot_take(self, method, name):
        # ROADMAP Queue C 2: no silent fallback from an explicit kernel at
        # k > 64; at k ≤ 64 both methods run scalar DIA, as the reference does
        jp, tp, s = _bdia_plans(name)
        with pytest.raises(ValueError, match=method):
            spmm(tp, torch.from_numpy(_X(s.shape[1], 65, seed=24)), method=method)
        x = _X(s.shape[1], 8, seed=25)
        y = spmm(tp, torch.from_numpy(x), method=method)
        assert _relerr(y, np.asarray(jax_spmm(jp, jnp.asarray(x), method=method))) <= 1e-12
        assert _relerr(y, s @ x) <= 1e-12

    @pytest.mark.parametrize("name,route", [("fem3_ragged", "ring"), ("81_pairs_b3", "scalar_dia"),
                                            ("remainder", "slab")])
    def test_auto_wide_k_chain(self, name, route, monkeypatch):
        # slab where the slab gates admit a plan, else the ring where its
        # gate does, else scalar DIA; the remainder is added once
        plans = PlanCache()
        monkeypatch.setattr(spmv_mod, "default_plan_cache", plans)
        _, tp, s = _bdia_plans(name)
        x = _X(s.shape[1], 100, seed=26)
        y = spmm(tp, torch.from_numpy(x))
        assert _relerr(y, s @ x) <= 1e-12
        has_slab = plans.get(tp, "slab") is not None
        assert (has_slab, bdia_mm_ok(tp, 100)) == {"slab": (True, True), "ring": (False, True),
                                                   "scalar_dia": (False, False)}[route]
        # the slab entry (a plan or a cached None), plus scalar DIA's when it ran
        assert set(plans._plans[tp]) == ({"slab", "scalar_dia"} if route == "scalar_dia"
                                         else {"slab"})

    def test_held_slab_operand(self):
        a = tgen.fem_blocks(8, dof=4, return_bsr=True)
        sl = tslab.bdia_slab_plan(tbdia.bdia_plan(a, device="cpu"), 8)
        x = _X(a.shape[1], 12, seed=27)
        s = tconv.to_scipy(a)
        assert _relerr(spmm(sl, torch.from_numpy(x)), s @ x) <= 1e-12
        assert spmm(sl, torch.from_numpy(x), accum_dtype=np.float64).dtype == torch.float64
        with pytest.raises(ValueError, match="transpose"):
            spmm(sl, torch.from_numpy(x), transpose=True)

    def test_rejects_bad_arguments(self):
        _, t = _pair("csr")
        with pytest.raises(ValueError):
            spmm(t, torch.zeros(t.shape[1], dtype=torch.float64))
        with pytest.raises(ValueError):
            spmm(t, torch.zeros((t.shape[1] + 1, 2), dtype=torch.float64))
        with pytest.raises(ValueError):
            spmm(t, torch.zeros((t.shape[1], 2), dtype=torch.float64), method="ell")
        with pytest.raises(TypeError):
            spmm(np.eye(3), torch.zeros((3, 2)))

    @pytest.mark.parametrize("k", [8, 100])
    @pytest.mark.parametrize("transpose", [False, True])
    def test_bdia_plan_operand_matches_the_reference(self, k, transpose):
        # scalar DIA at k = 8, the slab at k = 100 (the reference off the TPU
        # takes scalar DIA at both)
        a_j, a_t = jgen.fem_blocks(6, dof=2), tgen.fem_blocks(6, dof=2)
        jp, tp = jbdia.bdia_plan(a_j, (2, 2)), tbdia.bdia_plan(a_t, (2, 2), device="cpu")
        x = _X(a_j.shape[0], k, seed=11)
        y_ref = np.asarray(jax_spmm(jp, jnp.asarray(x), transpose=transpose))
        y = spmm(tp, torch.from_numpy(x), transpose=transpose)
        assert _relerr(y, y_ref) <= 1e-12
        s = jconv.to_scipy(a_j)
        assert _relerr(y, (s.T if transpose else s) @ x) <= 1e-12

    @pytest.mark.parametrize("transpose", [False, True])
    def test_dia_operand_and_method_dia_match_the_reference(self, transpose):
        s = DIA_CASES["rect_wide"]()
        j, t = jconv.from_scipy(s), tconv.from_scipy(s)
        jp, tp = jdia.dia_plan(j), tdia.dia_plan(t, device="cpu")
        x = _X(s.shape[0] if transpose else s.shape[1], 12, seed=12)
        y_ref = np.asarray(jax_spmm(jp, jnp.asarray(x), transpose=transpose))
        xt = torch.from_numpy(x)
        for y in (spmm(tp, xt, transpose=transpose), spmm(t, xt, transpose=transpose,
                                                          method="dia")):
            assert _relerr(y, y_ref) <= 1e-12

    @pytest.mark.parametrize("fmt", ["csr", "bsr"])
    def test_cpu_tensors_take_the_gather_route(self, fmt, monkeypatch):
        # the auto route plans only for a matrix on a CUDA device
        plans = PlanCache()
        monkeypatch.setattr(spmv_mod, "default_plan_cache", plans)
        j, t = _pair(fmt)
        x = _X(j.shape[1], 6, seed=13)
        y = spmm(t.to("cpu"), torch.from_numpy(x))
        assert len(plans._plans) == 0
        assert _relerr(y, np.asarray(jax_spmm(j, x))) <= 1e-12
