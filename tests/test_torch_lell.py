"""Parity of the port's lane-bucketed ELL (LELL) plans and products with the
JAX package, on the CPU (the kernel on the card: tests/test_torch_gpu.py).

The reference's kernel (B18, ``lell_spmv_pallas`` through ``_lell_call``)
runs in interpret mode, as tests/test_pallas_kernels.py::TestLell runs it.
The packed arrays must equal the reference's exactly.  Tolerances: f64
≤ 1e-12 normwise against the reference and scipy; f32 ≤ 1e-5 against scipy.
"""

import jax  # noqa: F401  (kept on the CPU with x64 by conftest)
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cask_tpu.formats.convert as jconv
import cask_tpu.formats.generate as jgen
from cask_tpu.ops.pallas import lell_kernels as jlell
import cask_tpu_torch.formats.convert as tconv
from cask_tpu_torch import interop
import dataclasses

from cask_tpu_torch.ops.kernels.lell_kernels import (lell_lane_sums, lell_lane_sums_reference,
                                                     lell_spmv, lell_spmv_reference)
from cask_tpu_torch.ops.lell import lell_plan, lell_plan_hyb

TOL = {np.float32: 1e-5, np.float64: 1e-12}
CPU = torch.device("cpu")


def _relerr(y, ref):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(y - ref) / np.linalg.norm(ref)


MATRICES = {  # name -> scipy f64 CSR
    "uniform": lambda: jconv.to_scipy(jgen.random_uniform(2000, density=0.008, seed=3)),
    "power_law": lambda: jconv.to_scipy(jgen.power_law(3000, avg_degree=10, seed=6)),
    "rectangle": lambda: jconv.to_scipy(jgen.random_uniform(1500, 900, density=0.01, seed=7)),
    "stencil": lambda: jconv.to_scipy(jgen.stencil_2d(40)),
}


@pytest.fixture(scope="module")
def mats():
    return {name: make() for name, make in MATRICES.items()}


def _same_lell(j, t):
    for f in ("vals", "idx", "rem_data", "rem_row", "rem_col"):
        a, b = np.asarray(getattr(j, f)), getattr(t, f).numpy()
        np.testing.assert_array_equal(b, a, err_msg=f)
        assert b.dtype == a.dtype, f
    assert (t.shape, t.groups, t.layers, t.s_pad, t.bucket) == (j.shape, j.groups, j.layers,
                                                                j.s_pad, j.bucket)


def _same_hyb(j, t):
    _same_lell(j.main, t.main)
    for f in ("vals", "idx", "slot2row"):
        a, b = np.asarray(getattr(j.hub, f)), getattr(t.hub, f).numpy()
        np.testing.assert_array_equal(b, a, err_msg=f"hub.{f}")
        assert b.dtype == a.dtype, f
    assert t.traffic_bytes == j.traffic_bytes


class TestPlan:
    @pytest.mark.parametrize("name", list(MATRICES))
    @pytest.mark.parametrize("groups", [1, 4, 8, 16])
    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_lell_plan_equals_the_reference(self, mats, name, groups, dtype):
        s = mats[name].astype(dtype)
        _same_lell(jlell.lell_plan(jconv.from_scipy(s), groups=groups),
                   lell_plan(tconv.from_scipy(s), groups=groups, device=CPU))

    def test_max_layers_spill_equals_the_reference(self, mats):
        s = mats["power_law"]
        j = jlell.lell_plan(jconv.from_scipy(s), max_layers=2, groups=8)
        t = lell_plan(tconv.from_scipy(s), max_layers=2, groups=8, device=CPU)
        assert t.rem_data.shape[0] > 0
        _same_lell(j, t)

    @pytest.mark.parametrize("name", list(MATRICES))
    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_lell_plan_hyb_equals_the_reference(self, mats, name, dtype):
        s = mats[name].astype(dtype)
        _same_hyb(jlell.lell_plan_hyb(jconv.from_scipy(s)),
                  lell_plan_hyb(tconv.from_scipy(s), device=CPU))

    def test_hyb_parameters_equal_the_reference(self, mats):
        s = mats["power_law"]
        kw = dict(groups=4, max_layers=3, chunk_layers=2)
        _same_hyb(jlell.lell_plan_hyb(jconv.from_scipy(s), **kw),
                  lell_plan_hyb(tconv.from_scipy(s), device=CPU, **kw))

    def test_groups_must_divide_128(self, mats):
        with pytest.raises(ValueError):
            lell_plan(tconv.from_scipy(mats["uniform"]), groups=3, device=CPU)

    def test_from_arrays_round_trips(self, mats):
        j = jlell.lell_plan_hyb(jconv.from_scipy(mats["power_law"]))
        m = j.main
        t = interop.hyb_from_arrays(m.vals, m.idx, m.rem_data, m.rem_row, m.rem_col,
                                    j.hub.vals, j.hub.idx, j.hub.slot2row, shape=j.shape,
                                    groups=m.groups, device=CPU)
        _same_hyb(j, t)
        tl = interop.lell_from_arrays(m.vals, m.idx, m.rem_data, m.rem_row, m.rem_col,
                                      shape=m.shape, groups=m.groups, device=CPU)
        _same_lell(m, tl)
        with pytest.raises(ValueError):
            interop.lell_from_arrays(m.vals, np.asarray(m.idx)[:, :-1], m.rem_data, m.rem_row,
                                     m.rem_col, shape=m.shape, groups=m.groups, device=CPU)
        with pytest.raises(ValueError):
            interop.hyb_from_arrays(m.vals, m.idx, m.rem_data, m.rem_row, m.rem_col,
                                    j.hub.vals, j.hub.idx, np.asarray(j.hub.slot2row)[1:],
                                    shape=j.shape, groups=m.groups, device=CPU)


class TestProducts:
    @pytest.mark.parametrize("name", list(MATRICES))
    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_twins_equal_scipy(self, mats, name, dtype):
        s = mats[name].astype(dtype)
        x = np.random.default_rng(1).standard_normal(s.shape[1]).astype(dtype)
        ref = s.astype(np.float64) @ x
        a = tconv.from_scipy(s)
        for g in (1, 4, 8, 16):
            y = lell_plan(a, groups=g, device=CPU).spmv(torch.from_numpy(x))
            assert _relerr(y, ref) <= TOL[dtype]
        h = lell_plan_hyb(a, device=CPU)
        assert _relerr(h.spmv(torch.from_numpy(x)), ref) <= TOL[dtype]
        torch.testing.assert_close(h._spmv_reference(torch.from_numpy(x)),
                                   h.spmv(torch.from_numpy(x)), rtol=0, atol=0)

    @pytest.mark.parametrize("groups", [4, 8, 16])
    def test_grouped_matches_the_reference(self, mats, groups):
        s = mats["uniform"]
        x = np.random.default_rng(0).standard_normal(s.shape[1])
        y_ref = np.asarray(jlell.lell_plan(jconv.from_scipy(s), groups=groups)
                           .spmv(jnp.asarray(x)))
        y = lell_plan(tconv.from_scipy(s), groups=groups, device=CPU).spmv(torch.from_numpy(x))
        assert _relerr(y, y_ref) <= 1e-12
        assert _relerr(y, s @ x) <= 1e-12

    def test_hyb_matches_the_reference(self, mats):
        s = mats["power_law"]
        x = np.random.default_rng(1).standard_normal(s.shape[1])
        j = jlell.lell_plan_hyb(jconv.from_scipy(s))
        t = lell_plan_hyb(tconv.from_scipy(s), device=CPU)
        assert t.hub.vals.shape[1] > 0  # the hub tier runs
        y = t.spmv(torch.from_numpy(x))
        assert _relerr(y, np.asarray(j.spmv(jnp.asarray(x)))) <= 1e-12
        assert _relerr(y, s @ x) <= 1e-12
        # the hub tier's lane sums against the reference's (G = 1)
        xt = torch.from_numpy(x)
        sums = lell_lane_sums(t.hub.vals, t.hub.idx, xt, 1).reshape(-1)
        ref = np.asarray(jlell._lell_lane_sums(j.hub, jnp.asarray(x)))
        assert _relerr(sums, ref) <= 1e-12

    def test_lane_sums_twin_reads_x_as_zero_past_n(self):
        # slot indices whose bucket position idx·B + b lands at or past n
        vals = torch.ones((1, 1, 128), dtype=torch.float64)
        idx = torch.zeros((1, 1, 128), dtype=torch.int32)
        idx[0, 0, 64:] = 1  # B = 64 at G = 2: positions 64 + b, all >= n = 100 from b = 36
        x = torch.arange(100, dtype=torch.float64)
        out = lell_lane_sums_reference(vals, idx, x, 2)
        assert out.shape == (1, 2)
        assert float(out[0, 0]) == float(x[:64].sum())
        assert float(out[0, 1]) == float(x[64:100].sum())


class TestEdgeTiers:
    """The tiers the CUDA kernels' edges are made of, through the entry on the
    CPU (the plain twin) against the reference and scipy."""

    @pytest.mark.parametrize("groups", [2, 32, 64, 128])
    def test_every_group_count_matches_the_reference(self, mats, groups):
        s = mats["power_law"]
        x = np.random.default_rng(5).standard_normal(s.shape[1])
        j = jlell.lell_plan(jconv.from_scipy(s), groups=groups)
        t = lell_plan(tconv.from_scipy(s), groups=groups, device=CPU)
        _same_lell(j, t)
        y = t.spmv(torch.from_numpy(x))
        assert y.shape == (s.shape[0],)
        assert _relerr(y, np.asarray(j.spmv(jnp.asarray(x)))[: s.shape[0]]) <= 1e-12
        assert _relerr(y, s @ x) <= 1e-12

    def test_one_layer_spills_the_rest_to_the_remainder(self, mats):
        s = mats["power_law"]
        x = np.random.default_rng(6).standard_normal(s.shape[1])
        t = lell_plan(tconv.from_scipy(s), max_layers=1, device=CPU)
        assert t.layers == 1 and t.rem_data.shape[0] > 0
        _same_lell(jlell.lell_plan(jconv.from_scipy(s), max_layers=1), t)
        assert _relerr(t.spmv(torch.from_numpy(x)), s @ x) <= 1e-12

    def test_trailing_padding_layers_change_nothing(self, mats):
        s = mats["uniform"]
        x = torch.from_numpy(np.random.default_rng(7).standard_normal(s.shape[1]))
        t = lell_plan(tconv.from_scipy(s), device=CPU)
        pad = torch.zeros((2,) + tuple(t.vals.shape[1:]), dtype=t.vals.dtype)
        padded = dataclasses.replace(t, vals=torch.cat([t.vals, pad]),
                                     idx=torch.cat([t.idx, pad.int()]))
        assert padded.layers == t.layers + 2
        torch.testing.assert_close(padded.spmv(x), t.spmv(x), rtol=0, atol=0)

    def test_a_cut_tier_leaves_the_rows_past_it_zero(self, mats):
        # 61 slot rows: not a multiple of the eight a kernel block takes
        s = mats["uniform"]
        x = np.random.default_rng(8).standard_normal(s.shape[1])
        t = lell_plan(tconv.from_scipy(s), device=CPU)
        keep = t.rem_row < 61 * t.groups
        cut = dataclasses.replace(t, vals=t.vals[:, :61], idx=t.idx[:, :61],
                                  rem_data=t.rem_data[keep], rem_row=t.rem_row[keep],
                                  rem_col=t.rem_col[keep])
        y = cut.spmv(torch.from_numpy(x)).numpy()
        rows = 61 * t.groups
        assert y.shape == (s.shape[0],) and not y[rows:].any()
        assert _relerr(y[:rows], (s @ x)[:rows]) <= 1e-12

    def test_entry_without_a_hub_tier_is_the_grouped_product(self, mats):
        s = mats["rectangle"]
        x = torch.from_numpy(np.random.default_rng(9).standard_normal(s.shape[1]))
        h = lell_plan_hyb(tconv.from_scipy(s), device=CPU)
        torch.testing.assert_close(lell_spmv(h.main, None, x), h.main.spmv(x), rtol=0, atol=0)
        torch.testing.assert_close(lell_spmv(h.main, h.hub, x), h.spmv(x), rtol=0, atol=0)
        torch.testing.assert_close(lell_spmv_reference(h.main, h.hub, x), h.spmv(x), rtol=0,
                                   atol=0)


def test_port_runs_a_plan_wider_than_the_reference_cap():
    # the reference kernel holds x in at most 4096 bucket rows (_SB_CAP):
    # n <= 4096·B, 65,536 columns at groups = 8 (B = 16); the port has no cap
    s = jconv.to_scipy(jgen.random_uniform(500, 70_000, density=2e-4, seed=43))
    x = np.random.default_rng(2).standard_normal(s.shape[1])
    j = jlell.lell_plan(jconv.from_scipy(s), groups=8)
    with pytest.raises(ValueError, match="slot-chunk cap"):
        j.spmv(jnp.asarray(x))
    for g in (8, 16):
        t = lell_plan(tconv.from_scipy(s), groups=g, device=CPU)
        assert _relerr(t.spmv(torch.from_numpy(x)), s @ x) <= 1e-12
    h = lell_plan_hyb(tconv.from_scipy(s), device=CPU)
    assert _relerr(h.spmv(torch.from_numpy(x)), s @ x) <= 1e-12


def test_trailing_empty_rows_give_a_full_length_result():
    # rows past the last packed slot row: the reference returns y short (its
    # slot rows stop at the last nonempty group); the port pads y to m
    s = sp.random(2000, 500, density=0.01, format="csr", random_state=1).tolil()
    s[1200:, :] = 0
    s = s.tocsr()
    x = np.random.default_rng(3).standard_normal(500)
    y_ref = np.asarray(jlell.lell_plan(jconv.from_scipy(s), groups=8).spmv(jnp.asarray(x)))
    assert y_ref.shape[0] < 2000  # the reference's fault, kept as it is
    y = lell_plan(tconv.from_scipy(s), groups=8, device=CPU).spmv(torch.from_numpy(x))
    assert y.shape == (2000,)
    assert _relerr(y, s @ x) <= 1e-12
    np.testing.assert_allclose(y.numpy()[: y_ref.shape[0]], y_ref, rtol=1e-12, atol=1e-12)
