"""Parity of the port's panel one-hot (POH) plan and products with the JAX
package, on the CPU (the kernels on the card: tests/test_torch_gpu.py).

The reference's kernels (B16 ``poh_spmv_pallas``, B17 ``poh_spmm_pallas``)
run in interpret mode, as tests/test_poh.py runs them; each call costs about
a second there, so the reference's products are taken once per module on
one matrix and shared.  The packed arrays must equal the reference's
exactly (its ``rloc_t``, a TPU layout, is not carried).  Tolerances: f64
≤ 1e-12 against the reference and scipy; f32 ≤ 1e-5 normwise against scipy.
"""

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
import cask_tpu.solvers as jsolvers
from cask_tpu import spmm as jspmm
from cask_tpu import spmv as jspmv
from cask_tpu.ops.pallas import poh_kernels as jpoh
import cask_tpu_torch as ct
import cask_tpu_torch.formats.convert as tconv
from cask_tpu_torch import interop
from cask_tpu_torch.formats.generate import _diag_shift
from cask_tpu_torch.ops.kernels.poh_kernels import poh_spmm, poh_spmv
from cask_tpu_torch.ops.poh import poh_plan, poh_to_coo, poh_transpose_plan
from cask_tpu_torch.utils.debug import check_poh

TOL = {np.float32: 1e-5, np.float64: 1e-12}
CPU = torch.device("cpu")


def _relerr(y, ref):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    den = np.linalg.norm(ref)
    return np.linalg.norm(y - ref) / den if den else np.linalg.norm(y)


def _holes():
    s = jconv.to_scipy(jgen.random_uniform(400, 400, density=0.02, seed=8)).tolil()
    s[100:200, :] = 0
    s[:, 100:200] = 0
    return s.tocsr()


def _column():
    m = 2000
    return sp.csr_matrix((np.random.default_rng(0).standard_normal(m),
                          (np.arange(m), np.full(m, 7))), shape=(m, m))


MATRICES = {  # name -> scipy f64 CSR: tests/test_poh.py's edges, at most 3000 rows
    "power_law": lambda: jconv.to_scipy(jgen.power_law(3000, avg_degree=10, seed=1)),
    "wide": lambda: jconv.to_scipy(jgen.random_uniform(2000, 2700, density=0.003, seed=2)),
    "tall": lambda: jconv.to_scipy(jgen.random_uniform(2700, 1100, density=0.003, seed=3)),
    "banded": lambda: jconv.to_scipy(jgen.banded(2000, 9, seed=4)),
    "dense_column": _column,
    "empty_rows_cols": _holes,
    "all_zero": lambda: sp.csr_matrix((300, 500)),
    "n_below_window": lambda: jconv.to_scipy(jgen.random_uniform(3000, 300, density=0.01,
                                                                 seed=7)),
    "50x70": lambda: jconv.to_scipy(jgen.random_uniform(50, 70, density=0.05, seed=6)),
}
PLAN_KW = [{}, {"row_panel": 1024}, {"col_window": 512}, {"tile_slots": 1024},
           {"row_panel": 8192, "tile_slots": 4096}]
FIELDS = ("vals", "cloc", "rloc", "wlo", "whi", "panel", "first", "last")


@pytest.fixture(scope="module")
def mats():
    return {name: make() for name, make in MATRICES.items()}


def _plans(s, dtype, **kw):
    s = s.astype(dtype)
    return (jpoh.poh_plan(jconv.from_scipy(s), **kw),
            poh_plan(tconv.from_scipy(s), device=CPU, **kw))


def _assert_same_pack(j, t):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                      err_msg=f)
        assert getattr(t, f).numpy().dtype == np.asarray(getattr(j, f)).dtype, f
    assert (t.shape, t.row_panel, t.col_window) == (j.shape, j.row_panel, j.col_window)
    assert (t.ntiles, t.slot_rows, t.n_panels, t.nseg) == (j.ntiles, j.slot_rows,
                                                           j.n_panels, j.nseg)
    assert t.fill() == pytest.approx(j.fill())


class TestPlan:
    @pytest.mark.parametrize("name", list(MATRICES))
    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_pack_equals_the_reference(self, mats, name, dtype):
        _assert_same_pack(*_plans(mats[name], dtype))

    @pytest.mark.parametrize("kw", PLAN_KW[1:], ids=lambda kw: ",".join(f"{k}={v}" for k, v
                                                                        in kw.items()))
    def test_plan_parameters_equal_the_reference(self, mats, kw):
        _assert_same_pack(*_plans(mats["power_law"], np.float64, **kw))

    def test_mtx_graph_packs_like_the_reference(self):
        from cask_tpu.formats.mtx import read_mtx as jread

        path = Path(__file__).parent / "data" / "graph_pattern_120.mtx"
        j = jpoh.poh_plan(jread(str(path)))
        t = poh_plan(ct.read_mtx(path), device=CPU)
        _assert_same_pack(j, t)

    def test_panel_ptr_bounds_each_panels_tiles(self, mats):
        _, t = _plans(mats["power_law"], np.float64, row_panel=1024)
        ptr = t.panel_ptr.numpy()
        panel = t.panel.numpy()
        assert ptr[0] == 0 and ptr[-1] == t.ntiles and ptr.shape == (t.n_panels + 1,)
        for i in range(t.n_panels):
            assert (panel[ptr[i]:ptr[i + 1]] == i).all() and ptr[i + 1] > ptr[i]

    def test_traffic_counts_what_the_kernel_reads(self, mats):
        j, t = _plans(mats["power_law"], np.float32)
        m, n = t.shape
        assert t.traffic_bytes == t.vals.numel() * 12 + t.ntiles * 4 + (m + n) * 4
        # the reference also streams rloc_t: 4 bytes more per slot
        assert j.traffic_bytes - t.vals.numel() * 4 == t.traffic_bytes - t.ntiles * 4

    def test_to_coo_and_transpose_plan_equal_the_reference(self, mats):
        j, t = _plans(mats["wide"], np.float64)
        jc, tc = jpoh.poh_to_coo(j), poh_to_coo(t)
        for f in ("data", "row", "col"):
            np.testing.assert_array_equal(getattr(tc, f), np.asarray(getattr(jc, f)))
        _assert_same_pack(jpoh.poh_transpose_plan(j), poh_transpose_plan(t))

    def test_check_poh_passes_a_good_pack_and_catches_a_bad_one(self, mats):
        a = tconv.from_scipy(mats["power_law"])
        p = poh_plan(a, device=CPU)
        check_poh(p, a)
        with pytest.raises(AssertionError, match="2C window"):
            check_poh(dataclasses.replace(p, cloc=p.cloc + 10_000))
        with pytest.raises(AssertionError, match="local row"):
            check_poh(dataclasses.replace(p, rloc=p.rloc - 1 - p.rloc.max()))
        bad_vals = p.vals.clone()
        bad_vals.view(-1)[int(torch.nonzero(bad_vals.view(-1))[0])] += 1.0
        with pytest.raises(AssertionError, match="reconstruct"):
            check_poh(dataclasses.replace(p, vals=bad_vals), a)

    def test_from_arrays_round_trips(self, mats):
        j, t = _plans(mats["tall"], np.float64)
        c = interop.poh_from_arrays(*(np.asarray(getattr(j, f)) for f in FIELDS),
                                    shape=j.shape, row_panel=j.row_panel,
                                    col_window=j.col_window, device=CPU)
        _assert_same_pack(j, c)
        torch.testing.assert_close(c.panel_ptr, t.panel_ptr)
        with pytest.raises(ValueError):
            interop.poh_from_arrays(*(np.asarray(getattr(j, f)) for f in FIELDS[:3]),
                                    np.asarray(j.wlo)[:-1], *(np.asarray(getattr(j, f))
                                                              for f in FIELDS[4:]),
                                    shape=j.shape, row_panel=j.row_panel,
                                    col_window=j.col_window, device=CPU)


class TestProducts:
    @pytest.mark.parametrize("name", list(MATRICES))
    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_twins_equal_scipy(self, mats, name, dtype):
        s = mats[name].astype(dtype)
        p = poh_plan(tconv.from_scipy(s), device=CPU)
        s64 = s.astype(np.float64)
        rng = np.random.default_rng(3)
        x = rng.standard_normal(s.shape[1]).astype(dtype)
        assert _relerr(poh_spmv(p, torch.from_numpy(x)), s64 @ x) <= TOL[dtype]
        xt = rng.standard_normal(s.shape[0]).astype(dtype)
        assert _relerr(ct.spmv(p, torch.from_numpy(xt), transpose=True), s64.T @ xt) \
            <= TOL[dtype]
        for k in (8, 64, 150):
            X = rng.standard_normal((s.shape[1], k)).astype(dtype)
            assert _relerr(poh_spmm(p, torch.from_numpy(X)), s64 @ X) <= TOL[dtype]

    @pytest.fixture(scope="class")
    def ref(self):
        """One f64 power law through both packages' entry points; the
        reference's products are computed once (interpret mode)."""
        s = jconv.to_scipy(jgen.power_law(2000, avg_degree=8, seed=10))
        j = jpoh.poh_plan(jconv.from_scipy(s))
        t = poh_plan(tconv.from_scipy(s), device=CPU)
        rng = np.random.default_rng(11)
        x = rng.standard_normal(s.shape[1])
        xt = rng.standard_normal(s.shape[0])
        Xs = {k: rng.standard_normal((s.shape[1], k)) for k in (8, 64, 150)}
        return {
            "s": s, "j": j, "t": t, "x": x, "xt": xt, "X": Xs,
            "spmv": np.asarray(jspmv(j, jnp.asarray(x))),
            "spmv_t": np.asarray(jspmv(j, jnp.asarray(xt), transpose=True)),
            "transposed": np.asarray(jspmv(jpoh.poh_transpose_plan(j), jnp.asarray(xt))),
            "spmm": {k: np.asarray(jspmm(j, jnp.asarray(X))) for k, X in Xs.items()},
        }

    def test_spmv_matches_the_reference(self, ref):
        y = ct.spmv(ref["t"], torch.from_numpy(ref["x"])).numpy()
        assert _relerr(y, ref["spmv"]) <= 1e-12
        assert _relerr(y, ref["s"] @ ref["x"]) <= 1e-12

    def test_transposed_matches_the_reference(self, ref):
        y = ct.spmv(ct.transposed(ref["t"]), torch.from_numpy(ref["xt"])).numpy()
        assert _relerr(y, ref["transposed"]) <= 1e-12
        yt = ct.spmv(ref["t"], torch.from_numpy(ref["xt"]), transpose=True).numpy()
        assert _relerr(yt, ref["spmv_t"]) <= 1e-12
        assert _relerr(yt, ref["s"].T @ ref["xt"]) <= 1e-12

    @pytest.mark.parametrize("k", [8, 64, 150])
    def test_spmm_matches_the_reference(self, ref, k):
        X = ref["X"][k]
        Y = ct.spmm(ref["t"], torch.from_numpy(X)).numpy()
        assert Y.shape == (ref["s"].shape[0], k)
        assert _relerr(Y, ref["spmm"][k]) <= 1e-12
        assert _relerr(Y, ref["s"] @ X) <= 1e-12
        Yt = ct.spmm(ref["t"], torch.from_numpy(ref["xt"][:, None]), transpose=True).numpy()
        assert _relerr(Yt[:, 0], ref["spmv_t"]) <= 1e-12

    def test_precision_is_checked_and_changes_nothing(self, ref):
        x = torch.from_numpy(ref["x"])
        y = ref["t"].spmv(x)
        for mode in ("split", "fast", "highest"):
            torch.testing.assert_close(ref["t"].spmv(x, precision=mode), y, rtol=0, atol=0)
        with pytest.raises(ValueError):
            ref["t"].spmv(x, precision="bf16")
        with pytest.raises(ValueError):
            ref["t"].spmm(x[:, None], precision="exact")
        with pytest.raises(ValueError):
            jpoh.poh_spmv_pallas(ref["j"], jnp.asarray(ref["x"]), precision="bf16")

    def test_entry_points_check_dimensions(self, ref):
        n = ref["s"].shape[1]
        with pytest.raises(ValueError):
            ct.spmv(ref["t"], torch.ones(n + 1, dtype=torch.float64))
        with pytest.raises(ValueError):
            ct.spmm(ref["t"], torch.ones((n + 1, 2), dtype=torch.float64))


def test_cg_over_a_poh_plan_matches_the_reference():
    s = jconv.to_scipy(jgen.power_law(1500, avg_degree=8, seed=41))
    spd_j = jgen._diag_shift(jconv.from_scipy((s + s.T).tocsr()), 1.1)
    spd_t = _diag_shift(tconv.from_scipy((s + s.T).tocsr()), 1.1)
    b = np.random.default_rng(42).standard_normal(s.shape[0])
    ref = jsolvers.cg(jpoh.poh_plan(spd_j), jnp.asarray(b), tol=1e-10,
                      M=jsolvers.jacobi(spd_j))
    res = ct.solvers.cg(poh_plan(spd_t, device=CPU), torch.from_numpy(b), tol=1e-10,
                        M=ct.solvers.jacobi(spd_t, device=CPU))
    assert res.converged and bool(ref.converged)
    assert abs(res.iterations - int(ref.iterations)) <= 1
    assert np.max(np.abs(res.x.numpy() - np.asarray(ref.x))) <= 1e-9


def test_spmv_does_not_route_a_csr_to_poh(monkeypatch):
    # as in the reference, an unstructured CSR takes the gather formulation:
    # no POH pack is built, by whatever route, and no POH product runs
    def boom(*a, **k):
        raise AssertionError("spmv(csr, x) went through POH")

    monkeypatch.setattr(ct.PohMatrix, "__post_init__", boom)
    monkeypatch.setattr(ct.PohMatrix, "spmv", boom)
    a = tconv.from_scipy(jconv.to_scipy(jgen.power_law(500, avg_degree=6, seed=12)))
    x = torch.ones(500, dtype=torch.float64)
    assert _relerr(ct.spmv(a, x), tconv.to_scipy(a) @ np.ones(500)) <= 1e-12
