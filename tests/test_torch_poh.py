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
from cask_tpu_torch.ops.kernels.poh_kernels import (heavy_rows, poh_spmm, poh_spmm_reference,
                                                    poh_spmv, poh_spmv_reference, spmm_pieces,
                                                    spmv_pieces)
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


PIECE_PTRS = {  # name -> panel_ptr
    "even": [0, 4, 8, 12],
    "one_heavy": [0, 3, 3 + 17, 24, 27],
    "empty_panels": [0, 0, 5, 5, 9, 9],
    "all_empty": [0, 0, 0],
    "one_panel": [0, 7],
    "power_law_like": [0, 62, 321, 390, 455, 700],
}


def _check_pieces(ptr, pieces, cap):
    ptr = np.asarray(ptr)
    pc = pieces.numpy()
    assert pieces.dtype == torch.int32 and pc.shape[1] == 4
    covered = np.zeros(int(ptr[-1]), int)
    for panel, lo, hi, cut in pc:
        assert ptr[panel] <= lo <= hi <= ptr[panel + 1]  # within one panel
        assert hi - lo <= cap
        covered[lo:hi] += 1
    assert (covered == 1).all()  # every tile exactly once
    per_panel = np.bincount(pc[:, 0], minlength=len(ptr) - 1)
    assert (per_panel >= 1).all()  # every panel's rows get written
    assert (pc[:, 3] == (per_panel[pc[:, 0]] > 1)).all()  # cut = the panel has pieces
    sizes = pc[:, 2] - pc[:, 1]
    assert (np.diff(sizes) <= 0).all()  # largest first


class TestSpmmPieces:
    @pytest.mark.parametrize("name", list(PIECE_PTRS))
    @pytest.mark.parametrize("cap", [None, 1, 3, 100])
    def test_pieces_cover_every_tile_once_within_one_panel(self, name, cap):
        ptr = PIECE_PTRS[name]
        pieces = spmm_pieces(torch.tensor(ptr, dtype=torch.int32), cap)
        want = cap or max(-(-ptr[-1] // (len(ptr) - 1)), 1)  # the mean, rounded up
        _check_pieces(ptr, pieces, want)

    def test_only_panels_above_the_mean_are_cut(self):
        pieces = spmm_pieces(torch.tensor(PIECE_PTRS["power_law_like"], dtype=torch.int32))
        cap = -(-700 // 5)  # 140
        pc = pieces.numpy()
        assert sorted(set(pc[pc[:, 3] == 1, 0])) == [1, 4]  # 259 and 245 tiles
        assert (np.bincount(pc[:, 0]) == [1, 2, 1, 1, 2]).all()
        _check_pieces(PIECE_PTRS["power_law_like"], pieces, cap)

    @pytest.mark.parametrize("name", ["power_law", "banded", "empty_rows_cols", "all_zero"])
    def test_plan_carries_its_pieces(self, mats, name):
        p = poh_plan(tconv.from_scipy(mats[name]), device=CPU, row_panel=1024)
        torch.testing.assert_close(p.spmm_pieces, spmm_pieces(p.panel_ptr), rtol=0, atol=0)
        _check_pieces(p.panel_ptr.numpy(), p.spmm_pieces,
                      max(-(-p.ntiles // p.n_panels), 1))
        assert p.to(CPU).spmm_pieces.shape == p.spmm_pieces.shape

    @pytest.mark.parametrize("cap", [1, 2, 5])
    def test_pieces_reassemble_the_product(self, mats, cap):
        # the kernel's schedule in plain PyTorch: each piece's tiles summed on
        # their own, stored for an uncut panel, added for a cut one
        s = mats["power_law"]
        p = poh_plan(tconv.from_scipy(s), device=CPU, row_panel=1024)
        X = torch.from_numpy(np.random.default_rng(12).standard_normal((s.shape[1], 5)))
        R = p.row_panel
        Y = torch.zeros((p.n_panels * R, 5), dtype=X.dtype)
        for panel, lo, hi, cut in spmm_pieces(p.panel_ptr, cap).tolist():
            part = dataclasses.replace(p, vals=p.vals[lo:hi], cloc=p.cloc[lo:hi],
                                       rloc=p.rloc[lo:hi], wlo=p.wlo[lo:hi], whi=p.whi[lo:hi],
                                       panel=p.panel[lo:hi] * 0, first=p.first[lo:hi],
                                       last=p.last[lo:hi], shape=(R, s.shape[1]))
            block = poh_spmm_reference(part, X)
            rows = slice(panel * R, (panel + 1) * R)
            Y[rows] = Y[rows] + block if cut else block
        assert _relerr(Y[: s.shape[0]].numpy(), s @ X.numpy()) <= 1e-12


def _one_row_per_panel():
    # every live slot of a panel holds one row: rows 7 and 5000 of two panels
    rng = np.random.default_rng(80)
    rows = np.repeat([7, 5000], [3000, 2500])
    cols = np.concatenate([rng.choice(9000, 3000, replace=False),
                           rng.choice(9000, 2500, replace=False)])
    return sp.csr_matrix((rng.standard_normal(5500), (rows, cols)), shape=(8192, 9000))


def _hub_row():
    # 4 entries a row and row 5 with 15,000: its panel holds most of the tiles
    s = jconv.to_scipy(jgen.random_uniform(20000, 20000, density=2e-4, seed=47))
    rng = np.random.default_rng(48)
    return (s + sp.csr_matrix((rng.standard_normal(15000), (np.full(15000, 5),
                                                            rng.choice(20000, 15000,
                                                                       replace=False))),
                              shape=s.shape)).tocsr()


SPMV_EDGES = {  # name -> scipy f64 CSR: the SpMV kernel's edge plans
    "one_row_per_panel": _one_row_per_panel,
    "cut_panels": _hub_row,
    "one_tile_per_panel": lambda: jconv.to_scipy(jgen.random_uniform(12000, 6000, density=5e-5,
                                                                     seed=81)),
}


def _heavy_numpy(p):
    """Per panel: (the live-slot count of each panel-local row, numpy)."""
    v = p.vals.float().numpy().reshape(p.ntiles, -1)
    r = p.rloc.numpy().reshape(p.ntiles, -1)
    counts = np.zeros((p.n_panels, p.row_panel), np.int64)
    t, j = np.nonzero(v)
    np.add.at(counts, (p.panel.numpy()[t], r[t, j]), 1)
    return counts


def _check_heavy(p):
    counts = _heavy_numpy(p)
    h = p.heavy_row.numpy()
    assert p.heavy_row.dtype == torch.int32 and h.shape == (p.n_panels, 2)
    for i in range(p.n_panels):
        top = np.sort(counts[i])[::-1][:2]  # the two largest counts (ties: any rows)
        for k in range(2):
            if top[k] == 0:
                assert h[i, k] == -1
            else:
                assert counts[i, h[i, k]] == top[k]
        if (h[i] >= 0).all():
            assert h[i, 0] != h[i, 1]


class TestSpmvTables:
    """The SpMV kernel's tables, built with the plan: its work pieces and
    each panel's heaviest row."""

    @pytest.mark.parametrize("name", list(SPMV_EDGES) + list(MATRICES))
    def test_tables_equal_a_numpy_count(self, mats, name):
        s = SPMV_EDGES[name]() if name in SPMV_EDGES else mats[name]
        p = poh_plan(tconv.from_scipy(s), device=CPU)
        _check_heavy(p)
        cap = max(-(-p.ntiles // (16 * 132)), 1)
        _check_pieces(p.panel_ptr.numpy(), p.spmv_pieces, cap)
        torch.testing.assert_close(p.spmv_pieces, spmm_pieces(p.panel_ptr, cap), rtol=0,
                                   atol=0)
        if name == "one_row_per_panel":
            assert p.heavy_row.tolist() == [[7, -1], [5000 - p.row_panel, -1]]
        elif name == "one_tile_per_panel":
            assert p.ntiles == p.n_panels and p.spmv_pieces.shape[0] == p.n_panels
        elif name == "all_zero":
            assert (p.heavy_row == -1).all()

    def test_a_big_panel_is_cut_for_spmv(self):
        # 3000 tiles: a cap of ceil(3000 / (16 · 132)) = 2 tiles cuts both big panels
        ptr = torch.tensor([0, 1000, 1001, 3000], dtype=torch.int32)
        pieces = spmv_pieces(ptr)
        _check_pieces(ptr.numpy(), pieces, 2)
        assert np.bincount(pieces.numpy()[:, 0]).tolist() == [500, 1, 1000]

    def test_heavy_rows_ignore_padding_and_indices_out_of_range(self):
        vals = torch.zeros((2, 1, 128))
        rloc = torch.zeros((2, 1, 128), dtype=torch.int32)
        vals[0, 0, :6] = 1.0
        rloc[0, 0, :6] = torch.tensor([3, 3, 9, 4096, -1, 3], dtype=torch.int32)
        rloc[1, 0, :] = 7  # padding (value 0): does not count
        out = heavy_rows(vals, rloc, torch.tensor([0, 1], dtype=torch.int32), 2, 4096)
        assert out.tolist() == [[3, 9], [-1, -1]]

    @pytest.mark.parametrize("name", list(SPMV_EDGES))
    def test_tables_survive_to_astype_replace_and_transpose(self, name):
        s = SPMV_EDGES[name]()
        p = poh_plan(tconv.from_scipy(s), device=CPU)
        for q in (p.to(CPU), p.astype(torch.bfloat16), p.astype(np.float64),
                  dataclasses.replace(p, vals=2 * p.vals)):
            torch.testing.assert_close(q.spmv_pieces, p.spmv_pieces, rtol=0, atol=0)
            torch.testing.assert_close(q.heavy_row, p.heavy_row, rtol=0, atol=0)
        t = poh_transpose_plan(p)
        fresh = poh_plan(tconv.from_scipy(s.T.tocsr()), device=CPU)
        torch.testing.assert_close(t.spmv_pieces, fresh.spmv_pieces, rtol=0, atol=0)
        _check_heavy(t)
        assert (t.heavy_row >= 0).sum() == (fresh.heavy_row >= 0).sum()

    @pytest.mark.parametrize("name", list(SPMV_EDGES))
    def test_the_kernels_schedule_reassembles_the_product(self, name):
        # the SpMV kernel's schedule in plain PyTorch: each piece's tiles, the
        # heavy rows' slots summed apart from the rest, added into a zeroed y
        s = SPMV_EDGES[name]()
        p = poh_plan(tconv.from_scipy(s), device=CPU)
        x = torch.from_numpy(np.random.default_rng(13).standard_normal(s.shape[1]))
        R = p.row_panel
        y = torch.zeros(p.n_panels * R, dtype=x.dtype)
        heavy = p.heavy_row.tolist()
        for panel, lo, hi, _ in p.spmv_pieces.tolist():
            part = dataclasses.replace(p, vals=p.vals[lo:hi], cloc=p.cloc[lo:hi],
                                       rloc=p.rloc[lo:hi], wlo=p.wlo[lo:hi], whi=p.whi[lo:hi],
                                       panel=p.panel[lo:hi] * 0, first=p.first[lo:hi],
                                       last=p.last[lo:hi], shape=(R, s.shape[1]))
            on_heavy = torch.zeros_like(part.vals, dtype=torch.bool)
            for hv in heavy[panel]:
                if hv >= 0:
                    on = (part.rloc == hv) & (part.vals != 0)
                    y[panel * R + hv] += poh_spmv_reference(
                        dataclasses.replace(part, vals=part.vals * on), x)[hv]
                    on_heavy |= on
            rest = poh_spmv_reference(dataclasses.replace(part, vals=part.vals * ~on_heavy), x)
            y[panel * R: (panel + 1) * R] += rest
        assert _relerr(y[: s.shape[0]].numpy(), s @ x.numpy()) <= 1e-12


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
