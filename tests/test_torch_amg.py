"""The port's smoothed-aggregation AMG against the JAX package's, on the CPU.

Host set-up: the strength graph and the aggregates (the port's native core
and its Python passes, both against the reference's Python passes) are
equal bit for bit; so are the level sizes, each level's route (DIA, POH,
dense), each DIA and POH pack's arrays, the inverse diagonals and the
coarse inverse.  A lowered ``dense_cutoff`` makes a small stencil route
through DIA and POH.  Apply: interpreting the reference's POH kernel takes
about 1 s a call, so the reference's V-cycle is its ``route="csr"`` one
(the same hierarchy through the gather product), and the port's routed
cycle (the kernels' plain twins on the CPU) is held to it.

Tolerances: a V-cycle within 1e-10 normwise (f64); AMG-preconditioned CG
within ±1 iteration and x within 1e-9 relative.
"""

import jax  # noqa: F401  (kept on the CPU with x64 by conftest)
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cask_tpu.formats.convert as jconv
import cask_tpu.formats.generate as jgen
import cask_tpu.native.binding as jnat
import cask_tpu.solvers.amg as jamg
import cask_tpu.solvers.krylov as jkrylov
import cask_tpu_torch as ct
import cask_tpu_torch.formats.convert as tconv
import cask_tpu_torch.formats.generate as tgen
import cask_tpu_torch.solvers.amg as tamg
from cask_tpu.ops.dia import DiaMatrix as JDia
from cask_tpu.ops.pallas.poh_kernels import PohMatrix as JPoh
from cask_tpu_torch.ops.dia import DiaMatrix
from cask_tpu_torch.ops.poh import PohMatrix
from cask_tpu_torch.solvers import AmgPrecond, smoothed_aggregation_amg

SMALL = dict(dense_cutoff=64, coarse_size=16)  # 1024 rows: DIA, then POH or DIA, then dense


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _route(op) -> str:
    if isinstance(op, (DiaMatrix, JDia)):
        return "dia"
    if isinstance(op, (PohMatrix, JPoh)):
        return "poh"
    if isinstance(op, (tamg._FactoredApply, jamg._FactoredApply)):
        return "factored " + _route(op.tent)
    if isinstance(op, torch.Tensor) or isinstance(op, jax.Array):
        return "dense"
    return type(op).__name__.lower()


def _python_passes_only(monkeypatch):
    """Make the reference take its Python aggregation passes."""
    def refuse(*_):
        raise RuntimeError("native core refused in this test")

    monkeypatch.setattr(jnat, "aggregate", refuse)


@pytest.mark.parametrize("name,mat", [
    ("stencil", lambda: tgen.stencil_2d(24)),
    ("stencil9", lambda: tgen.stencil_2d(15, points=9)),
    ("fem", lambda: tgen.fem_blocks(6, dof=3)),
    ("power_law", lambda: tgen.power_law(500, avg_degree=6, seed=2)),
])
@pytest.mark.parametrize("theta", [0.08, 0.25])
def test_aggregates_are_bit_equal(monkeypatch, name, mat, theta):
    s = tconv.to_scipy(mat()).tocsr().astype(np.float64)
    if name == "power_law":
        s = (s + s.T).tocsr()
    st = tamg._strength_graph(s, theta)
    sj = jamg._strength_graph(s, theta)
    assert (st != sj).nnz == 0 and np.array_equal(st.indptr, sj.indptr)
    _python_passes_only(monkeypatch)
    ref = jamg._aggregate(sj)
    native = tamg._aggregate(st, use_native=True)
    python = tamg._aggregate(st, use_native=False)
    assert native.dtype == python.dtype == np.int64
    assert np.array_equal(native, ref) and np.array_equal(python, ref)


def test_aggregate_falls_back_only_when_the_core_is_unavailable(monkeypatch):
    s = tconv.to_scipy(tgen.stencil_2d(10)).tocsr()
    st = tamg._strength_graph(s, 0.08)

    def unavailable(*_):
        raise tamg.nat.NativeUnavailable("no core")

    monkeypatch.setattr(tamg.nat, "aggregate", unavailable)
    assert np.array_equal(tamg._aggregate(st), tamg._aggregate(st, use_native=False))
    with pytest.raises(tamg.nat.NativeUnavailable):
        tamg._aggregate(st, use_native=True)

    def broken(*_):
        raise ValueError("a fault, not an absence")

    monkeypatch.setattr(tamg.nat, "aggregate", broken)
    with pytest.raises(ValueError):  # no blanket except: a fault propagates
        tamg._aggregate(st)


def _same_pack(op, ref):
    if isinstance(op, DiaMatrix):
        assert op.offsets == ref.offsets and op.shape == ref.shape
        for f in ("vals", "rem_data", "rem_row", "rem_col"):
            assert np.array_equal(getattr(op, f).numpy(), np.asarray(getattr(ref, f))), f
    elif isinstance(op, PohMatrix):
        assert (op.shape, op.row_panel, op.col_window) == (ref.shape, ref.row_panel,
                                                           ref.col_window)
        for f in ("vals", "cloc", "rloc", "wlo", "whi", "panel", "first", "last"):
            assert np.array_equal(getattr(op, f).numpy(), np.asarray(getattr(ref, f))), f
    elif isinstance(op, tamg._FactoredApply):
        assert op.kind == ref.kind and op.omega_s == ref.omega_s
        _same_pack(op.tent, ref.tent)
        _same_pack(op.tent_t, ref.tent_t)
        assert np.array_equal(op.dinv.numpy(), np.asarray(ref.dinv))
    else:
        assert np.array_equal(op.numpy(), np.asarray(ref))


@pytest.mark.parametrize("nx,kw", [(32, SMALL), (32, dict(dense_cutoff=200, coarse_size=16)),
                                   (20, dict(dense_cutoff=64, coarse_size=30, smooth=False))])
def test_hierarchy_equals_the_reference(nx, kw):
    a_t, a_j = tgen.stencil_2d(nx), jgen.stencil_2d(nx)
    ref = jamg.smoothed_aggregation_amg(a_j, **kw)
    amg = smoothed_aggregation_amg(a_t, device="cpu", **kw)
    assert amg.level_sizes == ref.level_sizes
    routes = [(_route(lv.a), _route(lv.p), _route(lv.r)) for lv in amg.levels]
    assert routes == [(_route(lv.a), _route(lv.p), _route(lv.r)) for lv in ref.levels]
    for lv, rl in zip(amg.levels, ref.levels):
        for f in ("a", "p", "r"):
            _same_pack(getattr(lv, f), getattr(rl, f))
        assert np.array_equal(lv.dinv.numpy(), np.asarray(rl.dinv))
    assert np.array_equal(amg.coarse_inv.numpy(), np.asarray(ref.coarse_inv))
    if kw is SMALL:  # the small configuration reaches every route
        flat = {r for t in routes for r in t}
        assert {"dia", "factored poh", "dense"} <= flat | {_route(amg.coarse_inv)}


def _systems():
    """(port, reference) pairs of SPD systems: the factored R = Tᵀ(I − ω_s A D⁻¹)
    is Pᵀ only for a symmetric A."""
    a = tconv.to_scipy(tgen.fem_blocks(8, dof=2))
    fem = (a + a.T).tocsr()
    fem.sort_indices()
    return [(tgen.stencil_2d(32), jgen.stencil_2d(32)),
            (tgen._diag_shift(tconv.from_scipy(fem), 1.1),
             jgen._diag_shift(jconv.from_scipy(fem), 1.1))]


@pytest.mark.parametrize("route", ["auto", "csr"])
@pytest.mark.parametrize("which", [0, 1])
def test_v_cycle_matches_the_reference_csr_cycle(route, which):
    a_t, a_j = _systems()[which]
    ref = jamg.smoothed_aggregation_amg(a_j, route="csr", **SMALL)
    amg = smoothed_aggregation_amg(a_t, route=route, device="cpu", **SMALL)
    r = np.random.default_rng(which).standard_normal(a_t.shape[0])
    want = np.asarray(ref(jnp.asarray(r)))
    got = amg(torch.from_numpy(r))
    assert got.dtype == torch.float64
    assert _rel(got.numpy(), want) <= 1e-10


@pytest.mark.parametrize("which", [0, 1])
def test_amg_pcg_matches_the_reference(which):
    a_t, a_j = _systems()[which]
    b = np.random.default_rng(10 + which).standard_normal(a_t.shape[0])
    ref = jkrylov.cg(a_j, b, tol=1e-10, maxiter=500,
                     M=jamg.smoothed_aggregation_amg(a_j, route="csr", **SMALL))
    res = ct.solvers.cg(a_t, torch.from_numpy(b), tol=1e-10, maxiter=500,
                        M=smoothed_aggregation_amg(a_t, device="cpu", **SMALL))
    assert res.converged and abs(res.iterations - int(ref.iterations)) <= 1
    assert _rel(res.x.numpy(), ref.x) <= 1e-9
    if which == 0:  # on the Poisson system the V-cycle cuts the iterations
        plain = ct.solvers.cg(a_t, torch.from_numpy(b), tol=1e-10, maxiter=2000)
        assert res.iterations < plain.iterations / 3


def test_f32_cycle_inside_f64_refinement():
    a_t, a_j = tgen.stencil_2d(24), jgen.stencil_2d(24)
    amg = smoothed_aggregation_amg(a_t, dtype=torch.float32, device="cpu", **SMALL)
    assert amg.coarse_inv.dtype == torch.float32
    assert all(lv.dinv.dtype == torch.float32 for lv in amg.levels)
    ref = jamg.smoothed_aggregation_amg(a_j, dtype=np.float32, route="csr", **SMALL)
    r = np.random.default_rng(3).standard_normal(a_t.shape[0]).astype(np.float32)
    assert _rel(amg(torch.from_numpy(r)).numpy(), np.asarray(ref(jnp.asarray(r)))) <= 1e-5
    b = torch.from_numpy(np.random.default_rng(4).standard_normal(a_t.shape[0]))
    res = ct.solvers.ir_solve(a_t, b, tol=1e-12, M=amg, inner_maxiter=50)
    s = tconv.to_scipy(a_t)
    assert res.converged
    assert np.linalg.norm(b.numpy() - s @ res.x.numpy()) / np.linalg.norm(b.numpy()) <= 1e-12


def test_amg_precond_is_a_plain_frozen_dataclass():
    amg = smoothed_aggregation_amg(tgen.stencil_2d(12), device="cpu", coarse_size=20)
    assert isinstance(amg, AmgPrecond) and amg.poh_precision == "split"
    with pytest.raises(Exception):
        amg.omega = 1.0
    # a diagonal matrix cannot coarsen: no level, the coarse inverse is all
    d = tconv.from_scipy(sp.diags(np.arange(1.0, 301.0)).tocsr())
    flat = smoothed_aggregation_amg(d, device="cpu")
    assert flat.levels == [] and flat.level_sizes == [300]
    r = torch.ones(300, dtype=torch.float64)
    assert torch.allclose(flat(r), 1.0 / torch.arange(1.0, 301.0, dtype=torch.float64))
