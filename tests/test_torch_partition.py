"""The port's partitions (``cask_tpu_torch.parallel.partition``) against the
JAX package's, in process: every array of every partition class equal (the
same dtype, shape and values) for P ∈ {1, 2, 3, 8}, and the same static
metadata.  Both packages get the same matrix through scipy.

One difference, on purpose: ``partition_dia(align > 1)`` splits its
remainder like its band (the reference splits it by ceil(m / P) rows, and
its executor then fails to add the two).

Each reference partition also crosses to the port through ``interop``
(``*_partition_from_arrays``) equal to the port's own.

Covered: an uneven last shard, remainder spills (sparse diagonals, a band
wider than a shard, sparse block diagonals, far blocks), ``align=8192``,
``align_b``, the formulaic stencil and FEM builders (each against the
reference's and against the port's generic builder of the same matrix),
POH packs (the reference's ``rloc_t`` is the port's ``rloc`` transposed per
tile, a layout the port leaves out), the 2-D grid, the builders' refusals,
and :func:`check_partition`.
"""

import dataclasses

import jax  # noqa: F401  (kept on the CPU with x64 by conftest)
import numpy as np
import pytest
import scipy.sparse as sp

import cask_tpu.formats.convert as jconv
import cask_tpu.formats.generate as jgen
import cask_tpu.parallel as jpar
import cask_tpu_torch.formats.convert as tconv
import cask_tpu_torch.parallel as tpar
from cask_tpu_torch import interop
from cask_tpu_torch.utils.debug import check_partition

PS = (1, 2, 3, 8)
# the reference's POH tile and window (the port defaults to poh_plan's)
REF_POH = dict(col_window=1024, tile_slots=4096)


def _pair(s):
    """(reference CSR, port CSR) of a scipy matrix."""
    s = sp.csr_matrix(s)
    s.sort_indices()
    return jconv.from_scipy(s), tconv.from_scipy(s)


def _bsr_pair(s, b):
    j, t = _pair(s)
    return jconv.csr_to_bsr(j, (b, b)), tconv.csr_to_bsr(t, (b, b))


def _same(ref, got, where=""):
    """Every field of the port's partition equals the reference's."""
    assert type(got).__name__ == type(ref).__name__
    for f in dataclasses.fields(got):
        want, have = getattr(ref, f.name), getattr(got, f.name)
        name = f"{where}{f.name}"
        if f.name == "remainder":
            assert (want is None) == (have is None), name
            if have is not None:
                _same(want, have, name + ".")
        elif isinstance(have, np.ndarray):
            want = np.asarray(want)
            assert have.dtype == want.dtype, (name, have.dtype, want.dtype)
            assert have.shape == want.shape, (name, have.shape, want.shape)
            np.testing.assert_array_equal(have, want, err_msg=name)
        else:
            assert have == want, (name, have, want)


def cross_partition(ref):
    """A reference partition crossed to the port through ``interop``: its
    arrays as numpy plus its static fields."""
    a = lambda f: np.asarray(getattr(ref, f))  # noqa: E731
    rem = None if getattr(ref, "remainder", None) is None else cross_partition(ref.remainder)
    kind = type(ref).__name__
    if kind == "CooPartition":
        return interop.coo_partition_from_arrays(
            *(a(f) for f in ("int_data", "int_row", "int_col", "ext_data", "ext_row",
                             "ext_col")), shape=ref.shape, nshards=ref.nshards, mloc=ref.mloc)
    if kind == "DiaPartition":
        return interop.dia_partition_from_arrays(a("vals"), rem, offsets=ref.offsets,
                                                 shape=ref.shape, nshards=ref.nshards,
                                                 mloc=ref.mloc)
    if kind == "BdiaPartition":
        return interop.bdia_partition_from_arrays(
            a("vals"), a("head_vals"), a("tail_vals"), rem, block_offsets=ref.block_offsets,
            shape=ref.shape, blocksize=ref.blocksize, ts=ref.ts, nshards=ref.nshards,
            mloc=ref.mloc, nbloc=ref.nbloc)
    if kind == "PohPartition":
        return interop.poh_partition_from_arrays(
            {f.name: a(f.name) for f in dataclasses.fields(ref) if f.name[:4] in ("int_", "ext_")},
            shape=ref.shape, nshards=ref.nshards, mloc=ref.mloc, row_panel=ref.row_panel,
            col_window=ref.col_window)
    return interop.coo2d_partition_from_arrays(a("data"), a("row"), a("col"), shape=ref.shape,
                                               pr=ref.pr, pc=ref.pc, mr=ref.mr, mc=ref.mc)


def _same_crossed(ref, got):
    """The port's partition equals the reference's, and so does the
    reference's crossed through ``interop``."""
    _same(ref, got)
    _same(ref, cross_partition(ref))


def _with_far(s, seed):
    """``s`` plus a few scattered entries on sparse far diagonals."""
    rng = np.random.default_rng(seed)
    n = s.shape[0]
    extra = sp.coo_matrix((rng.standard_normal(9), (rng.integers(0, n, 9),
                                                    rng.integers(0, n, 9))), shape=s.shape)
    return (s + extra).tocsr()


MATRICES = {
    "banded": lambda: jconv.to_scipy(jgen.banded(1000, 4, seed=1)),
    "stencil": lambda: jconv.to_scipy(jgen.stencil_2d(33)),
    "powerlaw": lambda: jconv.to_scipy(jgen.power_law(800, avg_degree=5, seed=2)),
    "uneven": lambda: jconv.to_scipy(jgen.random_uniform(301, 301, density=0.02, seed=4)),
    "stencil_far": lambda: _with_far(jconv.to_scipy(jgen.stencil_2d(20)), 5),
}


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("name", list(MATRICES))
def test_partition_coo(p, name):
    j, t = _pair(MATRICES[name]())
    _same_crossed(jpar.partition_coo(j, p), tpar.partition_coo(t, p))


@pytest.mark.parametrize("p", PS)
def test_partition_coo_mloc_override(p):
    j, t = _pair(MATRICES["uneven"]())
    mloc = -(-301 // p) + 5
    _same(jpar.partition_coo(j, p, mloc=mloc), tpar.partition_coo(t, p, mloc=mloc))


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("name,kw", [
    ("banded", {}),
    ("stencil", {}),
    ("stencil", {"align": 8192}),
    ("powerlaw", {"min_density": 0.4}),  # sparse diagonals spill to the remainder
    ("stencil_far", {}),
    ("uneven", {"min_density": 0.01, "max_diags": 8}),
])
def test_partition_dia(p, name, kw):
    j, t = _pair(MATRICES[name]())
    ref, got = jpar.partition_dia(j, p, **kw), tpar.partition_dia(t, p, **kw)
    _same_crossed(ref, got)
    check_partition(got)


@pytest.mark.parametrize("p", PS)
def test_partition_dia_aligned_remainder_splits_like_the_band(p):
    """With ``align`` and a remainder the reference splits the remainder by
    ceil(m / P) rows, not by the band's aligned ``mloc`` (its executor cannot
    add the two); the port splits it like the band.  Everything else equal."""
    j, t = _pair(MATRICES["stencil_far"]())
    ref, got = jpar.partition_dia(j, p, align=64), tpar.partition_dia(t, p, align=64)
    assert got.remainder is not None and got.remainder.mloc == got.mloc
    assert ref.remainder.mloc == -(-400 // p) != got.mloc
    _same(dataclasses.replace(ref, remainder=None), dataclasses.replace(got, remainder=None))
    rem = jconv.to_scipy(j) - jconv.to_scipy(jconv.from_scipy(sp.csr_matrix(
        _band_of(got, j.shape))))
    _same(jpar.partition_coo(jconv.from_scipy(rem.tocsr()), p, mloc=got.mloc), got.remainder)
    check_partition(got)


def _band_of(plan, shape):
    """The band a DiaPartition packs, as scipy."""
    rows, cols, vals = [], [], []
    r = np.arange(plan.nshards * plan.mloc)
    for d, off in enumerate(plan.offsets):
        v = plan.vals[:, d, :].reshape(-1)
        ok = (v != 0) & (r < shape[0]) & (r + off >= 0) & (r + off < shape[1])
        rows.append(r[ok]), cols.append(r[ok] + off), vals.append(v[ok])
    return sp.coo_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
                         shape=shape)


@pytest.mark.parametrize("p", PS)
def test_partition_dia_wide_halo_spills_to_the_remainder(p):
    s = jconv.to_scipy(jgen.banded(256, 2, seed=5)) + sp.diags(np.ones(56), -200,
                                                               shape=(256, 256))
    j, t = _pair(s)
    got = tpar.partition_dia(t, p)
    _same(jpar.partition_dia(j, p), got)
    assert all(abs(o) <= got.mloc for o in got.offsets)
    assert (got.remainder is not None) == (got.mloc < 200)


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("nx,ny,align", [(33, None, 64), (20, 13, 8192), (7, 1, 1)])
def test_stencil_dia_partition(p, nx, ny, align):
    got = tpar.stencil_dia_partition(nx, ny, nshards=p, align=align)
    _same(jpar.stencil_dia_partition(nx, ny, nshards=p, align=align), got)
    # the formula is the generic builder's partition of the same stencil,
    # except on a grid one point wide, where both packages' formula drops the
    # ±1 couplings (its column test reads every row as a row start)
    if ny != 1:
        t = tconv.from_scipy(jconv.to_scipy(jgen.stencil_2d(nx, ny, dtype=np.float32)))
        _same(tpar.partition_dia(t, p, align=align), got)


def _fem_bsr(nx, seed, far=0):
    s = jconv.to_scipy(jgen.fem_blocks(nx, dof=4, seed=seed))
    if far:
        s = s.tolil()
        rng = np.random.default_rng(seed)
        nb = s.shape[0] // 4
        for _ in range(far):
            bi, bj = (int(v) for v in rng.integers(0, nb, 2))
            s[bi * 4: bi * 4 + 4, bj * 4: bj * 4 + 4] = rng.standard_normal((4, 4))
    return _bsr_pair(s.tocsr(), 4)


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("far", [0, 12])
def test_partition_bdia(p, far):
    j, t = _fem_bsr(12, seed=far, far=far)
    ref, got = jpar.partition_bdia(j, p), tpar.partition_bdia(t, p)
    _same_crossed(ref, got)
    assert (got.remainder is not None) == bool(far)


@pytest.mark.parametrize("p", (1, 2, 3))
def test_partition_bdia_align_b_and_csr_input(p):
    s = jconv.to_scipy(jgen.fem_blocks(20, dof=2, seed=3))
    j, t = _pair(s)
    _same(jpar.partition_bdia(j, p, (2, 2), align_b=64),
          tpar.partition_bdia(t, p, (2, 2), align_b=64))


def test_partition_bdia_refusals():
    j, t = _fem_bsr(8, seed=0)
    for part, a in ((jpar, j), (tpar, t)):
        with pytest.raises(ValueError, match="no real rows"):
            part.partition_bdia(a, 4, align_b=64)
    with pytest.raises(ValueError, match="explicit blocksize"):
        tpar.partition_bdia(tconv.from_scipy(jconv.to_scipy(j)), 2)


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fem_bdia_partition(p, dtype):
    got = tpar.fem_bdia_partition(9, dof=4, nshards=p, dtype=dtype)
    _same_crossed(jpar.fem_bdia_partition(9, dof=4, nshards=p, dtype=dtype), got)
    # the formula is partition_bdia of the matrix fem_formula_bsr builds
    tb = tpar.fem_formula_bsr(9, dof=4, dtype=np.float64)
    np.testing.assert_array_equal(tb.data, np.asarray(jpar.fem_formula_bsr(9, dof=4).data))
    if dtype == np.float64:
        _same(tpar.partition_bdia(tb, p), got)


@pytest.mark.parametrize("p", (2, 3))
def test_fem_bdia_partition_align_b(p):
    _same(jpar.fem_bdia_partition(10, 7, dof=2, nshards=p, align_b=32),
          tpar.fem_bdia_partition(10, 7, dof=2, nshards=p, align_b=32))


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("name", ["powerlaw", "uneven"])
def test_partition_poh(p, name):
    j, t = _pair(MATRICES[name]())
    ref, got = jpar.partition_poh(j, p), tpar.partition_poh(t, p, **REF_POH)
    _same_crossed(ref, got)
    for pfx in ("int", "ext"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, f"{pfx}_rloc_t")),
                                      getattr(got, f"{pfx}_rloc").swapaxes(-1, -2))


@pytest.mark.parametrize("p", PS)
@pytest.mark.parametrize("name", ["powerlaw", "uneven"])
def test_partition_poh_defaults_are_poh_plans(p, name):
    """The port's defaults: ``poh_plan``'s tile and one window for every
    shard, sized from the whole matrix; one shard's pack is ``poh_plan(a)``."""
    from cask_tpu_torch.formats.matrix import host
    from cask_tpu_torch.ops.poh import poh_plan

    t = _pair(MATRICES[name]())[1]
    got = tpar.partition_poh(t, p)
    whole = poh_plan(t, device="cpu")
    assert got.col_window == whole.col_window
    assert got.int_vals.shape[-2:] == (whole.slot_rows, 128)
    if p == 1:
        for f in ("vals", "cloc", "rloc", "wlo", "panel"):
            np.testing.assert_array_equal(getattr(got, f"int_{f}")[0],
                                          host(getattr(whole, f)), err_msg=f)
    _same(tpar.partition_poh(t, p, col_window=whole.col_window), got)


@pytest.mark.parametrize("grid", [(2, 2), (1, 3), (3, 1), (2, 4)])
@pytest.mark.parametrize("name", ["powerlaw", "uneven"])
def test_partition_2d(grid, name):
    j, t = _pair(MATRICES[name]())
    _same_crossed(jpar.partition_2d(j, *grid), tpar.partition_2d(t, *grid))


def test_partition_2d_rectangular():
    j, t = _pair(jconv.to_scipy(jgen.random_uniform(200, 310, density=0.02, seed=2)))
    _same(jpar.partition_2d(j, 2, 2), tpar.partition_2d(t, 2, 2))


def test_builders_refuse_what_the_reference_refuses():
    wide = sp.random(40, 64, density=0.2, random_state=0, format="csr")
    for part in (jpar, tpar):
        a = (jconv if part is jpar else tconv).from_scipy(wide)
        with pytest.raises(ValueError, match="n \\(64\\)"):
            part.partition_coo(a, 2, mloc=20)
        with pytest.raises(ValueError, match="square"):
            part.partition_dia(a, 2)


def test_check_partition():
    _, t = _pair(MATRICES["powerlaw"]())
    plan = tpar.partition_dia(t, 3, min_density=0.4)  # 3·267 rows: one padding row
    check_partition(plan)
    check_partition(tpar.partition_coo(t, 3))
    bad = dataclasses.replace(plan.remainder,
                              int_col=plan.remainder.int_col + plan.mloc)
    with pytest.raises(AssertionError, match="interior column"):
        check_partition(bad)
    vals = plan.vals.copy()
    vals[-1, 0, -1] = 1.0  # on the padding row
    with pytest.raises(AssertionError, match="out-of-range"):
        check_partition(dataclasses.replace(plan, vals=vals))
    with pytest.raises(TypeError):
        check_partition(object())


def test_interop_refuses_arrays_that_disagree():
    _, t = _pair(MATRICES["stencil"]())
    plan = tpar.partition_dia(t, 2)
    with pytest.raises(ValueError, match="offsets"):
        interop.dia_partition_from_arrays(plan.vals, None, offsets=plan.offsets[:-1],
                                          shape=plan.shape, nshards=2, mloc=plan.mloc)
    coo = tpar.partition_coo(t, 2)
    with pytest.raises(ValueError, match="integer"):
        interop.coo_partition_from_arrays(coo.int_data, coo.int_row.astype(float), coo.int_col,
                                          coo.ext_data, coo.ext_row, coo.ext_col,
                                          shape=coo.shape, nshards=2, mloc=coo.mloc)
    with pytest.raises(ValueError, match=r"\(3, \.\.\.\)"):
        interop.coo2d_partition_from_arrays(coo.int_data, coo.int_row, coo.int_col,
                                            shape=coo.shape, pr=3, pc=1, mr=1, mc=1)
