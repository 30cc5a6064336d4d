"""The port's copy of the native preprocessing core against the JAX package's.

The same C++ source (byte for byte) built into the port's own build
directory: every bound routine gives the reference's arrays on the same
input, ILU(0)'s values bit for bit.  Without the core, the callers that
have a numpy path take it with the same results, and those asked for the
core by name raise.
"""

import importlib
from pathlib import Path

import jax  # noqa: F401  (kept on the CPU with x64 by conftest)
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cask_tpu.formats.generate as jgen
import cask_tpu.native.binding as jnat
import cask_tpu_torch.formats.convert as tconv
import cask_tpu_torch.formats.generate as tgen
import cask_tpu_torch.native.binding as tnat
import cask_tpu_torch.native.build as tbuild
from cask_tpu_torch.formats.mtx import read_mtx

REPO = Path(__file__).resolve().parents[1]
DATA = REPO / "tests" / "data"
jtri = importlib.import_module("cask_tpu.ops.trisolve")
ttri = importlib.import_module("cask_tpu_torch.ops.trisolve")
tilu = importlib.import_module("cask_tpu_torch.ops.ilu")
tspgemm = importlib.import_module("cask_tpu_torch.ops.spgemm")


def _csr_arrays(a):
    return np.asarray(a.indptr), np.asarray(a.indices), np.asarray(a.data)


def _spd(s):
    """``s`` made strictly diagonally dominant (an explicit diagonal in every row)."""
    return (s + sp.diags(np.abs(s).sum(axis=1).A1 + 1.0)).tocsr()


MATRICES = {
    "stencil_2d(9)": lambda: tgen.stencil_2d(9),
    "banded(120, 3)": lambda: tgen.banded(120, 3, seed=1, spd=True),
    "power_law(200)": lambda: tconv.from_scipy(_spd(tconv.to_scipy(
        tgen.power_law(200, avg_degree=5, seed=4)))),
    "stiff2d_576.mtx": lambda: read_mtx(DATA / "stiff2d_576.mtx"),
}


def test_source_is_the_references_byte_for_byte():
    ref = REPO / "cask_tpu" / "native" / "src" / "preprocess.cpp"
    assert tbuild.SRC.read_bytes() == ref.read_bytes()


def test_library_builds_into_the_ports_own_directory():
    path = Path(tbuild.lib_path())
    assert tnat.available()
    assert path.parent == tbuild.BUILD_DIR
    assert path.name.startswith("libcasknative_") and path.suffix == ".so"
    assert path.parent != REPO / "cask_tpu" / "native"
    assert tbuild.lib_path() == str(path)  # keyed by content: the same name again


@pytest.mark.parametrize("name", sorted(MATRICES))
def test_ilu0_values_are_bit_equal_to_the_references(name):
    ip, ix, d = _csr_arrays(MATRICES[name]())
    got = tnat.ilu0(ip, ix, d)
    assert np.array_equal(got, jnat.ilu0(ip, ix, d))
    np.testing.assert_allclose(got, tilu._ilu0_numpy(ip.astype(np.int64), ix.astype(np.int64),
                                                     d), rtol=1e-13)


def test_ilu0_zero_pivot_raises_as_the_reference():
    s = sp.csr_matrix(np.array([[0.0, 1.0], [1.0, 1.0]]))
    for nat in (tnat, jnat):
        with pytest.raises(ZeroDivisionError):
            nat.ilu0(s.indptr, s.indices, s.data)


@pytest.mark.parametrize("lower", [True, False])
def test_levels_equal_the_references_with_and_without_the_core(lower, monkeypatch):
    rs = np.random.RandomState(0)
    s = sp.random(200, 200, density=0.04, format="csr", random_state=rs)
    s = ((sp.tril(s, k=-1) if lower else sp.triu(s, k=1)) + sp.diags(np.ones(200))).tocsr()
    rows, cols, strict, _ = ttri._split_triangle(tconv.from_scipy(s), lower)
    sr, sc = rows[strict], cols[strict]
    ref = jtri.compute_levels(sr, sc, 200, lower)
    native = ttri.compute_levels(sr, sc, 200, lower)
    monkeypatch.setattr(tnat, "_get", _unavailable)
    frontier = ttri.compute_levels(sr, sc, 200, lower)
    assert np.array_equal(native, ref) and np.array_equal(frontier, ref)
    assert native.dtype == frontier.dtype == np.int64


def test_levels_lower_equal_the_references():
    a = tconv.to_scipy(tgen.stencil_2d(14))
    low = sp.tril(a, k=-1).tocsr()
    got, nlev = tnat.levels_lower(a.shape[0], low.indptr, low.indices)
    ref, nref = jnat.levels_lower(a.shape[0], low.indptr, low.indices)
    assert np.array_equal(got, ref) and nlev == nref == 27


@pytest.mark.parametrize("case", ["aa_power_law", "ab_rectangular"])
def test_spgemm_equals_the_references(case):
    if case == "aa_power_law":
        a = b = tgen.power_law(400, avg_degree=6, seed=9)
    else:
        a = tgen.random_uniform(70, 110, density=0.06, seed=10)
        b = tgen.random_uniform(110, 50, density=0.06, seed=11)
    m, k = a.shape
    args = (m, k, b.shape[1], *_csr_arrays(a), *_csr_arrays(b))
    got, ref = tnat.spgemm(*args), jnat.spgemm(*args)
    for g, r in zip(got, ref):
        assert np.array_equal(g, r)
    d = abs(sp.csr_matrix((got[2], got[1], got[0]), shape=(m, b.shape[1]))
            - tconv.to_scipy(a) @ tconv.to_scipy(b))
    assert d.nnz == 0 or d.max() < 1e-12


def test_the_rest_of_the_surface_equals_the_references():
    """rcm, csr_to_bsr_arrays, aggregate and parse_mtx_body: bound for the
    tuner and AMG, held here to the reference's outputs."""
    a = jgen.stencil_2d(13)
    ip, ix, d = _csr_arrays(a)
    assert np.array_equal(tnat.rcm(ip, ix), jnat.rcm(ip, ix))
    for g, r in zip(tnat.csr_to_bsr_arrays(*a.shape, ip, ix, d, 4, 3),
                    jnat.csr_to_bsr_arrays(*a.shape, ip, ix, d, 4, 3)):
        assert np.array_equal(g, r)
    ga, na = tnat.aggregate(ip, ix)
    ra, nr = jnat.aggregate(ip, ix)
    assert np.array_equal(ga, ra) and na == nr
    body = b"1 2 0.5\n3 1 -2\n2 2 4e1\n"
    for g, r in zip(tnat.parse_mtx_body(body, 3, 1), jnat.parse_mtx_body(body, 3, 1)):
        assert np.array_equal(g, r)
    with pytest.raises(ValueError):
        tnat.parse_mtx_body(b"1 2", 3, 1)


def _unavailable():
    raise tnat.NativeUnavailable("native core unavailable (test)")


def test_without_the_core_callers_take_numpy_or_raise(monkeypatch):
    a = tgen.banded(80, 2, seed=3, spd=True)
    with_core = tilu.ilu0(a, device="cpu")
    pa = tgen.power_law(150, avg_degree=6, seed=5)
    native_c = tspgemm.spgemm(pa, backend="native")
    monkeypatch.setattr(tnat, "_get", _unavailable)
    assert not tnat.available()
    with pytest.raises(tnat.NativeUnavailable):
        tilu.ilu0(a, use_native=True, device="cpu")
    with pytest.raises(tnat.NativeUnavailable):
        tspgemm.spgemm(pa, backend="native")
    # use_native=None: the numpy IKJ, the same values to the last digits
    np.testing.assert_allclose(tilu.ilu0(a, device="cpu").lu.data, with_core.lu.data,
                               rtol=1e-13)
    # auto above the threshold: the plan path on the CPU, the native result
    monkeypatch.setattr(tspgemm, "_NATIVE_THRESHOLD", 10)
    c = tspgemm.spgemm(pa, backend="auto", device="cpu")
    assert isinstance(c.data, torch.Tensor)
    d = abs(tconv.to_scipy(c) - tconv.to_scipy(native_c))
    assert d.nnz == 0 or d.max() < 1e-12


def test_a_failed_build_is_unavailable(monkeypatch):
    monkeypatch.setattr(tnat, "_lib", None)
    monkeypatch.setattr(tnat, "_tried", False)
    monkeypatch.setattr(tnat, "lib_path", lambda: None)
    assert not tnat.available()
    with pytest.raises(tnat.NativeUnavailable):
        tnat.ilu0(np.array([0, 1]), np.array([0]), np.array([1.0]))
