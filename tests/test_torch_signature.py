"""The port's sparsity signature, RCM reordering and BDIA traffic estimate
against the JAX package's, on the CPU.

``Signature`` fields, ``key()`` and ``class_key()`` equal the reference's
(the key is the tuner cache's key); ``rcm_permutation`` equals the
reference's on the native core and on the Python BFS; ``permute_symmetric``,
``reorder_rcm``, ``bandwidth`` and ``estimate_bdia_traffic`` give the
reference's arrays and floats exactly.
"""

import dataclasses

import jax  # noqa: F401  (kept on the CPU with x64 by conftest)
import numpy as np
import pytest
import scipy.sparse as sp

import cask_tpu.formats.convert as jconv
import cask_tpu.formats.generate as jgen
import cask_tpu.formats.reorder as jreorder
import cask_tpu.native.binding as jnat
import cask_tpu_torch as ct
import cask_tpu_torch.formats.convert as tconv
import cask_tpu_torch.formats.generate as tgen
import cask_tpu_torch.formats.reorder as treorder
import cask_tpu_torch.native.binding as tnat
from cask_tpu.formats.signature import signature as jsignature
from cask_tpu.ops.bdia import estimate_bdia_traffic as j_estimate
from cask_tpu_torch.formats.signature import occupied_blocks, signature as tsignature
from cask_tpu_torch.native import NativeUnavailable
from cask_tpu_torch.ops.bdia import estimate_bdia_traffic as t_estimate

# generator name, args, kwargs: each builds the same matrix in both packages
MATRICES = {
    "fem_blocks dof 2": ("fem_blocks", (9,), {"dof": 2}),
    "fem_blocks dof 4": ("fem_blocks", (7,), {"dof": 4}),
    "fem_blocks dof 8": ("fem_blocks", (5,), {"dof": 8}),
    "stencil_2d": ("stencil_2d", (17,), {}),
    "stencil_2d 9-point": ("stencil_2d", (13,), {"points": 9}),
    "banded": ("banded", (300, 4), {"seed": 2}),
    "banded thinned": ("banded", (257, 9), {"density": 0.4, "seed": 5}),
    "power_law": ("power_law", (500,), {"avg_degree": 6, "seed": 3}),
    "random_uniform": ("random_uniform", (200, 150), {"density": 0.03, "seed": 4}),
}


def _pair(name, dtype=np.float64):
    fn, args, kw = MATRICES[name]
    return (getattr(jgen, fn)(*args, dtype=dtype, **kw),
            getattr(tgen, fn)(*args, dtype=dtype, **kw))


def _assert_same_signature(js, ts):
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert ts.key() == js.key()
    assert ts.class_key() == js.class_key()


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_signature_equals_the_reference(name, dtype):
    ja, ta = _pair(name, dtype)
    _assert_same_signature(jsignature(ja), tsignature(ta))


@pytest.mark.parametrize("name", ["fem_blocks dof 4", "power_law"])
def test_signature_of_a_coo_and_a_bsr(name):
    ja, ta = _pair(name)
    _assert_same_signature(jsignature(jconv.csr_to_coo(ja)), tsignature(tconv.csr_to_coo(ta)))
    _assert_same_signature(jsignature(jconv.csr_to_bsr(ja, (4, 4))),
                           tsignature(tconv.csr_to_bsr(ta, (4, 4))))


def test_signature_of_an_empty_matrix():
    s = sp.csr_matrix((6, 9))
    _assert_same_signature(jsignature(jconv.from_scipy(s, format="csr")),
                           tsignature(tconv.from_scipy(s, format="csr")))


def test_signature_of_device_tensors_equals_host():
    _, ta = _pair("fem_blocks dof 4", np.float32)
    assert tsignature(ta.to("cpu")).key() == tsignature(ta).key()
    assert tsignature(ta.to("cpu")).dtype == "float32"


def test_signature_of_unsorted_rows_with_duplicates_equals_the_reference():
    # a CSR built by hand: columns out of order and repeated within rows
    indptr = np.array([0, 4, 6, 9], np.int32)
    indices = np.array([9, 0, 9, 4, 33, 1, 2, 40, 2], np.int32)
    data = np.arange(1.0, 10.0)
    ja = jconv.CSR(data=data, indices=indices, indptr=indptr, shape=(3, 41))
    ta = tconv.CSR(data=data, indices=indices, indptr=indptr, shape=(3, 41))
    _assert_same_signature(jsignature(ja), tsignature(ta))


def test_occupied_blocks_equals_one_unique_per_size():
    rng = np.random.default_rng(0)
    rows = np.sort(rng.integers(0, 300, 5000))
    cols = rng.integers(0, 211, 5000)
    sizes = (4, 8, 16, 32)
    want = [np.unique((rows // b) * (-(-211 // b)) + cols // b).size for b in sizes]
    assert occupied_blocks(rows, cols, 211, sizes) == want


def test_signature_rejects_a_plan():
    with pytest.raises(TypeError):
        tsignature(np.zeros((3, 3)))


# -- RCM ------------------------------------------------------------------------


def _shuffled_banded(n=400, bw=4, seed=2):
    s = jconv.to_scipy(jgen.banded(n, bw, seed=seed))
    p = np.random.default_rng(0).permutation(n)
    s = s.tocsr()[p][:, p].tocsr()
    return jconv.from_scipy(s, format="csr"), tconv.from_scipy(s, format="csr")


RCM_CASES = {
    "shuffled band": _shuffled_banded,
    "power_law": lambda: _pair("power_law"),
    "fem_blocks": lambda: _pair("fem_blocks dof 2"),
    "nonsymmetric pattern": lambda: (jgen.random_uniform(150, density=0.02, seed=7),
                                     tgen.random_uniform(150, density=0.02, seed=7)),
}


@pytest.mark.parametrize("case", sorted(RCM_CASES))
def test_symmetrized_pattern_equals_the_reference(case):
    ja, ta = RCM_CASES[case]()
    js, ts = jreorder._symmetrize_pattern(ja), treorder._symmetrize_pattern(ta)
    for f in ("data", "indices", "indptr"):
        want = np.asarray(getattr(js, f))
        got = getattr(ts, f)
        assert got.dtype == want.dtype and np.array_equal(got, want), f


@pytest.mark.parametrize("case", sorted(RCM_CASES))
def test_rcm_permutation_native_equals_the_reference(case):
    assert tnat.available() and jnat.available()  # both cores build here
    ja, ta = RCM_CASES[case]()
    want = np.asarray(jreorder.rcm_permutation(ja))
    got = treorder.rcm_permutation(ta)
    assert got.dtype == np.int32 and np.array_equal(got, want)


@pytest.mark.parametrize("case", sorted(RCM_CASES))
def test_rcm_permutation_python_equals_the_reference(case, monkeypatch):
    ja, ta = RCM_CASES[case]()

    def no_core(*args):
        raise NativeUnavailable("test: the core is not built")

    def no_jax_core(*args):
        raise OSError("test: the core is not built")

    monkeypatch.setattr(tnat, "rcm", no_core)
    monkeypatch.setattr(jnat, "rcm", no_jax_core)
    want = np.asarray(jreorder.rcm_permutation(ja))
    got = treorder.rcm_permutation(ta)
    assert np.array_equal(got, want)
    assert np.array_equal(np.sort(got), np.arange(ta.shape[0]))


def test_rcm_needs_a_square_matrix():
    with pytest.raises(ValueError):
        treorder.rcm_permutation(tgen.random_uniform(10, 12, density=0.2, seed=1))


@pytest.mark.parametrize("case", sorted(RCM_CASES))
def test_reorder_and_permute_equal_the_reference(case):
    ja, ta = RCM_CASES[case]()
    jr, jperm = jreorder.reorder_rcm(ja)
    tr, tperm = ct.reorder_rcm(ta)
    assert np.array_equal(tperm, np.asarray(jperm))
    for f in ("data", "indices", "indptr"):
        assert np.array_equal(getattr(tr, f), np.asarray(getattr(jr, f))), f
    assert ct.bandwidth(tr) == jreorder.bandwidth(jr) <= jreorder.bandwidth(ja) \
        == ct.bandwidth(ta)
    # P A Pᵀ of an explicit permutation, against scipy
    p = np.random.default_rng(1).permutation(ta.shape[0]).astype(np.int32)
    tp = treorder.permute_symmetric(ta, p)
    jp = jreorder.permute_symmetric(ja, p)
    for f in ("data", "indices", "indptr"):
        assert np.array_equal(getattr(tp, f), np.asarray(getattr(jp, f))), f
    s = tconv.to_scipy(ta)
    assert (tconv.to_scipy(tp) != s[p][:, p]).nnz == 0


def test_bandwidth_of_an_empty_matrix():
    assert ct.bandwidth(tconv.from_scipy(sp.csr_matrix((4, 4)), format="csr")) == 0


# -- the BDIA traffic estimate -------------------------------------------------------


@pytest.mark.parametrize("name", sorted(MATRICES))
@pytest.mark.parametrize("b", [4, 8, 16, 32])
def test_estimate_bdia_traffic_equals_the_reference(name, b):
    ja, ta = _pair(name)
    want, got = j_estimate(ja, b), t_estimate(ta, b)
    assert got == want  # exact floats, or both None


def test_estimate_bdia_traffic_of_a_remainder_and_an_empty_matrix():
    s = jconv.to_scipy(jgen.fem_blocks(8, dof=4)).tolil()
    rng = np.random.default_rng(3)
    for _ in range(40):  # scattered entries far off the block band
        s[int(rng.integers(0, 256)), int(rng.integers(0, 256))] = 1.0
    s = s.tocsr()
    ja, ta = jconv.from_scipy(s, format="csr"), tconv.from_scipy(s, format="csr")
    for b in (4, 8):
        assert t_estimate(ta, b) == j_estimate(ja, b)
    e = sp.csr_matrix((16, 16))
    assert t_estimate(tconv.from_scipy(e, format="csr"), 4) is None
    assert j_estimate(jconv.from_scipy(e, format="csr"), 4) is None
