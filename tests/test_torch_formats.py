"""Parity of the PyTorch port's formats, generators, converters, platform
table and interop with the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages; the port's
host arrays must equal the reference's exactly (np.array_equal, same dtype).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (kept on the CPU with x64 by conftest)
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cask_tpu.formats.convert as jconv
import cask_tpu.formats.generate as jgen
import cask_tpu_torch.formats.convert as tconv
import cask_tpu_torch.formats.generate as tgen
from cask_tpu_torch import interop
from cask_tpu_torch.formats.matrix import BSR, COO, CSR
from cask_tpu_torch.utils import platform

REPO = Path(__file__).resolve().parents[1]


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (a.dtype, b.dtype)
    assert np.array_equal(a, b)


def _same_matrix(t, j):
    """Port matrix ``t`` equals reference matrix ``j`` field by field."""
    assert type(t).__name__ == type(j).__name__
    assert t.shape == j.shape
    for f in ("data", "indices", "indptr", "row", "col"):
        if hasattr(j, f):
            _same(getattr(t, f), getattr(j, f))
    if hasattr(j, "blocksize"):
        assert t.blocksize == j.blocksize


class TestGenerators:
    @pytest.mark.parametrize("points", [5, 9])
    def test_stencil_2d(self, points):
        _same_matrix(tgen.stencil_2d(13, 9, points=points), jgen.stencil_2d(13, 9, points=points))

    @pytest.mark.parametrize("dof", [2, 4, 8])
    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_fem_blocks(self, dof, dtype):
        _same_matrix(tgen.fem_blocks(9, dof=dof, dtype=dtype, seed=3),
                     jgen.fem_blocks(9, dof=dof, dtype=dtype, seed=3))
        _same_matrix(tgen.fem_blocks(9, 7, dof=dof, dtype=dtype, return_bsr=True),
                     jgen.fem_blocks(9, 7, dof=dof, dtype=dtype, return_bsr=True))

    @pytest.mark.parametrize("density,spd", [(1.0, False), (0.35, True)])
    def test_banded(self, density, spd):
        _same_matrix(tgen.banded(301, 7, density=density, seed=1, spd=spd),
                     jgen.banded(301, 7, density=density, seed=1, spd=spd))

    def test_power_law(self):
        _same_matrix(tgen.power_law(500, seed=2), jgen.power_law(500, seed=2))
        _same_matrix(tgen.power_law(300, seed=4, symmetric=False),
                     jgen.power_law(300, seed=4, symmetric=False))

    def test_diag_shift(self):
        a = jgen.fem_blocks(6, dof=2, dtype=np.float32)
        t = tconv.coo_to_csr(tconv.coo_from_arrays(a.data, np.repeat(
            np.arange(a.shape[0]), np.diff(a.indptr)), a.indices, a.shape))
        _same_matrix(tgen._diag_shift(t, 1.1), jgen._diag_shift(a, 1.1))


class TestConverters:
    @pytest.fixture()
    def triples(self):
        rng = np.random.default_rng(7)
        m, n, nnz = 37, 29, 300  # with duplicate coordinates
        return (rng.standard_normal(nnz), rng.integers(0, m, nnz), rng.integers(0, n, nnz),
                (m, n))

    def test_coo_to_csr_sums_duplicates(self, triples):
        t = tconv.coo_from_arrays(*triples)
        j = jconv.coo_from_arrays(*triples)
        _same_matrix(t, j)
        _same_matrix(tconv.coo_to_csr(t), jconv.coo_to_csr(j))
        _same_matrix(tconv.coo_to_csr(t, sum_duplicates=False),
                     jconv.coo_to_csr(j, sum_duplicates=False))
        np.testing.assert_allclose(tconv.coo_to_csr(t).todense(), t.todense(), rtol=1e-14)

    @pytest.mark.parametrize("n,spans", [(0, (5, 3)), (1, (5, 3)), (4000, (50, 7, 3)),
                                         (4000, (2 ** 40, 2 ** 30))])
    def test_lex_order_is_lexsorts(self, n, spans):
        # one stable argsort of a combined key, or lexsort itself where the
        # keys' ranges overflow it (the last case): the same order, ties kept
        rng = np.random.default_rng(8)
        keys = tuple(rng.integers(0, s, n) for s in spans)
        _same(tconv.lex_order(*keys), np.lexsort(keys))

    def test_coo_bounds_checked(self):
        with pytest.raises(ValueError):
            tconv.coo_from_arrays([1.0], [5], [0], (5, 5))

    def test_csr_to_coo(self, triples):
        j = jconv.coo_to_csr(jconv.coo_from_arrays(*triples))
        t = tconv.coo_to_csr(tconv.coo_from_arrays(*triples))
        _same_matrix(tconv.csr_to_coo(t), jconv.csr_to_coo(j))

    @pytest.mark.parametrize("blocksize", [(4, 4), (4, 2), (3, 5), 2])
    def test_csr_bsr_roundtrip(self, blocksize):
        a = jgen.stencil_2d(11)  # 121 rows: ragged at every block size here
        t = tgen.stencil_2d(11)
        tb, jb = tconv.csr_to_bsr(t, blocksize), jconv.csr_to_bsr(a, blocksize)
        _same_matrix(tb, jb)
        assert (tb.nnz, tb.padded_shape, tb.n_block_rows, tb.n_block_cols) == \
            (jb.nnz, jb.padded_shape, jb.n_block_rows, jb.n_block_cols)
        _same(tb.todense(), jb.todense())
        _same_matrix(tconv.bsr_to_csr(tb), jconv.bsr_to_csr(jb))
        _same_matrix(tconv.bsr_to_csr(tb, prune=False), jconv.bsr_to_csr(jb, prune=False))

    def test_transpose(self, triples):
        jc = jconv.coo_from_arrays(*triples)
        tc = tconv.coo_from_arrays(*triples)
        _same_matrix(tconv.transpose(tc), jconv.transpose(jc))
        _same_matrix(tconv.transpose(tconv.coo_to_csr(tc)),
                     jconv.transpose(jconv.coo_to_csr(jc)))
        jb = jconv.csr_to_bsr(jconv.coo_to_csr(jc), (4, 2))
        tb = tconv.csr_to_bsr(tconv.coo_to_csr(tc), (4, 2))
        _same_matrix(tconv.transpose(tb), jconv.transpose(jb))
        with pytest.raises(TypeError):
            tconv.transpose(np.eye(3))

    @pytest.mark.parametrize("fmt", [None, "coo", "bsr:2x3", ("bsr", (4, 4))])
    def test_scipy_roundtrip(self, fmt):
        s = sp.random(40, 36, density=0.1, random_state=np.random.RandomState(5), format="csr")
        t, j = tconv.from_scipy(s, fmt), jconv.from_scipy(s, fmt)
        _same_matrix(t, j)
        st, sj = tconv.to_scipy(t), jconv.to_scipy(j)
        assert (st != sj).nnz == 0 and st.shape == sj.shape

    def test_device_arrays_convert_through_host(self):
        a = tgen.fem_blocks(5, dof=2)
        on_dev = a.to("cpu")  # tensors, as on a GPU
        assert isinstance(on_dev.data, torch.Tensor)
        _same_matrix(tconv.csr_to_bsr(on_dev, (2, 2)), tconv.csr_to_bsr(a, (2, 2)))
        assert (tconv.to_scipy(on_dev) != tconv.to_scipy(a)).nnz == 0


class TestContainers:
    def test_to_and_astype(self):
        a = tgen.fem_blocks(5, dof=4, return_bsr=True)
        b = a.to("cpu").astype(np.float32)
        assert b.data.dtype == torch.float32 and b.indices.dtype == torch.int32
        assert b.shape == a.shape and b.blocksize == a.blocksize
        np.testing.assert_allclose(b.todense(), a.todense(), rtol=1e-6)
        assert a.astype(np.float32).data.dtype == np.float32
        coo = tconv.csr_to_coo(tgen.stencil_2d(4))
        assert coo.to("cpu").astype(torch.float32).data.dtype == torch.float32
        assert coo.nnz == 16 + 2 * 2 * (4 * 3)  # diagonal + both directions of 2·4·3 links

    def test_identity_equality(self):
        a = tgen.stencil_2d(3)
        assert a == a and a != tgen.stencil_2d(3)
        assert len({a, CSR(a.data, a.indices, a.indptr, a.shape)}) == 2
        assert COO.__hash__ is not None and BSR.__hash__ is not None


class TestPlatform:
    @pytest.mark.parametrize("name,bw", [("NVIDIA H100 80GB HBM3", 3.35e12),
                                         ("NVIDIA H100 PCIe", 2.0e12),
                                         ("NVIDIA H100 NVL", 3.9e12)])
    def test_hbm_table(self, name, bw):
        assert platform.hbm_bandwidth(name) == (bw, True)

    def test_unknown_card_has_no_number(self):
        assert platform.hbm_bandwidth("TPU v5 lite") == (None, False)

    def test_no_cpu_fallback(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError):
            platform.default_device()


class TestInterop:
    def test_csr_and_bsr_from_arrays(self):
        j = jgen.fem_blocks(6, dof=4)
        t = interop.csr_from_arrays(np.asarray(j.data), np.asarray(j.indices),
                                    np.asarray(j.indptr), j.shape, device="cpu")
        assert isinstance(t.data, torch.Tensor) and t.indices.dtype == torch.int32
        _same(t.todense(), j.todense())
        jb = jconv.csr_to_bsr(j, (4, 2))
        tb = interop.bsr_from_arrays(jb.data, jb.indices, jb.indptr, jb.shape, jb.blocksize,
                                     device="cpu")
        _same(tb.todense(), jb.todense())

    def test_rejects_inconsistent_arrays(self):
        j = jgen.stencil_2d(4)
        with pytest.raises(ValueError):
            interop.csr_from_arrays(j.data, j.indices, j.indptr[:-1], j.shape, device="cpu")
        with pytest.raises(ValueError):
            interop.csr_from_arrays(j.data, j.indices.astype(np.float32), j.indptr, j.shape,
                                    device="cpu")
        jb = jconv.csr_to_bsr(j, (4, 4))
        with pytest.raises(ValueError):
            interop.bsr_from_arrays(jb.data, jb.indices, jb.indptr, jb.shape, (2, 2),
                                    device="cpu")


def test_import_leaves_out_jax_and_the_reference():
    code = ("import sys; import cask_tpu_torch, cask_tpu_torch.interop, "
            "cask_tpu_torch.tune.timing, cask_tpu_torch.utils.platform, "
            "cask_tpu_torch.formats.mtx, cask_tpu_torch.ops.poh, cask_tpu_torch.ops.lell, "
            "cask_tpu_torch.ops.kernels.poh_kernels, cask_tpu_torch.ops.kernels.lell_kernels, "
            "cask_tpu_torch.utils.debug; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'jaxlib')) "
            "or m == 'cask_tpu' or m.startswith('cask_tpu.')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
