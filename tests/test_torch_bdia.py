"""Parity of the port's BDIA plan, plain twin and operator with the JAX
package, on the CPU (the kernel on the card: tests/test_torch_gpu.py).

The reference's Pallas kernels run as tests/test_bdia.py runs them: in
interpret mode on the CPU.  Tolerances: f64 ≤ 1e-12 normwise (the same
products in the same pair order), f32 ≤ 1e-5.
"""

import jax  # noqa: F401  (kept on the CPU with x64 by conftest)
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cask_tpu.formats.convert as jconv
import cask_tpu.formats.generate as jgen
import cask_tpu.ops.bdia as jbdia
import cask_tpu_torch.formats.convert as tconv
import cask_tpu_torch.formats.generate as tgen
import cask_tpu_torch.ops.bdia as tbdia
from cask_tpu.ops.pallas.bdia_kernels import (bdia_spmv_pallas_fused,
                                              bdia_spmv_pallas_resident)
from cask_tpu_torch import interop
from cask_tpu_torch.ops.kernels import build
from cask_tpu_torch.ops.kernels.bdia_kernels import (MAX_PAIRS, bdia_kernel_ok, bdia_spmv,
                                                     bdia_spmv_reference)

TOL = {np.float32: 1e-5, np.float64: 1e-12}


def _relerr(y, ref):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(y - ref) / np.linalg.norm(ref)


def _with_remainder(gen, dtype=np.float64):
    """fem_blocks(6, dof=4) plus scattered 4×4 blocks that spill to the COO
    remainder (tests/test_bdia.py::test_fused_with_remainder)."""
    s = gen.fem_blocks(6, dof=4, dtype=np.float64)
    s = sp.csr_matrix((np.asarray(s.data), np.asarray(s.indices), np.asarray(s.indptr)),
                      shape=s.shape).tolil()
    rng = np.random.default_rng(16)
    for _ in range(6):
        bi, bj = int(rng.integers(0, 20)), int(rng.integers(0, 20))
        s[bi * 4 : bi * 4 + 4, bj * 4 : bj * 4 + 4] = rng.standard_normal((4, 4))
    return s.tocsr().astype(dtype)


# name -> (reference matrix, port matrix, blocksize), same host arrays
def _case(name, dtype=np.float64):
    if name.startswith("fem"):
        dof = int(name[-1])
        return (jgen.fem_blocks(7, dof=dof, dtype=dtype),
                tgen.fem_blocks(7, dof=dof, dtype=dtype), (dof, dof))
    if name == "remainder":
        s = _with_remainder(jgen, dtype)
        return jconv.from_scipy(s), tconv.from_scipy(s), (4, 4)
    if name == "rect4x2":
        return (jgen.fem_blocks(6, dof=4, dtype=dtype), tgen.fem_blocks(6, dof=4, dtype=dtype),
                (4, 2))
    if name == "band_as_blocks":
        return (jgen.banded(257, 3, seed=5, dtype=dtype), tgen.banded(257, 3, seed=5, dtype=dtype),
                (4, 4))
    if name == "ragged":
        return jgen.stencil_2d(11, dtype=dtype), tgen.stencil_2d(11, dtype=dtype), (4, 4)
    raise KeyError(name)


CASES = ["fem2", "fem4", "fem8", "remainder", "rect4x2", "band_as_blocks", "ragged"]


def _plans(name, dtype=np.float64):
    j, t, bs = _case(name, dtype)
    return jbdia.bdia_plan(j, bs), tbdia.bdia_plan(t, bs, device="cpu")


class TestPlanPacking:
    @pytest.mark.parametrize("name", CASES)
    def test_packs_exactly_like_the_reference(self, name):
        jp, tp = _plans(name)
        for f in ("vals", "rem_data", "rem_row", "rem_col"):
            jv, tv = np.asarray(getattr(jp, f)), getattr(tp, f).numpy()
            assert jv.dtype == tv.dtype and np.array_equal(jv, tv), f
        assert (tp.block_offsets, tp.shape, tp.blocksize, tp.ts) == \
            (jp.block_offsets, jp.shape, jp.blocksize, jp.ts)
        assert (tp.nbr, tp.nbc, tp.nb_pad, tp.n_tiles, tp.npairs, tp.lo, tp.hi, tp.pairs,
                tp.traffic_bytes) == (jp.nbr, jp.nbc, jp.nb_pad, jp.n_tiles, jp.npairs,
                                      jp.lo, jp.hi, jp.pairs, jp.traffic_bytes)
        if name == "remainder":
            assert tp.rem_data.shape[0] > 0

    @pytest.mark.parametrize("nbr", [1, 100, 1023, 8192, 9000, 262144])
    def test_pick_ts(self, nbr):
        assert tbdia._pick_ts(nbr) == jbdia._pick_ts(nbr)

    def test_plan_from_bsr_and_csr_agree(self):
        a = tgen.fem_blocks(5, dof=2, return_bsr=True)
        p1 = tbdia.bdia_plan(a)
        p2 = tbdia.bdia_plan(tconv.bsr_to_csr(a, prune=False), (2, 2))
        assert torch.equal(p1.vals, p2.vals)
        with pytest.raises(ValueError):
            tbdia.bdia_plan(tconv.bsr_to_csr(a))

    @pytest.mark.parametrize("name", ["fem4", "remainder", "rect4x2"])
    def test_bdia_to_coo_and_transpose_plan(self, name):
        jp, tp = _plans(name)
        jc, tc = jbdia.bdia_to_coo(jp), tbdia.bdia_to_coo(tp)
        for f in ("data", "row", "col"):
            assert np.array_equal(np.asarray(getattr(jc, f)), getattr(tc, f))
        jt, tt = jbdia.transpose_plan(jp), tbdia.transpose_plan(tp)
        assert np.array_equal(np.asarray(jt.vals), tt.vals.numpy())
        assert np.array_equal(np.asarray(jt.rem_data), tt.rem_data.numpy())
        assert (tt.block_offsets, tt.blocksize, tt.shape) == \
            (jt.block_offsets, jt.blocksize, jt.shape)

    def test_to_and_astype(self):
        _, tp = _plans("fem2")
        p32 = tp.astype(np.float32).to("cpu")
        assert p32.dtype == torch.float32 and p32.rem_row.dtype == torch.int32
        assert p32.device.type == "cpu"


class TestTwinAgainstReference:
    @pytest.mark.parametrize("name", CASES)
    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_matches_spmv_xla(self, name, dtype):
        jp, tp = _plans(name, dtype)
        x = np.random.default_rng(1).standard_normal(jp.shape[1]).astype(dtype)
        y_ref = np.asarray(jp._spmv_xla(x))
        y = tp._spmv_reference(torch.from_numpy(x))
        assert y.dtype == torch.from_numpy(x).dtype
        assert _relerr(y, y_ref) <= TOL[dtype]
        # the wrapper on a CPU tensor is the twin; it launches nothing
        before = bdia_spmv.launches
        assert torch.equal(tp.spmv(torch.from_numpy(x)), y)
        assert bdia_spmv.launches == before

    @pytest.mark.parametrize("name", ["fem2", "fem4", "remainder", "rect4x2"])
    def test_matches_pallas_fused_kernel(self, name):
        # B1 (bdia_spmv_pallas_fused) in interpret mode, f64: the packed
        # part against the kernel alone, then with the remainder added
        # outside the kernel, as the reference's method='fused' does
        jp, tp = _plans(name)
        x = np.random.default_rng(2).standard_normal(jp.shape[1])
        y_kernel = np.asarray(bdia_spmv_pallas_fused(jp, x))
        xt = torch.from_numpy(x)
        assert _relerr(bdia_spmv_reference(tp, xt), y_kernel) <= TOL[np.float64]
        y_ref = y_kernel
        if jp.rem_data.shape[0]:
            y_ref = y_ref + np.asarray(jp._remainder_spmv(x))
        assert _relerr(tp.spmv(xt), y_ref) <= TOL[np.float64]

    def test_matches_pallas_fused_kernel_f32(self):
        jp, tp = _plans("fem4", np.float32)
        x = np.random.default_rng(3).standard_normal(jp.shape[1]).astype(np.float32)
        y_ref = np.asarray(bdia_spmv_pallas_fused(jp, x))
        assert _relerr(tp.spmv(torch.from_numpy(x)), y_ref) <= TOL[np.float32]

    @pytest.mark.parametrize("name", ["fem2", "fem4", "fem8"])
    def test_matches_pallas_resident_kernel(self, name):
        # B2 (bdia_spmv_pallas_resident) in interpret mode, decoded with
        # from_resident; the port's operator runs in natural order
        jp, tp = _plans(name)
        x = np.random.default_rng(4).standard_normal(jp.shape[1])
        y_ref = np.asarray(jp.from_resident(bdia_spmv_pallas_resident(jp, jp.to_resident(x))))
        op = tbdia.BdiaOperator(tp)
        y = op.from_padded(op(op.to_padded(x)))
        assert _relerr(y, y_ref) <= TOL[np.float64]

    @pytest.mark.parametrize("name", ["fem4", "remainder", "rect4x2"])
    def test_interop_plan_computes_the_same_y(self, name):
        jp, tp = _plans(name)
        ip = interop.bdia_from_arrays(
            np.asarray(jp.vals), np.asarray(jp.rem_data), np.asarray(jp.rem_row),
            np.asarray(jp.rem_col), block_offsets=jp.block_offsets, shape=jp.shape,
            blocksize=jp.blocksize, ts=jp.ts, device="cpu")
        x = np.random.default_rng(5).standard_normal(jp.shape[1])
        y_ref = np.asarray(jp._spmv_xla(x))
        y = ip.spmv(torch.from_numpy(x))
        assert _relerr(y, y_ref) <= TOL[np.float64]
        assert torch.equal(y, tp.spmv(torch.from_numpy(x)))

    def test_interop_rejects_a_bad_layout(self):
        jp, _ = _plans("fem4")
        with pytest.raises(ValueError):
            interop.bdia_from_arrays(np.asarray(jp.vals)[:, :, :-1], np.asarray(jp.rem_data),
                                     np.asarray(jp.rem_row), np.asarray(jp.rem_col),
                                     block_offsets=jp.block_offsets, shape=jp.shape,
                                     blocksize=jp.blocksize, ts=jp.ts, device="cpu")


class TestOperator:
    def test_reference_mode_on_cpu(self):
        jp, tp = _plans("remainder")
        op = tbdia.BdiaOperator(tp)
        assert op.mode == "reference"
        x = torch.from_numpy(np.random.default_rng(6).standard_normal(tp.shape[1]))
        assert torch.equal(op.from_padded(op.to_padded(x)), x)
        assert torch.equal(op(x), tp.spmv(x))

    def test_builds_its_plan(self):
        a = tgen.fem_blocks(5, dof=2, return_bsr=True)
        op = tbdia.BdiaOperator(a)
        assert op.bdia.blocksize == (2, 2) and op.mode == "reference"

    def test_kernel_gate(self):
        # 201 block diagonals capped at 64 kept: 128 (d, c) pairs > the limit
        a = tconv.csr_to_bsr(tgen.banded(600, 200, seed=1), (2, 2))
        p = tbdia.bdia_plan(a)
        assert p.npairs > MAX_PAIRS and not bdia_kernel_ok(p)
        _, ok = _plans("fem8")
        assert bdia_kernel_ok(ok) and not bdia_kernel_ok(ok.astype(torch.bfloat16))


class TestBuild:
    def test_missing_nvcc_raises(self, monkeypatch, tmp_path):
        monkeypatch.setenv("CUDA_HOME", str(tmp_path))
        monkeypatch.setenv("PATH", str(tmp_path))
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.find_nvcc()

    def test_library_is_keyed_by_source(self):
        p = build.library_path("bdia_spmv")
        assert p.parent == build.BUILD_DIR and p.name.startswith("libbdia_spmv_")
        assert p == build.library_path("bdia_spmv")
        assert (build.CSRC / "bdia_spmv.cu").is_file()


