"""Parity of the port's ELL-packed BSR SpMM plan and twin with the JAX
package, on the CPU (the kernel on the card: tests/test_torch_gpu.py).

The reference's kernel (B7, ``BsrSpmmKernel``) runs in interpret mode, as
tests/test_pallas_kernels.py runs it.  The packed ``vals``/``cols`` must
equal the reference's exactly.  Tolerances: f64 ≤ 1e-12 normwise, f32 ≤ 1e-5.
"""

import jax  # noqa: F401  (kept on the CPU with x64 by conftest)
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cask_tpu.formats.convert as jconv
from cask_tpu.ops.pallas.bsr_kernels import BsrSpmmKernel as JBsrSpmmKernel
from cask_tpu.ops.pallas.bsr_kernels import bsr_spmm_pallas
import cask_tpu_torch.formats.convert as tconv
from cask_tpu_torch import interop
from cask_tpu_torch.formats.generate import fem_blocks, stencil_2d
from cask_tpu_torch.ops.bsr_spmm import BsrSpmmKernel, spmm_bsr
from cask_tpu_torch.ops.kernels.bsr_kernels import bsr_spmm, bsr_spmm_reference
from cask_tpu_torch.ops.spmm import spmm

TOL = {np.float32: 1e-5, np.float64: 1e-12}


def _relerr(y, ref):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(y - ref) / np.linalg.norm(ref)


def _ragged_rows():
    """Rows with very different block counts (tests/test_pallas_kernels.py)."""
    rs = np.random.RandomState(4)
    return (sp.random(96, 96, density=0.02, format="csr", random_state=rs)
            + sp.diags(np.ones(96))).tocsr()


CASES = {  # name -> (scipy matrix, blocksize)
    "fem_dof2": lambda: (tconv.to_scipy(fem_blocks(9, dof=2)), 2),
    "fem_dof3": lambda: (tconv.to_scipy(fem_blocks(9, dof=3)), 3),
    "fem_dof4": lambda: (tconv.to_scipy(fem_blocks(9, dof=4)), 4),
    "ragged_n": lambda: (tconv.to_scipy(stencil_2d(11)), 4),  # 121 rows: a partial block
    "ragged_rows": lambda: (_ragged_rows(), 8),
}


def _pair(name, dtype=np.float64):
    """(reference BSR, port BSR, scipy) of the same host matrix."""
    s, b = CASES[name]()
    s = s.astype(dtype)
    return (jconv.csr_to_bsr(jconv.from_scipy(s), b), tconv.csr_to_bsr(tconv.from_scipy(s), b),
            s)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plan_equals_the_reference(name, dtype):
    j, t, _ = _pair(name, dtype)
    jk, tk = JBsrSpmmKernel.plan(j, k=32), BsrSpmmKernel.plan(t, k=32, device="cpu")
    for f in ("vals", "cols"):
        jv, tv = np.asarray(getattr(jk, f)), getattr(tk, f).numpy()
        assert jv.dtype == tv.dtype and np.array_equal(jv, tv), f
    assert (tk.shape, tk.blocksize, tk.G, tk.K, tk.k) == (jk.shape, jk.blocksize, jk.G, jk.K,
                                                          jk.k)


@pytest.mark.parametrize("name,k,transpose", [("fem_dof4", 128, False), ("fem_dof3", 20, True),
                                              ("ragged_n", 65, False),
                                              ("ragged_rows", 8, True)])
def test_twin_matches_the_reference_kernel(name, k, transpose):
    j, t, s = _pair(name)
    x = np.random.default_rng(1).standard_normal((s.shape[0] if transpose else s.shape[1], k))
    y_ref = np.asarray(bsr_spmm_pallas(j, jnp.asarray(x), transpose=transpose))
    y = spmm_bsr(t, torch.from_numpy(x), transpose=transpose)
    assert y.shape == y_ref.shape
    assert _relerr(y, y_ref) <= 1e-12
    assert _relerr(y, (s.T if transpose else s) @ x) <= 1e-12


@pytest.mark.parametrize("vals_dtype,x_dtype", [(np.float32, np.float32),
                                                (np.float64, np.float64),
                                                (np.float32, np.float64)])
def test_output_type_follows_the_reference(vals_dtype, x_dtype):
    # the output has the values' type, summed in promote(vals, f32)
    j, t, s = _pair("fem_dof4", vals_dtype)
    x = np.random.default_rng(2).standard_normal((s.shape[1], 16)).astype(x_dtype)
    jk = JBsrSpmmKernel.plan(j, k=16)
    y_ref = jk(jnp.asarray(x))
    y = BsrSpmmKernel.plan(t, k=16, device="cpu")(torch.from_numpy(x))
    assert y.dtype == torch.from_numpy(np.zeros(0, np.dtype(str(y_ref.dtype)))).dtype
    assert _relerr(y, np.asarray(y_ref)) <= TOL[vals_dtype]


def test_bsr_spmm_from_arrays():
    j, _, s = _pair("ragged_n")
    jk = JBsrSpmmKernel.plan(j, k=8)
    tk = interop.bsr_spmm_from_arrays(np.asarray(jk.vals), np.asarray(jk.cols), shape=jk.shape,
                                      blocksize=jk.blocksize, G=jk.G, K=jk.K, k=jk.k,
                                      device="cpu")
    x = np.random.default_rng(3).standard_normal((s.shape[1], 8))
    assert _relerr(tk(torch.from_numpy(x)), np.asarray(jk(jnp.asarray(x)))) <= 1e-12
    with pytest.raises(ValueError):
        interop.bsr_spmm_from_arrays(np.asarray(jk.vals), np.asarray(jk.cols)[1:],
                                     shape=jk.shape, blocksize=jk.blocksize, G=jk.G, K=jk.K,
                                     k=jk.k, device="cpu")


def test_method_pallas_bsr_needs_a_bsr():
    _, t, s = _pair("fem_dof2")
    x = torch.zeros((s.shape[1], 4), dtype=torch.float64)
    with pytest.raises(TypeError, match="BSR"):
        spmm(tconv.bsr_to_csr(t), x, method="pallas_bsr")
    # a CPU X runs the twin: the wrapper counts no launch
    before = bsr_spmm.launches
    p = BsrSpmmKernel.plan(t, k=4, device="cpu")
    assert torch.equal(p(x), bsr_spmm_reference(p, x)) and bsr_spmm.launches == before
