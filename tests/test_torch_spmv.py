"""Parity of the port's SpMV formulations and ``spmv`` dispatch with the JAX
package, on the CPU (the auto route's CUDA branch: tests/test_torch_gpu.py).

The gather formulations are held against the reference's XLA ones in
both directions: f64 ≤ 1e-12 normwise, f32 ≤ 1e-5 (sums in another order).
"""

import dataclasses
import gc
import importlib
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (kept on the CPU with x64 by conftest)
import numpy as np
import pytest
import torch

import cask_tpu.formats.convert as jconv
import cask_tpu.formats.generate as jgen
import cask_tpu.ops.bdia as jbdia
import cask_tpu_torch.formats.convert as tconv
import cask_tpu_torch.formats.generate as tgen
from cask_tpu.ops.spmv import _bdia_auto_plan
from cask_tpu.ops.spmv import spmv as jax_spmv
from cask_tpu.ops.spmv import transposed as jax_transposed
from cask_tpu_torch import interop
from cask_tpu_torch.formats.matrix import torch_dtype
from cask_tpu_torch.ops.bdia import BdiaMatrix, bdia_plan
from cask_tpu_torch.ops.kernels.bdia_kernels import bdia_spmv
from cask_tpu_torch.ops.spmv import PlanCache, _accum_dtype, spmv, transposed

REPO = Path(__file__).resolve().parents[1]
# the module itself: ``cask_tpu_torch.ops.spmv`` as an attribute is the function
spmv_mod = importlib.import_module("cask_tpu_torch.ops.spmv")
TOL = {np.float32: 1e-5, np.float64: 1e-12}


def _relerr(y, ref):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(y - ref) / np.linalg.norm(ref)


def _pair(fmt, dtype):
    """The same host matrix in both packages, in format ``fmt``."""
    j = jgen.fem_blocks(7, dof=4, dtype=dtype)
    t = tgen.fem_blocks(7, dof=4, dtype=dtype)
    if fmt == "csr":
        return j, t
    if fmt == "coo":
        return jconv.csr_to_coo(j), tconv.csr_to_coo(t)
    if fmt == "bsr":
        return jconv.csr_to_bsr(j, (4, 4)), tconv.csr_to_bsr(t, (4, 4))
    if fmt == "bsr_rect":
        return jconv.csr_to_bsr(j, (4, 2)), tconv.csr_to_bsr(t, (4, 2))
    if fmt == "bsr_ragged":
        return (jconv.csr_to_bsr(jgen.stencil_2d(11, dtype=dtype), (4, 4)),
                tconv.csr_to_bsr(tgen.stencil_2d(11, dtype=dtype), (4, 4)))
    raise KeyError(fmt)


@pytest.mark.parametrize("fmt", ["csr", "coo", "bsr", "bsr_rect", "bsr_ragged"])
@pytest.mark.parametrize("transpose", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_gather_formulation_matches_xla(fmt, transpose, dtype):
    j, t = _pair(fmt, dtype)
    n = j.shape[0] if transpose else j.shape[1]
    x = np.random.default_rng(0).standard_normal(n).astype(dtype)
    y_ref = np.asarray(jax_spmv(j, x, transpose=transpose, method="xla"))
    y = spmv(t, torch.from_numpy(x), transpose=transpose, method="xla")
    assert y.shape == y_ref.shape and y.dtype == torch_dtype(y_ref.dtype)
    assert _relerr(y, y_ref) <= TOL[dtype]


@pytest.mark.parametrize("fmt", ["csr", "coo", "bsr"])
def test_gather_formulation_on_device_arrays(fmt):
    # a matrix whose arrays are tensors computes the same y as a host one
    _, t = _pair(fmt, np.float64)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(t.shape[1]))
    assert torch.equal(spmv(t.to("cpu"), x), spmv(t, x))


def test_accum_dtype_policy():
    assert _accum_dtype(np.float32, None) == torch.float32
    assert _accum_dtype(torch.bfloat16, None) == torch.float32
    assert _accum_dtype(np.float16, None) == torch.float32
    assert _accum_dtype(np.float32, np.float64) == torch.float64


def test_low_precision_values_accumulate_in_f32():
    # bf16 values and x: products summed in f32, y returned in x's type
    # (the reference's policy); bf16 keeps about 3 significant digits
    import jax.numpy as jnp

    j, t = _pair("csr", np.float64)
    x = np.random.default_rng(2).standard_normal(j.shape[1])
    y_ref = jax_spmv(j.astype(jnp.bfloat16), jnp.asarray(x, jnp.bfloat16))
    y = spmv(t.to("cpu").astype(torch.bfloat16), torch.from_numpy(x).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16 and str(y_ref.dtype) == "bfloat16"
    assert _relerr(y.float(), jconv.to_scipy(j) @ x) <= 2e-2
    assert _relerr(y.float(), np.asarray(y_ref, np.float32)) <= 2e-2


class TestDispatch:
    def test_cpu_bsr_takes_the_gather_route(self, monkeypatch):
        j, t = _pair("bsr", np.float64)
        plans = PlanCache()
        monkeypatch.setattr(spmv_mod, "default_plan_cache", plans)
        x = np.random.default_rng(3).standard_normal(j.shape[1])
        before = bdia_spmv.launches
        y = spmv(t.to("cpu"), torch.from_numpy(x))
        assert len(plans._plans) == 0  # the reference's route off its accelerator
        assert bdia_spmv.launches == before
        assert _relerr(y, np.asarray(jax_spmv(j, x))) <= TOL[np.float64]

    def test_plan_cache_builds_once_and_matches_the_reference_plan(self):
        j, t = _pair("bsr", np.float64)
        t = t.to("cpu")  # a host matrix would plan onto the CUDA device
        plans = PlanCache()
        p = plans.get(t)
        assert isinstance(p, BdiaMatrix) and plans.get(t) is p and len(plans._plans) == 1
        jp = jbdia.bdia_plan(j, j.blocksize)
        assert np.array_equal(p.vals.numpy(), np.asarray(jp.vals))
        # the reference's own memo admits the same plan
        assert _bdia_auto_plan(j) is not None
        del t, p
        gc.collect()
        assert len(plans._plans) == 0  # held weakly: the entry goes with the matrix

    def test_plan_cache_rebuilds_after_an_in_place_change(self):
        j, t = _pair("bsr", np.float64)
        t = t.to("cpu")
        plans = PlanCache()
        p = plans.get(t)
        assert plans.get(t) is p
        t.data.mul_(2.0)  # the plan holds a copy of the old values
        p2 = plans.get(t)
        assert p2 is not p and plans.get(t) is p2
        assert torch.equal(p2.vals, 2.0 * p.vals)
        jp = jbdia.bdia_plan(dataclasses.replace(j, data=j.data * 2.0))
        assert np.array_equal(p2.vals.numpy(), np.asarray(jp.vals))

    def test_plan_cache_gate_rejects_a_large_remainder(self):
        # a block diagonal kept at the density floor plus many sparse ones
        # that spill: > 10 % of the stored entries in the remainder
        rng = np.random.default_rng(4)
        n = 2048
        rows = np.concatenate([np.arange(n), rng.integers(0, n, 4000)])
        cols = np.concatenate([np.arange(n), rng.integers(0, n, 4000)])
        s = tconv.coo_to_csr(tconv.coo_from_arrays(rng.standard_normal(rows.size), rows, cols,
                                                   (n, n)))
        b = tconv.csr_to_bsr(s, (2, 2)).to("cpu")
        plans = PlanCache()
        assert plans.get(b) is None and len(plans._plans) == 1
        p = bdia_plan(b)
        assert p.rem_data.shape[0] > 0.1 * b.nnz

    def test_method_bdia_matches_the_reference(self):
        j, t = _pair("bsr_rect", np.float64)
        for transpose in (False, True):
            n = j.shape[0] if transpose else j.shape[1]
            x = np.random.default_rng(5).standard_normal(n)
            y_ref = np.asarray(jax_spmv(j, x, transpose=transpose, method="bdia"))
            y = spmv(t, torch.from_numpy(x), transpose=transpose, method="bdia")
            assert _relerr(y, y_ref) <= TOL[np.float64]

    def test_bdia_plan_operand(self):
        j, t = _pair("bsr", np.float64)
        jp, tp = jbdia.bdia_plan(j), bdia_plan(t, device="cpu")
        for transpose in (False, True):
            x = np.random.default_rng(6).standard_normal(j.shape[0])
            y_ref = np.asarray(jax_spmv(jp, x, transpose=transpose))
            assert _relerr(spmv(tp, torch.from_numpy(x), transpose=transpose), y_ref) \
                <= TOL[np.float64]

    def test_transposed(self):
        for fmt in ("csr", "coo", "bsr_rect"):
            j, t = _pair(fmt, np.float64)
            jt, tt = jax_transposed(j), transposed(t)
            assert tt.shape == jt.shape
            assert np.array_equal(tt.todense(), jt.todense())
        jp, tp = jbdia.bdia_plan(_pair("bsr", np.float64)[0]), bdia_plan(_pair("bsr", np.float64)[1], device="cpu")
        assert np.array_equal(transposed(tp).vals.numpy(), np.asarray(jax_transposed(jp).vals))
        with pytest.raises(TypeError):
            transposed(np.eye(3))

    def test_rejects_bad_arguments(self):
        _, t = _pair("csr", np.float64)
        with pytest.raises(ValueError):
            spmv(t, torch.zeros(t.shape[1], 2, dtype=torch.float64))
        with pytest.raises(ValueError):
            spmv(t, torch.zeros(t.shape[1] + 1, dtype=torch.float64))
        with pytest.raises(ValueError):
            spmv(t, torch.zeros(t.shape[1], dtype=torch.float64), method="ell")
        with pytest.raises(TypeError):
            spmv(np.eye(3), torch.zeros(3))

    @pytest.mark.parametrize("op", ["spmv", "spmm"])
    def test_host_operand_needs_a_card(self, op, monkeypatch):
        # a numpy operand with a matrix of host arrays goes to the CUDA
        # device, never silently to the CPU: without a card it raises
        from cask_tpu_torch.ops.spmm import spmm

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        a = tgen.stencil_2d(8)
        with pytest.raises(RuntimeError, match="CUDA"):
            spmv(a, np.ones(64)) if op == "spmv" else spmm(a, np.ones((64, 2)))
        # a matrix whose tensors lie on the CPU takes a host operand there
        y = spmv(a.to("cpu"), np.ones(64)) if op == "spmv" else spmm(a.to("cpu"), np.ones((64, 2)))
        assert y.device.type == "cpu"

    def test_interop_bsr_through_the_public_entry(self):
        j, _ = _pair("bsr", np.float64)
        t = interop.bsr_from_arrays(np.asarray(j.data), np.asarray(j.indices),
                                    np.asarray(j.indptr), j.shape, j.blocksize, device="cpu")
        x = np.random.default_rng(7).standard_normal(j.shape[1])
        assert _relerr(spmv(t, torch.from_numpy(x)), np.asarray(jax_spmv(j, x))) \
            <= TOL[np.float64]


def test_chip_smoke_without_a_gpu_exits_nonzero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
