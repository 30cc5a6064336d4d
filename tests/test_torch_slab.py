"""Parity of the port's slab plan and slab SpMM twin with the JAX package, on
the CPU (the kernel on the card: tests/test_torch_gpu.py).

The reference's slab kernels (B5 ``bdia_spmm_slab_padded``, B6
``_slab_ring_call`` through ``bdia_spmm_pallas_slab`` and
``bdia_spmm_slab_ring_padded``) run in interpret mode, as
tests/test_bdia_slab.py runs them.  The packed slabs must equal the
reference's exactly.  Tolerances: f64 ≤ 1e-12 normwise, f32 ≤ 1e-5; the
3xTF32 products of the kernel's f32 route, emulated here, ≤ 2e-6.
"""

import dataclasses

import jax  # noqa: F401  (kept on the CPU with x64 by conftest)
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import cask_tpu.formats.convert as jconv
import cask_tpu.ops.bdia as jbdia
import cask_tpu.ops.pallas.bdia_slab as jslab
import cask_tpu_torch.formats.convert as tconv
import cask_tpu_torch.ops.bdia as tbdia
import cask_tpu_torch.ops.bdia_slab as tslab
from cask_tpu_torch import interop
from cask_tpu_torch.formats.generate import fem_blocks
from cask_tpu_torch.ops.kernels.bdia_slab_kernels import (bdia_spmm_slab,
                                                          bdia_spmm_slab_padded,
                                                          bdia_spmm_slab_reference)

TOL = {np.float32: 1e-5, np.float64: 1e-12}


def _relerr(y, ref):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return np.linalg.norm(y - ref) / np.linalg.norm(ref)


def _banded_blocks(nb, b, offsets, seed):
    """A scipy matrix of random b×b blocks on the given block offsets."""
    rng = np.random.default_rng(seed)
    s = sp.lil_matrix((nb * b, nb * b))
    for i in range(nb):
        for d in offsets:
            if 0 <= i + d < nb:
                s[i * b : (i + 1) * b, (i + d) * b : (i + d + 1) * b] = rng.standard_normal((b, b))
    return s.tocsr()


CASES = {  # name -> (scipy matrix, blocksize, g)
    "fem4": lambda: (tconv.to_scipy(fem_blocks(16, dof=4)), 4, 8),
    "fem2": lambda: (tconv.to_scipy(fem_blocks(12, dof=2, seed=3)), 2, 4),
    "no_far": lambda: (_banded_blocks(96, 4, (-1, 0, 1), 31), 4, 8),
    "far18_not_div_g": lambda: (_banded_blocks(128, 4, (-18, 0, 18), 33), 4, 8),
    "one_asym_far": lambda: (_banded_blocks(128, 4, (0, 1, 16), 32), 4, 8),
    "eight_far": lambda: (_banded_blocks(160, 4, (-70, -49, -33, -17, -1, 0, 1, 17, 33, 49, 70),
                                         34), 4, 16),
}


def _plans(name, dtype=np.float64):
    """(reference BDIA plan, port BDIA plan on the CPU, scipy, g)."""
    s, b, g = CASES[name]()
    s = s.astype(dtype)
    jp = jbdia.bdia_plan(jconv.csr_to_bsr(jconv.from_scipy(s), (b, b)), (b, b))
    tp = tbdia.bdia_plan(tconv.csr_to_bsr(tconv.from_scipy(s), (b, b)), (b, b), device="cpu")
    return jp, tp, s, g


@pytest.mark.parametrize("dof", [2, 4])
@pytest.mark.parametrize("g", [4, 8, 12, 16])
def test_slab_ok_equals_the_reference(dof, g):
    s = tconv.to_scipy(fem_blocks(16, dof=dof))
    jp = jbdia.bdia_plan(jconv.csr_to_bsr(jconv.from_scipy(s), (dof, dof)), (dof, dof))
    tp = tbdia.bdia_plan(tconv.csr_to_bsr(tconv.from_scipy(s), (dof, dof)), (dof, dof),
                         device="cpu")
    assert tslab.bdia_slab_ok(tp, g) == jslab.bdia_slab_ok(jp, g)


@pytest.mark.parametrize("name", ["fem4", "fem2"])
@pytest.mark.parametrize("g", [4, 8, 16])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_slab_plan_equals_the_reference(name, g, dtype):
    jp, tp, _, _ = _plans(name, dtype)
    if not jslab.bdia_slab_ok(jp, g):
        with pytest.raises(ValueError, match="slab-eligible"):
            tslab.bdia_slab_plan(tp, g)
        return
    js, ts = jslab.bdia_slab_plan(jp, g), tslab.bdia_slab_plan(tp, g)
    jv, tv = np.asarray(js.slabs), ts.slabs.numpy()
    assert jv.dtype == tv.dtype and np.array_equal(jv, tv)
    assert (ts.g, ts.blocksize, ts.shape, ts.far_offsets, ts.nb_pad) == \
        (js.g, js.blocksize, js.shape, js.far_offsets, js.nb_pad)
    assert (ts.width, ts.gg_align, ts.pad_tiles, ts.ntiles) == \
        (js.width, js.gg_align, js.pad_tiles, js.ntiles)
    x = np.zeros((tp.shape[1], 3), dtype)
    assert tuple(ts.to_padded(torch.from_numpy(x)).shape) == js.to_padded(jnp.asarray(x)).shape


def _reference_padded(js, x):
    """The reference's padded-layout product: B5 (the BlockSpec kernel, at
    gg = 1, which interprets fastest) where every far offset is a multiple
    of g, else B6's padded entry (the X ring takes any offset)."""
    xp = js.to_padded(jnp.asarray(x))
    if all(d % js.g == 0 for d in js.far_offsets):
        return np.asarray(jslab.bdia_spmm_slab_padded(js, xp, gg=1))
    return np.asarray(jslab.bdia_spmm_slab_ring_padded(js, xp))


# (case, k): far offsets not divisible by g, none, one asymmetric, eight
# (W = 584 at g = 16), dof 2; k = None is a 1-D x
TWIN_CASES = [("fem4", 130), ("fem2", 65), ("no_far", 8), ("far18_not_div_g", 65),
              ("one_asym_far", None), ("eight_far", 1)]


@pytest.mark.parametrize("name,k", TWIN_CASES)
def test_twin_matches_the_reference_kernels(name, k):
    jp, tp, s, g = _plans(name)
    js, ts = jslab.bdia_slab_plan(jp, g), tslab.bdia_slab_plan(tp, g)
    shape = (s.shape[1],) if k is None else (s.shape[1], k)
    x = np.random.default_rng(5).standard_normal(shape)
    xt = torch.from_numpy(x)
    # natural frame: bdia_spmm_pallas_slab (the X-ring kernel, B6)
    y = bdia_spmm_slab(ts, xt)
    y_ref = np.asarray(jslab.bdia_spmm_pallas_slab(js, jnp.asarray(x)))
    assert y.shape == y_ref.shape
    assert _relerr(y, y_ref) <= 1e-12 and _relerr(y, s @ x) <= 1e-12
    # padded chain layout: the whole frame, pad rows zero
    yp = bdia_spmm_slab_padded(ts, ts.to_padded(xt))
    yp_ref = _reference_padded(js, x)
    assert yp.shape == yp_ref.shape
    assert _relerr(yp, yp_ref) <= 1e-12
    p = ts.pad_tiles * ts.gb_r
    assert not yp[:p].any() and not yp[p + ts.ntiles * ts.gb_r :].any()


def test_padded_layout_chains():
    # square blocks: Y has X's layout, so a second product takes the first's
    _, tp, s, g = _plans("fem4")
    ts = tslab.bdia_slab_plan(tp, g)
    x = np.random.default_rng(6).standard_normal((s.shape[1], 8))
    y = bdia_spmm_slab_padded(ts, ts.to_padded(torch.from_numpy(x)))
    assert _relerr(ts.from_padded(y, 8), s @ x) <= 1e-12
    y2 = bdia_spmm_slab_padded(ts, y)
    assert _relerr(ts.from_padded(y2, 8), s @ (s @ x)) <= 1e-12


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_twin_types(dtype):
    jp, tp, s, g = _plans("fem4", dtype)
    ts = tslab.bdia_slab_plan(tp, g)
    x = np.random.default_rng(7).standard_normal((s.shape[1], 16)).astype(dtype)
    y = bdia_spmm_slab(ts, torch.from_numpy(x))
    assert y.dtype == torch.from_numpy(x).dtype
    assert _relerr(y, s.astype(np.float64) @ x.astype(np.float64)) <= TOL[dtype]
    y64 = bdia_spmm_slab(ts, torch.from_numpy(x), out_dtype=np.float64)
    assert y64.dtype == torch.float64
    # bf16 slabs promote to an f32 result, as the reference's do
    tb = tslab.bdia_slab_plan(tp, g, dtype=torch.bfloat16)
    yb = bdia_spmm_slab(tb, torch.from_numpy(x.astype(np.float32)))
    assert yb.dtype == torch.float32
    assert _relerr(yb, s @ x) < 0.05


def test_remainder_is_carried():
    # ROADMAP Queue C 1: the reference's slab plan drops the BDIA plan's COO
    # remainder; the port's carries it and its product adds it
    s = _banded_blocks(128, 4, (-16, -1, 0, 1, 16), 40).tolil()
    rng = np.random.default_rng(41)
    for _ in range(6):
        bi, bj = int(rng.integers(0, 128)), int(rng.integers(0, 128))
        s[bi * 4 : bi * 4 + 4, bj * 4 : bj * 4 + 4] = rng.standard_normal((4, 4))
    s = s.tocsr()
    jp = jbdia.bdia_plan(jconv.csr_to_bsr(jconv.from_scipy(s), (4, 4)), (4, 4))
    tp = tbdia.bdia_plan(tconv.csr_to_bsr(tconv.from_scipy(s), (4, 4)), (4, 4), device="cpu")
    assert tp.rem_data.shape[0] > 0
    ts = tslab.bdia_slab_plan(tp, 8)
    x = rng.standard_normal((s.shape[1], 8))
    y = ts.spmm(torch.from_numpy(x))
    assert _relerr(y, s @ x) <= 1e-12
    rem = sp.csr_matrix((np.asarray(jp.rem_data), (np.asarray(jp.rem_row),
                                                    np.asarray(jp.rem_col))), shape=s.shape)
    js = jslab.bdia_slab_plan(jp, 8)
    y_ref = np.asarray(js.from_padded(jnp.asarray(_reference_padded(js, x)), 8))
    assert _relerr(y_ref, s @ x) > 1e-3  # the reference misses the remainder ...
    assert _relerr(y_ref + rem @ x, s @ x) <= 1e-12  # ... by exactly its product
    # the twin alone is the slab part, as the reference's kernel
    assert _relerr(bdia_spmm_slab_reference(ts, torch.from_numpy(x)), y_ref) <= 1e-12


def test_slabs_from_arrays():
    jp, tp, s, g = _plans("one_asym_far")
    js = jslab.bdia_slab_plan(jp, g)
    ts = interop.slabs_from_arrays(np.asarray(js.slabs), g=js.g, blocksize=js.blocksize,
                                   shape=js.shape, far_offsets=js.far_offsets,
                                   nb_pad=js.nb_pad, device="cpu")
    x = np.random.default_rng(8).standard_normal((s.shape[1], 8))
    y_ref = np.asarray(js.from_padded(jnp.asarray(_reference_padded(js, x)), 8))
    assert _relerr(ts.spmm(torch.from_numpy(x)), y_ref) <= 1e-12
    with pytest.raises(ValueError):
        interop.slabs_from_arrays(np.asarray(js.slabs)[1:], g=js.g, blocksize=js.blocksize,
                                  shape=js.shape, far_offsets=js.far_offsets,
                                  nb_pad=js.nb_pad, device="cpu")


def test_auto_plan_follows_the_reference_gates(monkeypatch):
    # g = 16 first; blocks of 3 fail the slab gate at every g; the byte cap
    _, tp, _, _ = _plans("fem4")
    assert tslab.slab_auto_plan(tp).g == 16
    p3 = tbdia.bdia_plan(fem_blocks(9, dof=3, return_bsr=True), device="cpu")
    assert tslab.slab_auto_plan(p3) is None
    w16 = 2 * 4 + 16 * 4 * (1 + 2)  # two far offsets
    monkeypatch.setattr(tslab, "SLAB_MAX_BYTES", tp.nb_pad * 4 * w16 * 8 - 1)
    assert tslab.slab_auto_plan(tp).g == 8  # g = 16 is just over the cap


def test_padded_entry_checks():
    jp, tp, s, g = _plans("fem4")
    ts = tslab.bdia_slab_plan(tp, g)
    with pytest.raises(ValueError, match="rows"):
        bdia_spmm_slab_padded(ts, torch.zeros((s.shape[1], 8), dtype=torch.float64))
    with pytest.raises(ValueError):
        bdia_spmm_slab(ts, torch.zeros((s.shape[1] + 1, 8), dtype=torch.float64))
    rect = tbdia.bdia_plan(tconv.csr_to_bsr(tconv.from_scipy(s), (4, 2)), device="cpu")
    tr = tslab.bdia_slab_plan(rect, 8)
    with pytest.raises(ValueError, match="square"):
        bdia_spmm_slab_padded(tr, tr.to_padded(torch.zeros((s.shape[1], 8),
                                                           dtype=torch.float64)))
    # the natural frame takes rectangular blocks
    x = np.random.default_rng(9).standard_normal((s.shape[1], 8))
    assert _relerr(tr.spmm(torch.from_numpy(x)), s @ x) <= 1e-12


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 explicit mantissa bits), to nearest with ties
    away from zero: the kernel's hi part (as cvt.rna.tf32.f32)."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_cut(x: torch.Tensor) -> torch.Tensor:
    """f32 cut toward zero to TF32: the kernel's lo part."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _low_bits(a: np.ndarray) -> np.ndarray:
    """``a`` (f32) with the 12 mantissa bits below TF32's set on every
    nonzero, so that one TF32 pass rounds each value by about 2^-11."""
    bits = a.view(np.int32).copy()
    bits[a != 0] |= 0x0FFF
    return bits.view(np.float32)


@pytest.mark.parametrize("name,k", [("fem4", 128), ("fem2", 65), ("far18_not_div_g", 130),
                                    ("eight_far", 8)])
def test_three_tf32_passes_are_f32_class_and_one_is_not(name, k):
    # the f32 slab kernel's arithmetic (csrc/bdia_slab_spmm.cu): each operand
    # split into TF32 hi (rounded) and lo (the rest, cut), D = lo·hi + hi·lo +
    # hi·hi with f32 sums, here as three f32 bmm's of the plain twin
    s, b, g = CASES[name]()
    s = s.astype(np.float32)
    s.data = _low_bits(s.data)
    tp = tbdia.bdia_plan(tconv.csr_to_bsr(tconv.from_scipy(s), (b, b)), (b, b), device="cpu")
    ts = tslab.bdia_slab_plan(tp, g)
    x = torch.from_numpy(_low_bits(np.random.default_rng(10).standard_normal((s.shape[1], k))
                                   .astype(np.float32)))

    def product(slabs, xs):
        return bdia_spmm_slab_reference(dataclasses.replace(ts, slabs=slabs), xs)

    a_hi, x_hi = _tf32(ts.slabs), _tf32(x)
    a_lo, x_lo = _tf32_cut(ts.slabs - a_hi), _tf32_cut(x - x_hi)
    for v, hi, lo in ((ts.slabs, a_hi, a_lo), (x, x_hi, x_lo)):
        assert ((hi + lo).double() - v.double()).abs().max() <= 2.0 ** -21 * v.abs().max()
    three = product(a_lo, x_hi) + product(a_hi, x_lo) + product(a_hi, x_hi)
    exact = product(ts.slabs.double(), x.double())
    assert three.dtype == torch.float32
    assert _relerr(exact, tconv.to_scipy(tconv.from_scipy(s)).astype(np.float64)
                   @ x.double().numpy()) <= 1e-12
    assert _relerr(three, exact) <= 2e-6
    assert _relerr(product(a_hi, x_hi), exact) > 1e-5  # one TF32 pass is not f32-class
