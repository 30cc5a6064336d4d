"""Parity of the port's device generators (``formats/device_gen.py``) and
``poh_synth_device`` with the JAX package, on the CPU.

The stencil has no random values: its pack must equal the reference's bit
for bit in every value type (exact equality, tolerance 0), and the port's
own host plan for every ``ny``.  At ``ny = 1`` the reference's pack drops
the ±1 couplings (its row-end mask reads every node as a grid-row end);
the port's pack equals the host plan there too, and a test pins the
reference's difference.  The FEM, band and POH generators draw their
values from a ``torch.Generator``, which cannot equal ``jax.random``'s
draws: everything else (offsets, ``ts``, shapes, masks, the deterministic
POH arrays) must equal the reference's exactly, and the products on the
same values must agree: ≤ 1e-12 normwise in f64 for the DIA and BDIA
SpMV, ≤ 1e-5 in f32 for the POH SpMV against the reference's kernel in
interpret mode (about a second a call).
"""

import dataclasses

import jax  # noqa: F401  (kept on the CPU with x64 by conftest)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cask_tpu.formats import device_gen as jgen
from cask_tpu.ops.pallas import poh_kernels as jpoh
from cask_tpu_torch.formats import device_gen as tgen
from cask_tpu_torch.formats.generate import banded, fem_blocks, stencil_2d
from cask_tpu_torch.ops.bdia import bdia_plan
from cask_tpu_torch.ops.dia import dia_plan
from cask_tpu_torch.ops.poh import PohMatrix, poh_synth_device
from cask_tpu_torch.utils.debug import check_poh

CPU = torch.device("cpu")
TYPES = {"f32": (jnp.float32, torch.float32), "f64": (jnp.float64, torch.float64),
         "bf16": (jnp.bfloat16, torch.bfloat16), "f16": (jnp.float16, torch.float16)}
GRIDS = [(5, None), (16, 3), (33, 7), (16, 1), (5, 1), (33, None)]
TOL_F64 = 1e-12
TOL_POH_F32 = 1e-5


def _grid_id(g):
    return f"{g[0]}x{g[1] or g[0]}"


def _np(a, jdt=None):
    """A JAX array as numpy (bf16 through f32, exactly)."""
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


def _relerr(y, ref) -> float:
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(y - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("grid", GRIDS, ids=_grid_id)
@pytest.mark.parametrize("dt", list(TYPES))
def test_stencil_pack_is_bit_equal(grid, dt):
    nx, ny = grid
    jdt, tdt = TYPES[dt]
    t = tgen.stencil2d_dia_device(nx, ny, dtype=tdt, device=CPU)
    j = jgen.stencil2d_dia_device(nx, ny, dtype=jdt)
    host = dia_plan(stencil_2d(nx, ny, dtype=np.float32), device=CPU).astype(tdt)
    assert t.vals.dtype == tdt and t.vals_t is None
    # the port's own host plan, every ny: exact
    assert t.offsets == host.offsets and t.shape == host.shape
    assert torch.equal(t.vals, host.vals)
    assert t.rem_data.numel() == host.rem_data.numel() == 0
    assert t.offsets == j.offsets and t.shape == j.shape
    assert tuple(t.vals.shape) == tuple(j.vals.shape)
    same = np.array_equal(t.vals.float().numpy(), _np(j.vals))
    if (ny or nx) != 1:
        assert same  # the reference's pack, bit for bit
    else:
        # pinned reference fault: at ny = 1 its ±1 diagonals are all zero
        assert not same
        off1 = j.offsets.index(1)
        assert not np.any(_np(j.vals)[off1]) and torch.count_nonzero(t.vals[off1]) == nx - 1


@pytest.mark.parametrize("grid", GRIDS, ids=_grid_id)
def test_fem_structure_and_product(grid):
    nx, ny = grid
    t = tgen.fem_bdia_device(nx, ny, dof=4, dtype=torch.float64, seed=3, device=CPU)
    j = jgen.fem_bdia_device(nx, ny, dof=4, dtype=jnp.float64, seed=3)
    host = bdia_plan(fem_blocks(nx, ny, dof=4), (4, 4), device=CPU)
    for p in (j, host):
        assert (t.block_offsets, t.ts, t.shape, t.blocksize) == (
            p.block_offsets, p.ts, p.shape, p.blocksize)
        assert tuple(t.vals.shape) == tuple(p.vals.shape)
    # the pattern of the host plan, every ny; the reference's where ny != 1
    assert torch.equal(t.vals != 0, host.vals != 0)
    assert np.array_equal(t.vals.numpy() != 0, np.asarray(j.vals) != 0) == ((ny or nx) != 1)
    # the +4·dof shift on the d = 0, c = r slots of every real block row
    d0 = t.block_offsets.index(0)
    nbr = nx * (ny or nx)
    diag = torch.stack([t.vals[r, :, d0 * 4 + r].reshape(-1)[:nbr] for r in range(4)])
    assert (diag > 4.0 * 4 - 8.0).all()  # a normal draw beyond 8σ would be 1e-15 likely
    # the same values through both packages' plain products
    x = np.random.default_rng(0).standard_normal(t.shape[1])
    y = t._spmv_reference(torch.from_numpy(x))
    jj = dataclasses.replace(j, vals=jnp.asarray(t.vals.numpy()))
    assert _relerr(y.numpy(), jj._spmv_xla(jnp.asarray(x))) <= TOL_F64
    assert _relerr(y.numpy(), host.spmv(torch.from_numpy(x)).numpy()) > 0  # other values


@pytest.mark.parametrize("dt", ["bf16", "f16"])
def test_fem_half_values_keep_the_pattern(dt):
    jdt, tdt = TYPES[dt]
    t = tgen.fem_bdia_device(16, 3, dof=2, dtype=tdt, device=CPU)
    j = jgen.fem_bdia_device(16, 3, dof=2, dtype=jdt)
    assert t.vals.dtype == tdt and tuple(t.vals.shape) == tuple(j.vals.shape)
    assert np.array_equal(t.vals.float().numpy() != 0, _np(j.vals) != 0)


@pytest.mark.parametrize("n", [1000, 8193])
def test_band_structure_and_product(n):
    t = tgen.banded_dia_device(n, 4, dtype=torch.float64, seed=2, device=CPU)
    j = jgen.banded_dia_device(n, 4, dtype=jnp.float64, seed=2)
    host = dia_plan(banded(n, 4), device=CPU)
    for p in (j, host):
        assert (t.offsets, t.shape, tuple(t.vals.shape)) == (p.offsets, p.shape,
                                                            tuple(p.vals.shape))
    assert torch.equal(t.vals != 0, host.vals != 0)
    assert np.array_equal(t.vals.numpy() != 0, np.asarray(j.vals) != 0)
    x = np.random.default_rng(1).standard_normal(n)
    jj = dataclasses.replace(j, vals=jnp.asarray(t.vals.numpy()))
    assert _relerr(t._spmv_reference(torch.from_numpy(x)).numpy(),
                   jj._spmv_xla(jnp.asarray(x))) <= TOL_F64


def test_seed_and_device_are_the_generators():
    a = tgen.banded_dia_device(1000, 2, seed=5, device=CPU)
    assert torch.equal(a.vals, tgen.banded_dia_device(1000, 2, seed=5, device=CPU).vals)
    assert not torch.equal(a.vals, tgen.banded_dia_device(1000, 2, seed=6, device=CPU).vals)
    assert a.vals.device == CPU


SYNTH = dict(n_panels=2, tiles_per_panel=3, row_panel=1024, col_window=512, tile_slots=1024)


@pytest.fixture(scope="module")
def synth():
    return poh_synth_device(**SYNTH, seed=4, device=CPU), jpoh.poh_synth_device(**SYNTH, seed=4)


def test_synth_deterministic_arrays_equal_the_reference(synth):
    t, j = synth
    assert isinstance(t, PohMatrix)
    for f in ("panel", "first", "last"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), f)
    for f in ("vals", "cloc", "rloc", "wlo", "whi"):
        assert tuple(getattr(t, f).shape) == tuple(getattr(j, f).shape), f
        assert getattr(t, f).numpy().dtype == np.asarray(getattr(j, f)).dtype, f
    assert (t.shape, t.row_panel, t.col_window, t.slot_rows, t.nseg) == (
        j.shape, j.row_panel, j.col_window, j.slot_rows, j.nseg)
    nseg = t.shape[0] // t.col_window
    torch.testing.assert_close(t.whi, torch.clamp(t.wlo + 1, max=nseg - 1), rtol=0, atol=0)


def test_synth_random_arrays_lie_in_their_ranges(synth):
    t, _ = synth
    C, R = t.col_window, t.row_panel
    nseg = t.shape[0] // C
    assert int(t.cloc.min()) >= 0 and int(t.cloc.max()) < 2 * C
    assert int(t.rloc.min()) >= 0 and int(t.rloc.max()) < R
    assert int(t.wlo.min()) >= 0 and int(t.wlo.max()) < max(nseg - 1, 1)
    assert bool((t.vals != 0).all())  # every slot live
    check_poh(t)


def test_synth_twin_equals_the_reference_kernel_on_the_same_arrays(synth):
    t, j = synth
    jj = dataclasses.replace(
        j, vals=jnp.asarray(t.vals.numpy()), cloc=jnp.asarray(t.cloc.numpy()),
        rloc=jnp.asarray(t.rloc.numpy()), rloc_t=jnp.asarray(t.rloc.numpy().transpose(0, 2, 1)),
        wlo=jnp.asarray(t.wlo.numpy()), whi=jnp.asarray(t.whi.numpy()))
    x = np.random.default_rng(2).standard_normal(t.shape[1]).astype(np.float32)
    y = t.spmv(torch.from_numpy(x)).numpy()
    assert _relerr(y, jpoh.poh_spmv_pallas(jj, jnp.asarray(x))) <= TOL_POH_F32


def test_synth_chained_products_stay_finite():
    d = poh_synth_device(n_panels=2, tiles_per_panel=4, row_panel=1024, col_window=512,
                         tile_slots=1024, device=CPU)
    x = torch.ones(d.shape[1])
    for _ in range(30):
        x = d.spmv(x)
    assert x.shape == (d.shape[0],) and bool(torch.isfinite(x).all())


@pytest.mark.parametrize("make", [
    lambda: tgen.stencil2d_dia_device(8),
    lambda: tgen.fem_bdia_device(8),
    lambda: tgen.banded_dia_device(100, 2),
    lambda: poh_synth_device(n_panels=1, tiles_per_panel=1),
], ids=["stencil", "fem", "band", "poh_synth"])
def test_the_card_without_one_raises(make, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()


def test_an_exact_zero_draw_stays_in_the_pattern(monkeypatch):
    """The CUDA generator's Box–Muller returns an exact 0 about once in 2^24
    draws; on a structural entry it would drop out of the pack's pattern."""
    real = torch.randn

    def with_zeros(*args, **kw):
        v = real(*args, **kw)
        v.view(-1)[::7] = 0.0
        return v

    monkeypatch.setattr(torch, "randn", with_zeros)
    t = tgen.fem_bdia_device(16, 3, dof=4, dtype=torch.float64, device=CPU)
    host = bdia_plan(fem_blocks(16, 3, dof=4), (4, 4), device=CPU)
    assert torch.equal(t.vals != 0, host.vals != 0)
    b = tgen.banded_dia_device(1000, 4, device=CPU)
    assert torch.equal(b.vals != 0, dia_plan(banded(1000, 4), device=CPU).vals != 0)
    p = poh_synth_device(**SYNTH, device=CPU)
    assert bool((p.vals != 0).all())
