"""Matrix generation on the device: the packed plan built by torch ops where
it will be used, with no host-to-device copy of its values.

The PyTorch counterpart of :mod:`cask_tpu.formats.device_gen`.  A stencil's
diagonals are formulaic, so its packed DIA values can be computed on the
card directly; the FEM and band generators draw their values there from a
seeded ``torch.Generator``.  Each returns the port's
:class:`~cask_tpu_torch.ops.dia.DiaMatrix` or
:class:`~cask_tpu_torch.ops.bdia.BdiaMatrix` in the reference's layout, on
the CUDA device unless ``device`` asks for another (it raises without
CUDA, never falling back to the CPU).

One deliberate difference from the reference: at ``ny = 1`` the ±1
diagonals are the grid's ±ny couplings, which the reference's row-end mask
drops.  Here the pack equals the host plan of the same grid for every
``ny``, as both docstrings promise.
"""

from __future__ import annotations

from typing import Optional

import torch

from cask_tpu_torch.formats.matrix import torch_dtype
from cask_tpu_torch.ops.bdia import _LANE, BdiaMatrix, _pick_ts
from cask_tpu_torch.ops.dia import _ROW_TILE, DiaMatrix, _round_up
from cask_tpu_torch.utils.platform import plan_device


def _generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def _normal(shape, gen: torch.Generator, device: torch.device, dtype: torch.dtype):
    """Standard normal draws, none exactly 0: the CUDA generator's Box–Muller
    gives an exact 0 about once in 2^24 draws (its uniform reaches 1), and a
    0 on a structural entry would drop it from the pack's pattern, so such
    a draw becomes 1."""
    v = torch.randn(shape, generator=gen, device=device, dtype=dtype)
    return v.masked_fill_(v == 0, 1.0)


def _empty_remainder(dtype: torch.dtype, device: torch.device) -> dict:
    zi = torch.zeros(0, dtype=torch.int32, device=device)
    return dict(rem_data=torch.zeros(0, dtype=dtype, device=device), rem_row=zi, rem_col=zi)


def _grid_offsets(ny: int) -> tuple:
    return tuple(sorted({-ny, -1, 0, 1, ny}))


def _grid_mask(off: int, r: torch.Tensor, count: int, ny: int) -> torch.Tensor:
    """Where the 5-point grid of ``count`` nodes in rows of ``ny`` couples
    node ``r`` to node ``r + off``.  An offset of ±1 is the union of the
    within-row neighbour (absent at a grid-row end) and, when ``ny = 1``,
    the next grid row's node."""
    in_range = r < count
    if off == 0:
        return in_range
    ok = torch.zeros_like(in_range)
    col_in_row = r % ny
    if off == 1:
        ok |= in_range & (r + 1 < count) & (col_in_row != ny - 1)
    if off == -1:
        ok |= in_range & (r >= 1) & (col_in_row != 0)
    if off == ny:
        ok |= in_range & (r + ny < count)
    if off == -ny:
        ok |= in_range & (r >= ny)
    return ok


def stencil2d_dia_device(nx: int, ny: Optional[int] = None, *, dtype=torch.float32,
                         device=None) -> DiaMatrix:
    """5-point Laplacian on an nx×ny grid as a DiaMatrix built on ``device``.

    Diagonals (offsets −ny, −1, 0, +1, +ny): main 4; ±1 −1 unless crossing a
    grid-row end; ±ny −1 within bounds.  Bit-equal to
    ``dia_plan(stencil_2d(nx, ny))`` in every value type, ``ny = 1``
    included (see the module docstring)."""
    dev = plan_device(None, device)
    dt = torch_dtype(dtype)
    ny = ny or nx
    n = nx * ny
    r = torch.arange(_round_up(n, _ROW_TILE), device=dev)
    offsets = _grid_offsets(ny)
    vals = torch.stack([torch.where(_grid_mask(o, r, n, ny), 4.0 if o == 0 else -1.0, 0.0)
                        for o in offsets]).to(dt)
    return DiaMatrix(vals=vals, **_empty_remainder(dt, dev), vals_t=None, offsets=offsets,
                     shape=(n, n))


def fem_bdia_device(nx: int, ny: Optional[int] = None, *, dof: int = 4, dtype=torch.float32,
                    seed: int = 0, device=None) -> BdiaMatrix:
    """Multi-dof FEM-stencil matrix as a BdiaMatrix built on ``device``.

    Its structure is that of ``bdia_plan(fem_blocks(nx, ny, dof=dof))``: five
    block diagonals (−ny, −1, 0, +1, +ny) of dense dof×dof blocks, the
    grid-row ends' blocks structurally zero, the diagonal blocks shifted by
    4·dof.  The values are standard normal draws (:func:`_normal`) of a
    ``torch.Generator`` on ``device`` seeded by ``seed``: they are not
    ``jax.random``'s draws, nor ``fem_blocks``' numpy ones."""
    dev = plan_device(None, device)
    dt = torch_dtype(dtype)
    ny = ny or nx
    nbr = nx * ny
    b = dof
    ts = _pick_ts(nbr)
    nb_pad = _round_up(nbr, ts * _LANE)
    T = nb_pad // (ts * _LANE)
    offsets = _grid_offsets(ny)
    npairs = len(offsets) * b

    i = torch.arange(nb_pad, device=dev)
    # (nb_pad, npairs), pair order (d, c) as the plan's
    mask = torch.stack([_grid_mask(o, i, nbr, ny) for o in offsets], dim=-1)
    mask = mask.repeat_interleave(b, dim=-1)
    vals = _normal((b, nb_pad, npairs), _generator(seed, dev), dev, dt)
    vals *= mask.to(dt)
    # diagonal dominance on the d = 0, c = r slots (as fem_blocks)
    shift = torch.where(i < nbr, 4.0 * b, 0.0).to(dt)
    d0 = offsets.index(0)
    for r in range(b):
        vals[r, :, d0 * b + r] += shift
    v5 = vals.reshape(b, T, ts, _LANE, npairs).permute(0, 1, 4, 2, 3).contiguous()
    return BdiaMatrix(vals=v5, **_empty_remainder(dt, dev), block_offsets=offsets,
                      shape=(nbr * b, nbr * b), blocksize=(b, b), ts=ts)


def banded_dia_device(n: int, bandwidth: int, *, dtype=torch.float32, seed: int = 0,
                      device=None) -> DiaMatrix:
    """Dense band of width 2·bandwidth + 1 as a DiaMatrix built on ``device``,
    its values standard normal draws (:func:`_normal`) of a
    ``torch.Generator`` there seeded by ``seed`` (not ``jax.random``'s); its
    pattern is that of ``dia_plan(banded(n, bandwidth))``."""
    dev = plan_device(None, device)
    dt = torch_dtype(dtype)
    offsets = tuple(range(-bandwidth, bandwidth + 1))
    r = torch.arange(_round_up(n, _ROW_TILE), device=dev)
    vals = _normal((len(offsets), r.shape[0]), _generator(seed, dev), dev, dt)
    vals *= torch.stack([(r < n) & (r + o >= 0) & (r + o < n) for o in offsets]).to(dt)
    return DiaMatrix(vals=vals, **_empty_remainder(dt, dev), vals_t=None, offsets=offsets,
                     shape=(n, n))
