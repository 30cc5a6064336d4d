"""HPCG's operator: the 27-point stencil on an ``nx × ny × nz`` grid.

Row ``r = (z·ny + y)·nx + x`` couples to each of its up to 26 neighbours
(every ``(dx, dy, dz)`` in ``{-1, 0, 1}³`` that stays on the grid) with the
value ``neighbor`` and to itself with ``center`` (HPCG: -1 and 26).  The
user holds it as HPCG does, in 27 diagonals and their offsets
``dz·nx·ny + dy·nx + dx``; the port gets them as a ``DiaMatrix`` on the
card, made here with no host round trip.  The operator has no random
values, so the seed only draws the operands.

The plain reference applies the stencil from the grid's coordinates, with
no diagonals: a zero-padded grid and 27 shifted views.
"""

from __future__ import annotations

import itertools
import math

import torch

from portbench.yardstick import product_counts
from portbench.precision import as_precision

SHIFTS = tuple(itertools.product((-1, 0, 1), repeat=3))  # (dz, dy, dx)


def _dims(cfg):
    dims = int(cfg["nx"]), int(cfg["ny"]), int(cfg["nz"])
    if min(dims) < 3:  # below 3 a row's 27 offsets are not all distinct
        raise ValueError(f"the 27-point grid needs 3 or more points an axis, got {dims}")
    return dims


def shape(cfg):
    nx, ny, nz = _dims(cfg)
    return nx * ny * nz, nx * ny * nz


def counts(cfg, k: int) -> dict:
    """Entries of the stencil on the grid: ``Π (3·n − 2)`` over the axes."""
    entries = math.prod(3 * n - 2 for n in _dims(cfg))
    m, n = shape(cfg)
    return product_counts(entries, m, n, cfg["dtype"], k)


def offsets(cfg):
    nx, ny, _ = _dims(cfg)
    return tuple(sorted(dz * nx * ny + dy * nx + dx for dz, dy, dx in SHIFTS))


def make(cfg, seed: int, device) -> dict:
    """The 27 diagonals ``(27, m)`` in the configuration's type, on ``device``:
    ``vals[d, r]`` is the coupling of row ``r`` to ``r + offsets[d]``, 0 where
    that neighbour is off the grid.  Each diagonal is written in place."""
    nx, ny, nz = _dims(cfg)
    m, _ = shape(cfg)
    r = torch.arange(m, device=device)
    coords = (r // (nx * ny), (r // nx) % ny, r % nx)  # z, y, x
    del r
    offs = offsets(cfg)
    vals = torch.empty((len(offs), m), dtype=getattr(torch, cfg["dtype"]), device=device)
    for dz, dy, dx in SHIFTS:
        ok = torch.ones(m, dtype=torch.bool, device=device)
        for c, s, n in zip(coords, (dz, dy, dx), (nz, ny, nx)):
            if s:
                ok &= (c + s >= 0) & (c + s < n)
        w = cfg["center"] if (dz, dy, dx) == (0, 0, 0) else cfg["neighbor"]
        row = vals[offs.index(dz * nx * ny + dy * nx + dx)]
        row.fill_(w).masked_fill_(~ok, 0)
    return {"vals": vals, "offsets": offs}


def port_matrix(cfg, inputs):
    """The port's DIA plan class over the diagonals, as they lie on the card."""
    from cask_tpu_torch.ops.dia import DiaMatrix

    vals = inputs["vals"]
    zi = torch.zeros(0, dtype=torch.int32, device=vals.device)
    return DiaMatrix(vals=vals, rem_data=vals.new_zeros(0), rem_row=zi, rem_col=zi,
                     vals_t=None, offsets=inputs["offsets"], shape=shape(cfg))


class Reference:
    """``A @ X`` by the stencil's formula, in a stated precision, and
    ``|A| @ |X|``, the scale each row's rounding is measured against."""

    def __init__(self, cfg, inputs=None):
        self.cfg = cfg
        self.dims = _dims(cfg)

    def _stencil(self, x, weight):
        nx, ny, nz = self.dims
        k = x.shape[1]
        g = torch.nn.functional.pad(x.T.reshape(k, nz, ny, nx), (1, 1, 1, 1, 1, 1))
        y = torch.zeros((k, nz, ny, nx), dtype=x.dtype, device=x.device)
        for dz, dy, dx in SHIFTS:
            w = weight(self.cfg["center"] if (dz, dy, dx) == (0, 0, 0) else self.cfg["neighbor"])
            y += w * g[:, 1 + dz:1 + dz + nz, 1 + dy:1 + dy + ny, 1 + dx:1 + dx + nx]
        return y.reshape(k, -1).T

    def apply(self, x, precision: str = "exact"):
        """``A @ x`` for ``x`` (m,) or (m, k): ``exact`` in f64, else the
        operand rounded to ``precision`` and summed in its working type."""
        xs, dt = as_precision(x, precision)
        y = self._stencil(xs.reshape(xs.shape[0], -1), float)
        return y.reshape(x.shape).to(dt)

    def blocks(self, x, precisions):
        """One block of all rows: ``(0, m, {precision: A @ x}, |A| @ |x|)``,
        each in f64."""
        xa = x.reshape(x.shape[0], -1)
        scale = self._stencil(xa.double().abs(), abs)
        ys = {p: self.apply(xa, p).double() for p in precisions}
        yield 0, xa.shape[0], ys, scale
