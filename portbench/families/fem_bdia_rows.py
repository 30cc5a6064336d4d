"""The FEM block matrix of ``fem_bdia``, row-partitioned over the ranks of a
world, each rank holding its own rows on its own card.

The global grid is ``nx_rank · world`` by ``ny`` nodes, so a rank holds
``nx_rank`` whole grid lines: block rows ``[rank·nbloc, (rank+1)·nbloc)``,
``nbloc = nx_rank · ny``, of the matrix ``fem_bdia`` describes, with its
couplings (``fem_bdia._coupled``, on global block-row indices) and its
layout, tile height ``ts`` included.  A world of one is ``fem_bdia``'s
matrix on an ``nx_rank × ny`` grid.  Block offsets are global: a rank's
rows couple to ``ny`` block rows of each ring neighbour.

Rank *r* draws its values and its x from the seed on its card, in place,
each from a stream of its own; nothing of the other ranks is made.  The
plain reference is ``fem_bdia.Reference``'s block product over rank *r*'s
rows, reading the halo rows of x as the neighbours hold them, drawn again
from the same seed (zero past the global grid's edges).
"""

from __future__ import annotations

import torch

from portbench.families import fem_bdia
from portbench.precision import as_precision
from portbench.yardstick import product_counts, sub_seed

_LANE = 128

def _geometry(cfg, world: int):
    ny, b, ts = int(cfg["ny"]), int(cfg["dof"]), int(cfg["ts"])
    nbloc = int(cfg["nx_rank"]) * ny
    tiles = -(-nbloc // (ts * _LANE))
    return ny, b, ts, nbloc, tiles, nbloc * world


def shape(cfg, world: int):
    """The global matrix's shape in a world of ``world`` ranks."""
    _, b, _, _, _, nbr = _geometry(cfg, world)
    return nbr * b, nbr * b


def counts(cfg, k: int, rank: int, world: int) -> dict:
    """One rank's product: its entries (``dof²`` for each of its nodes and
    each directed grid edge leaving one), its x and y once, and the halo
    rows it receives from its ring neighbours once."""
    ny, b, _, nbloc, _, _ = _geometry(cfg, world)
    nx_rank = int(cfg["nx_rank"])
    blocks = nbloc + 2 * nx_rank * (ny - 1)  # the node and its grid row's neighbours
    blocks += (nbloc - ny * (rank == 0)) + (nbloc - ny * (rank == world - 1))  # ± ny
    rows = nbloc * b
    halo = 2 * ny * b if world > 1 else 0
    return product_counts(blocks * b * b, rows, rows + halo, cfg["dtype"], k)


def _generator(seed: int, stream: int, rank: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(sub_seed(seed, stream), rank))
    return gen


def make(cfg, seed: int, device, rank: int, world: int) -> dict:
    """Rank ``rank``'s block rows in the documented layout, on ``device``."""
    ny, b, ts, nbloc, tiles, nbr = _geometry(cfg, world)
    dt = getattr(torch, cfg["dtype"])
    offs = fem_bdia.offsets(cfg)
    vals = torch.randn((b, tiles, len(offs) * b, ts, _LANE),
                       generator=_generator(seed, 1, rank, device), device=device, dtype=dt)
    mine = torch.arange(tiles * ts * _LANE, device=device).reshape(tiles, 1, ts, _LANE)
    held = mine < nbloc  # the tile's padding past the rank's rows
    i = mine + rank * nbloc  # global block row
    for d, off in enumerate(offs):
        vals[:, :, d * b:(d + 1) * b].masked_fill_(~(fem_bdia._coupled(i, off, nbr, ny) & held),
                                                   0)
    shift = held[:, 0].to(dt) * float(cfg["diag_shift"])
    d0 = offs.index(0)
    for r in range(b):
        vals[r, :, d0 * b + r] += shift
    return {"vals": vals, "offsets": offs, "ts": ts}


def operand(cfg, seed: int, device, rank: int, world: int) -> torch.Tensor:
    """Rank ``rank``'s rows of x: standard normal draws from the seed."""
    _, b, _, nbloc, _, _ = _geometry(cfg, world)
    return torch.randn(nbloc * b, generator=_generator(seed, 2, rank, device), device=device,
                       dtype=getattr(torch, cfg["dtype"]))


def halo(cfg, seed: int, device, rank: int, world: int):
    """The x rows rank ``rank``'s matrix reads from its neighbours, drawn
    again as they draw them: the last ``ny`` block rows of rank − 1 and the
    first ``ny`` of rank + 1, zero past the global grid's edges."""
    ny, b, _, _, _, _ = _geometry(cfg, world)
    width = ny * b
    zeros = torch.zeros(width, device=device, dtype=getattr(torch, cfg["dtype"]))
    left = operand(cfg, seed, device, rank - 1, world)[-width:] if rank > 0 else zeros
    right = operand(cfg, seed, device, rank + 1, world)[:width] if rank < world - 1 else zeros
    return left.clone(), right.clone()


def port_shard(cfg, inputs, rank: int, world: int):
    """The port's rank-local shard of the block rows, on their card."""
    from cask_tpu_torch.interop import bdia_shard_from_arrays

    b = int(cfg["dof"])
    return bdia_shard_from_arrays(inputs["vals"], block_offsets=inputs["offsets"],
                                  shape=shape(cfg, world), blocksize=(b, b), ts=inputs["ts"],
                                  rank=rank, nshards=world)


class Reference(fem_bdia.Reference):
    """``fem_bdia.Reference``'s block product over one rank's rows: the
    blocks of ``inputs`` (the rank's rows), ``x`` the rank's own rows, and
    ``left``/``right`` the neighbours' halo rows of x."""

    def __init__(self, cfg, inputs, left, right, block_rows: int = 1 << 20):
        super().__init__(dict(cfg, nx=int(cfg["nx_rank"])), inputs, block_rows)  # its rows
        self.left, self.right = left, right

    def _product(self, blocks, xb, i0: int, i1: int, precision: str, absolute=False):
        """Rows ``i0 ≤ i < i1`` of ``A @ X`` with ``xb`` the rank's X between
        its halos, (ny + nbr + ny, bc, k): block row ``i`` reads ``xb[ny + i +
        d]`` on every offset, the couplings past the grid being zero blocks."""
        bl, dt = as_precision(blocks, precision)
        if absolute:
            bl = bl.abs()
        y = torch.zeros((i1 - i0, self.b, xb.shape[2]), dtype=dt, device=xb.device)
        for d, off in enumerate(self.offs):
            xw = as_precision(xb[self.ny + i0 + off:self.ny + i1 + off], precision)[0]
            if absolute:
                xw = xw.abs()
            for c in range(self.b):
                y += bl[:, d, :, c, None] * xw[:, None, c, :]
        return y.reshape((i1 - i0) * self.b, -1)

    def blocks(self, x, precisions):
        """``(row0, row1, {precision: rows of A @ x}, rows of |A| @ |x|)`` over
        the rank's rows in blocks, each in f64."""
        xb = torch.cat([self.left, x, self.right]).reshape(self.nbr + 2 * self.ny, self.b, -1)
        for i0 in range(0, self.nbr, self.block_rows):
            i1 = min(i0 + self.block_rows, self.nbr)
            bl = self._blocks_of(i0, i1)
            scale = self._product(bl, xb, i0, i1, "exact", absolute=True)
            ys = {p: self._product(bl, xb, i0, i1, p).double() for p in precisions}
            yield i0 * self.b, i1 * self.b, ys, scale
