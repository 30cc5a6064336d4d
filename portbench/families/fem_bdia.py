"""The FEM block matrix: ``dof × dof`` dense blocks on a 5-point grid graph.

Node ``i = gx·ny + gy`` of an ``nx × ny`` grid couples to itself and to its
grid neighbours (``i ± 1`` within a grid row, ``i ± ny``), each coupling a
dense ``dof × dof`` block (the structure of the repository's
``fem_blocks``).  Block values are standard normal draws from the seed,
the diagonal blocks shifted by ``diag_shift`` times the identity.

The user holds it by block diagonal, in the layout that the port's
``interop.bdia_from_arrays`` documents: ``vals (br, T, npairs, ts, 128)``,
where ``vals[r, t, d·bc + c, s, l]`` is element ``(r, c)`` of the block at
block row ``i = (t·ts + s)·128 + l`` on block offset ``offsets[d]``, block
rows padded to a whole tile of ``ts·128``; the tile height ``ts`` is the
configuration's, part of the layout the user holds.  It is made here on
the card from a ``torch.Generator`` there, drawn straight into that layout
and masked in place, and handed to the port's ``BdiaMatrix``.

The plain reference reads the same values as blocks and multiplies block
by block, in blocks of rows.
"""

from __future__ import annotations

import torch

from portbench.precision import as_precision
from portbench.yardstick import product_counts, sub_seed

_LANE = 128


def _geometry(cfg):
    nx, ny, b, ts = int(cfg["nx"]), int(cfg["ny"]), int(cfg["dof"]), int(cfg["ts"])
    nbr = nx * ny
    nb_pad = -(-nbr // (ts * _LANE)) * ts * _LANE
    return nx, ny, b, nbr, ts, nb_pad


def shape(cfg):
    _, _, b, nbr, _, _ = _geometry(cfg)
    return nbr * b, nbr * b


def counts(cfg, k: int) -> dict:
    """Entries: ``dof²`` for each node and each directed grid edge."""
    nx, ny, b, nbr, _, _ = _geometry(cfg)
    blocks = nbr + 2 * (nx - 1) * ny + 2 * nx * (ny - 1)
    m, n = shape(cfg)
    return product_counts(blocks * b * b, m, n, cfg["dtype"], k)


def offsets(cfg):
    ny = int(cfg["ny"])
    return (-ny, -1, 0, 1, ny)


def _coupled(i: torch.Tensor, d: int, nbr: int, ny: int) -> torch.Tensor:
    """Where block row ``i`` couples to block row ``i + d`` on the grid."""
    ok = (i < nbr) & (i + d >= 0) & (i + d < nbr)
    if abs(d) == 1:
        ok &= (i % ny + d >= 0) & (i % ny + d < ny)
    return ok


def make(cfg, seed: int, device) -> dict:
    """The block diagonals in the documented layout, on ``device``."""
    nx, ny, b, nbr, ts, nb_pad = _geometry(cfg)
    dt = getattr(torch, cfg["dtype"])
    offs = offsets(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, 1))
    tiles = nb_pad // (ts * _LANE)
    vals = torch.randn((b, tiles, len(offs) * b, ts, _LANE), generator=gen, device=device,
                       dtype=dt)
    i = torch.arange(nb_pad, device=device).reshape(tiles, 1, ts, _LANE)  # block row
    for d, off in enumerate(offs):
        vals[:, :, d * b:(d + 1) * b].masked_fill_(~_coupled(i, off, nbr, ny), 0)
    shift = (i[:, 0] < nbr).to(dt) * float(cfg["diag_shift"])
    d0 = offs.index(0)
    for r in range(b):
        vals[r, :, d0 * b + r] += shift
    return {"vals": vals, "offsets": offs, "ts": ts}


def port_matrix(cfg, inputs):
    """The port's BDIA plan class over the block diagonals, on the card."""
    from cask_tpu_torch.ops.bdia import BdiaMatrix

    vals = inputs["vals"]
    b = int(cfg["dof"])
    zi = torch.zeros(0, dtype=torch.int32, device=vals.device)
    return BdiaMatrix(vals=vals, rem_data=vals.new_zeros(0), rem_row=zi, rem_col=zi,
                      block_offsets=inputs["offsets"], shape=shape(cfg), blocksize=(b, b),
                      ts=inputs["ts"])


class Reference:
    """``A @ X`` block by block in a stated precision, and ``|A| @ |X|``, in
    blocks of ``block_rows`` block rows (whole tiles of the layout)."""

    def __init__(self, cfg, inputs, block_rows: int = 1 << 20):
        self.cfg = cfg
        _, self.ny, self.b, self.nbr, self.ts, self.nb_pad = _geometry(cfg)
        self.vals = inputs["vals"]
        self.offs = inputs["offsets"]
        tile = self.ts * _LANE
        self.block_rows = max(tile, block_rows // tile * tile)

    def _blocks_of(self, i0: int, i1: int) -> torch.Tensor:
        """``B[i, d, r, c]`` for block rows ``i0 ≤ i < i1`` (whole tiles)."""
        tile = self.ts * _LANE
        v = self.vals[:, i0 // tile:-(-i1 // tile)]  # (br, t, npairs, ts, 128)
        v = v.permute(1, 3, 4, 2, 0).reshape(-1, len(self.offs), self.b, self.b)  # [i, d, c, r]
        return v[: i1 - i0].transpose(-1, -2)

    def _product(self, blocks, xb, i0: int, i1: int, precision: str, absolute=False):
        """Rows ``i0 ≤ i < i1`` of ``A @ X`` (``xb``: X as (nbc, bc, k)), each
        block's products summed in ``precision``'s working type, in offset
        then column order; of ``|A| @ |X|`` with ``absolute``."""
        bl, dt = as_precision(blocks, precision)
        if absolute:
            bl = bl.abs()
        y = torch.zeros((i1 - i0, self.b, xb.shape[2]), dtype=dt, device=xb.device)
        for d, off in enumerate(self.offs):
            lo, hi = max(i0, -off), min(i1, self.nbr - off)
            if hi <= lo:
                continue
            xw = as_precision(xb[lo + off:hi + off], precision)[0]
            if absolute:
                xw = xw.abs()
            for c in range(self.b):
                y[lo - i0:hi - i0] += bl[lo - i0:hi - i0, d, :, c, None] * xw[:, None, c, :]
        return y.reshape((i1 - i0) * self.b, -1)

    def blocks(self, x, precisions):
        """``(row0, row1, {precision: rows of A @ x}, rows of |A| @ |x|)`` over
        the rows in blocks, each in f64; ``x`` (n,) or (n, k)."""
        xb = x.reshape(self.nbr, self.b, -1)
        for i0 in range(0, self.nbr, self.block_rows):
            i1 = min(i0 + self.block_rows, self.nbr)
            bl = self._blocks_of(i0, i1)
            scale = self._product(bl, xb, i0, i1, "exact", absolute=True)
            ys = {p: self._product(bl, xb, i0, i1, p).double() for p in precisions}
            yield i0 * self.b, i1 * self.b, ys, scale

    def apply(self, x, precision: str = "exact"):
        """The whole ``A @ x`` (for operands that fit twice over)."""
        return torch.cat([ys[precision] for _, _, ys, _ in self.blocks(x, (precision,))]) \
            .reshape(x.shape).to(as_precision(x[:1], precision)[1])
