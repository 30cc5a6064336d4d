"""The plain reference of a row range of the FEM block product, for the
rank-local shard tests: no JAX, no kernel and no plan of the port.

The matrix is the dof-block 5-point grid graph of ``cask_tpu_torch``'s
``fem_blocks`` family: node ``i = gx·ny + gy`` of an ``nx × ny`` grid
couples to itself and to its grid neighbours (``i ± 1`` within a grid row,
``i ± ny``), each coupling a dense ``dof × dof`` block.  ``block(i, d)``
gives the blocks of block rows ``i`` on block offset ``d``; where the grid
has no such neighbour the product takes no term, whatever ``block`` says.
"""

from __future__ import annotations

import torch


def neighbours(i: torch.Tensor, d: int, nx: int, ny: int) -> torch.Tensor:
    """Where block row ``i`` has a grid neighbour at block offset ``d``."""
    gx, gy = i // ny, i % ny
    if d == 0:
        return torch.ones_like(i, dtype=torch.bool)
    if abs(d) == 1:
        return (gy + d >= 0) & (gy + d < ny)
    return (gx + d // ny >= 0) & (gx + d // ny < nx)


def block_rows_product(nx: int, ny: int, dof: int, r0: int, r1: int, x: torch.Tensor,
                       block) -> torch.Tensor:
    """Scalar rows ``[r0·dof, r1·dof)`` of ``A @ x`` in float64, block row by
    block row: ``y_i = Σ_d block(i, d) @ x_{i+d}`` over the grid neighbours
    of ``i``.  ``x`` is the global operand, ``(nx·ny·dof,)`` or with
    columns; ``block(i, d)`` returns ``(len(i), dof, dof)`` values."""
    i = torch.arange(r0, r1, dtype=torch.int64)
    xb = x.double().reshape(nx * ny, dof, -1)
    y = torch.zeros((r1 - r0, dof, xb.shape[2]), dtype=torch.float64)
    for d in (-ny, -1, 0, 1, ny):
        ok = neighbours(i, d, nx, ny)
        rows = i[ok]
        y[ok] += block(rows, d).double() @ xb[rows + d]
    return y.reshape(((r1 - r0) * dof,) + tuple(x.shape[1:]))
