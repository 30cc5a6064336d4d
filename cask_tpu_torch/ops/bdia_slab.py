"""Pre-sheared slab plan for wide-k BDIA SpMM.

The PyTorch counterpart of the plan half of
:mod:`cask_tpu.ops.pallas.bdia_slab`.  A BDIA plan's block band is sheared
once into per-tile dense slabs: tile ``t`` of ``g`` block rows holds a
``(g·br, W)`` slab whose columns are ::

    [ pre-halo bc | post-halo bc | core g·bc | one g·bc segment per far offset ]

- near block offsets (|d| ≤ 1) shear into the core, the two boundary
  blocks (d = −1 at the tile's first block row, d = +1 at its last) into
  the halo columns;
- each far offset d is a block diagonal inside its own segment, whose X
  window starts at row ``(t·g + d)·bc``.

Each product is then one ``(g·br × W) @ (W × k)`` product per tile: the
CUDA kernel of :mod:`cask_tpu_torch.ops.kernels.bdia_slab_kernels`.  The
slabs equal the reference's exactly.  Unlike the reference's plan, a
:class:`BdiaSlabs` carries its BDIA plan's COO remainder and
:meth:`BdiaSlabs.spmm` adds it (the reference drops it,
``bdia_slab.py:163-210``; ROADMAP Queue C 1).

:func:`slab_auto_plan` is the ``spmm`` auto route's plan (the reference's
``ops/spmm.py:_slab_auto_plan``), held per BDIA plan in
:data:`cask_tpu_torch.ops.spmv.default_plan_cache`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from cask_tpu_torch.formats.matrix import torch_dtype
from cask_tpu_torch.ops.bdia import BdiaMatrix, remainder_spmm
from cask_tpu_torch.ops.kernels.bdia_slab_kernels import bdia_spmm_slab

_LANE = 128
# the reference's cap on a memoized slab plan (ops/spmm.py:24): the shear
# inflates the values about W / (block diagonals · bc) times
SLAB_MAX_BYTES = 2 << 30
_SLAB_GS = (16, 8, 4)  # tile sizes the auto route tries, in order


@dataclasses.dataclass(frozen=True, eq=False)
class BdiaSlabs:
    """Pre-sheared slab plan plus its BDIA plan's COO remainder.

    Row ``t·g·br + q`` of ``slabs`` multiplies tile ``t``'s window into
    output row ``t·g·br + q``.  All tensors live on one device.
    """

    slabs: torch.Tensor  # (ntiles · g·br, W)
    rem_data: torch.Tensor  # scalar COO remainder (may be size 0)
    rem_row: torch.Tensor  # int32
    rem_col: torch.Tensor  # int32
    g: int
    blocksize: Tuple[int, int]
    shape: Tuple[int, int]
    far_offsets: Tuple[int, ...]
    nb_pad: int

    @property
    def ntiles(self) -> int:
        return self.nb_pad // self.g

    @property
    def gb_r(self) -> int:
        return self.g * self.blocksize[0]

    @property
    def gb_c(self) -> int:
        return self.g * self.blocksize[1]

    @property
    def width(self) -> int:
        """Slab columns across the segments, ``W``."""
        return 2 * self.blocksize[1] + self.gb_c * (1 + len(self.far_offsets))

    @property
    def dtype(self) -> torch.dtype:
        return self.slabs.dtype

    @property
    def device(self) -> torch.device:
        return self.slabs.device

    @property
    def gg_align(self) -> int:
        """The reference's super-tile alignment: the largest power of 2
        (≤ 32) dividing the tile count with at least 4 super-tiles.  It
        sets :attr:`pad_tiles`, so the padded layout's shape is the
        reference's."""
        gg = 1
        while gg < 32 and self.ntiles % (gg * 2) == 0 and gg * 2 <= max(1, self.ntiles // 4):
            gg *= 2
        return gg

    @property
    def pad_tiles(self) -> int:
        """Zero tiles on each side of the padded X/Y layout: the farthest
        offset in tiles, rounded up to whole super-tiles."""
        if not self.far_offsets:
            return 0
        m = max(abs(d) for d in self.far_offsets)
        ga = self.gg_align
        return -(-(-(-m // self.g)) // ga) * ga

    # -- padded chain layout ---------------------------------------------

    def to_padded(self, x) -> torch.Tensor:
        """Natural ``(n, k)`` (or ``(n,)``) → the zero-padded
        ``(rows_pad, kp)`` chain layout, ``kp`` a multiple of 128."""
        x = torch.as_tensor(x, device=self.device)
        if x.ndim == 1:
            x = x[:, None]
        k = x.shape[1]
        kp = max(_LANE, -(-k // _LANE) * _LANE)
        p = self.pad_tiles * self.gb_c
        body = self.ntiles * self.gb_c
        out = x.new_zeros((p + body + p, kp))
        out[p : p + x.shape[0], :k] = x
        return out

    def from_padded(self, ypad: torch.Tensor, k: int) -> torch.Tensor:
        p = self.pad_tiles * self.gb_r
        return ypad[p : p + self.shape[0], :k]

    # -- compute ----------------------------------------------------------

    def spmm(self, x: torch.Tensor, out_dtype=None) -> torch.Tensor:
        """``A·X`` (or ``A·x`` for a 1-D ``x``) in natural order: the slab
        kernel on a CUDA device, its plain twin on the CPU, then the
        remainder."""
        y = bdia_spmm_slab(self, x, out_dtype=out_dtype)
        if self.rem_data.shape[0]:
            y = y + remainder_spmm(self.rem_data, self.rem_row, self.rem_col,
                                   self.shape[0], x, y.dtype)
        return y


def bdia_slab_ok(a: BdiaMatrix, g: int = 16) -> bool:
    """The reference's slab gate (``bdia_slab.py:151-160``), kept so that the
    port's auto route builds a slab plan exactly where the reference's
    does: ``g`` divides the padded block rows and the tile geometry clears
    the TPU's 8-sublane floor.  The Hopper kernel takes any tile shape."""
    br, bc = a.blocksize
    hb = max(8, bc)
    return not (a.nb_pad % g or (g * br) % 8 or hb % bc or (g * bc) % hb)


def bdia_slab_plan(a: BdiaMatrix, g: int = 16, dtype=None) -> BdiaSlabs:
    """Shear the block band into per-tile dense slabs, on the plan's device
    (one-time); the remainder comes along.  ``dtype`` stores the slabs in
    another type (the reference's bf16 and f16 options)."""
    if not bdia_slab_ok(a, g):
        raise ValueError(f"plan not slab-eligible at g={g} (offsets {a.block_offsets})")
    br, bc = a.blocksize
    dt = a.vals.dtype if dtype is None else torch_dtype(dtype)
    nb_pad, ntiles, gb_c = a.nb_pad, a.nb_pad // g, g * bc
    offs = a.block_offsets
    near = [d for d in offs if abs(d) <= 1]
    far = tuple(sorted(d for d in offs if abs(d) > 1))
    width = 2 * bc + gb_c * (1 + len(far))
    # undo the (br, T, j, ts, 128) tiling: v[r, i, j] for block row i
    v = a.vals.permute(0, 1, 3, 4, 2).reshape(br, nb_pad, a.npairs)

    def blocks(d):  # (ntiles, g, br, bc): the block of block row t·g + h on offset d
        dpos = offs.index(d)
        bd = v[:, :, dpos * bc : (dpos + 1) * bc]
        return bd.transpose(0, 1).reshape(ntiles, g, br, bc).to(dt)

    slab = torch.zeros((ntiles, g, br, width), dtype=dt, device=a.vals.device)
    core = slab[..., 2 * bc : 2 * bc + gb_c].unflatten(-1, (g, bc))  # [t, h, r, h', c]
    for d in near:
        b = blocks(d)
        h = torch.arange(max(0, -d), min(g, g - d), device=slab.device)
        core[:, h, :, h + d, :] = b[:, h].transpose(0, 1)
        if d == -1:  # the first block row's sub-diagonal block → pre-halo
            slab[:, 0, :, :bc] = b[:, 0]
        if d == 1:  # the last block row's super-diagonal block → post-halo
            slab[:, g - 1, :, bc : 2 * bc] = b[:, g - 1]
    # a block diagonal inside its own segment, as the reference builds it:
    # blocks × identity, so its fill holds the same signed zeros, bit for bit
    eye = torch.eye(g, dtype=dt, device=slab.device)[None, :, None, :, None]
    for f, d in enumerate(far):
        seg = slab[..., 2 * bc + gb_c * (1 + f) : 2 * bc + gb_c * (2 + f)].unflatten(-1, (g, bc))
        seg.copy_(blocks(d)[:, :, :, None, :] * eye)
    return BdiaSlabs(slabs=slab.reshape(ntiles * g * br, width), rem_data=a.rem_data,
                     rem_row=a.rem_row, rem_col=a.rem_col, g=g, blocksize=(br, bc),
                     shape=a.shape, far_offsets=far, nb_pad=nb_pad)


def slab_auto_plan(a: BdiaMatrix) -> Optional[BdiaSlabs]:
    """The reference's ``_slab_auto_plan`` (``ops/spmm.py:27-55``): the
    first ``g`` in (16, 8, 4) that :func:`bdia_slab_ok` admits and whose
    slabs stay under :data:`SLAB_MAX_BYTES`, or None."""
    br, bc = a.blocksize
    nfar = sum(1 for d in a.block_offsets if abs(d) > 1)
    for g in _SLAB_GS:
        if not bdia_slab_ok(a, g):
            continue
        if a.nb_pad * br * (2 * bc + g * bc * (1 + nfar)) * a.vals.element_size() \
                > SLAB_MAX_BYTES:
            continue  # a smaller g shrinks the far segments' fill
        return bdia_slab_plan(a, g)
    return None
