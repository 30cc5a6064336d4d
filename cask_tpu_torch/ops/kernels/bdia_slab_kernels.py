"""Slab SpMM: the hand-written CUDA kernel, its two wrappers and its plain twin.

:func:`bdia_spmm_slab` (natural frame) and :func:`bdia_spmm_slab_padded`
(the padded chain layout of :meth:`BdiaSlabs.to_padded`) compute the slab
part of ``A·X`` for a :class:`cask_tpu_torch.ops.bdia_slab.BdiaSlabs` (the
COO remainder is added by :meth:`BdiaSlabs.spmm`).  On CUDA tensors they
launch the kernel of ``csrc/bdia_slab_spmm.cu`` or raise; on CPU tensors
they run :func:`bdia_spmm_slab_reference`, the same product in plain
PyTorch.  One kernel stands in for the TPU's two slab kernels,
``cask_tpu/ops/pallas/bdia_slab.py:bdia_spmm_slab_padded`` (B5) and
``:_slab_ring_call`` (B6): they differ only in how the TPU delivers X
windows into VMEM.  The reference's super-tile factor ``gg`` picks a TPU
grid and has no counterpart, so neither wrapper takes it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import TYPE_CHECKING

import torch

from cask_tpu_torch.ops.kernels.bdia_kernels import (bind, check_out_dtype, entry, raise_on,
                                                     result_dtype)

if TYPE_CHECKING:
    from cask_tpu_torch.ops.bdia_slab import BdiaSlabs

MAX_FAR = 64  # far offsets the kernel takes (kMaxFar; bdia_plan keeps at most 64)


def _window_rows(sl: "BdiaSlabs", tile0: int, device) -> torch.Tensor:
    """(ntiles, W) X row of every window row of every body tile, in the
    window's column order: pre-halo, post-halo, core, far segments."""
    bc, gb_c = sl.blocksize[1], sl.gb_c
    row0 = (tile0 + torch.arange(sl.ntiles, device=device))[:, None] * gb_c
    halo = torch.arange(bc, device=device)
    core = torch.arange(gb_c, device=device)
    segs = [row0 - bc + halo, row0 + gb_c + halo, row0 + core]
    segs += [row0 + d * bc + core for d in sl.far_offsets]
    return torch.cat(segs, dim=1)


def bdia_spmm_slab_reference(sl: "BdiaSlabs", x: torch.Tensor, *, padded: bool = False,
                             out_dtype=None) -> torch.Tensor:
    """Plain PyTorch slab product: gather every tile's window (rows outside
    the frame as zero), one batched ``slab_t @ Xwin_t``, summed in
    ``promote(out, f32)``.  ``x`` is natural ``(n, k)`` (returns ``(m, k)``)
    or, with ``padded``, the chain layout (returns the padded ``Y``, pad
    tiles zero).  Works on any device; the CUDA kernel is held against it."""
    out = result_dtype(sl.dtype, x.dtype, out_dtype)
    acc = torch.promote_types(out, torch.float32)
    tile0 = sl.pad_tiles if padded else 0
    idx = _window_rows(sl, tile0, x.device)
    inside = (idx >= 0) & (idx < x.shape[0])
    win = torch.where(inside[..., None], x[idx.clamp(0, max(x.shape[0] - 1, 0))], 0)
    s = sl.slabs.reshape(sl.ntiles, sl.gb_r, sl.width)
    body = torch.bmm(s.to(acc), win.to(acc)).reshape(sl.ntiles * sl.gb_r, x.shape[1]).to(out)
    if not padded:
        return body[: sl.shape[0]]
    p = sl.pad_tiles * sl.gb_r
    y = body.new_zeros((2 * p + body.shape[0], x.shape[1]))
    y[p : p + body.shape[0]] = body
    return y


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return bind("bdia_slab_spmm", "cask_slab_spmm",
                [p, p, p, ctypes.POINTER(ctypes.c_int), i, i, i, i, i, ll, ll, ll, ll, i, p],
                spmm=True, f64_sums=True)


def _launch(sl: "BdiaSlabs", x: torch.Tensor, y: torch.Tensor, tile0: int, y_rows: int,
            name: str) -> None:
    """Check what the kernel takes and launch it on ``x``'s stream."""
    if sl.slabs.device != x.device or sl.rem_data.device != x.device:
        raise ValueError(f"X on {x.device} but the plan on {sl.slabs.device}")
    check_out_dtype(sl.dtype, x.dtype, y.dtype)
    if len(sl.far_offsets) > MAX_FAR:
        raise ValueError(f"plan has {len(sl.far_offsets)} far offsets; the kernel takes "
                         f"at most {MAX_FAR}")
    if sl.slabs.shape != (sl.ntiles * sl.gb_r, sl.width):
        raise ValueError(f"slabs shape {tuple(sl.slabs.shape)} is not "
                         f"(ntiles·g·br, W) = ({sl.ntiles * sl.gb_r}, {sl.width})")
    if not (x.is_contiguous() and sl.slabs.is_contiguous()):
        raise ValueError("kernel needs contiguous X and slabs")
    k = int(x.shape[1])
    lib = _lib()
    fn = getattr(lib, entry("cask_slab_spmm", sl.dtype, x.dtype, y.dtype))
    far = (ctypes.c_int * max(len(sl.far_offsets), 1))(*sl.far_offsets)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(sl.slabs.data_ptr(), x.data_ptr(), y.data_ptr(), far, len(sl.far_offsets),
                 sl.blocksize[1], sl.gb_r, sl.gb_c, sl.width, sl.ntiles, x.shape[0], tile0,
                 y_rows, k, stream)
    raise_on(lib, err, name)


def bdia_spmm_slab(sl: "BdiaSlabs", x: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """Slab part of ``A·X`` in the natural frame, ``x`` of shape ``(n,)`` or
    ``(n, k)``: the counterpart of ``bdia_spmm_pallas_slab`` and
    ``bdia_spmm_slab_ring``.  The CUDA kernel for a CUDA ``x``, the plain
    twin for a CPU ``x``.  Raises on what the kernel does not take."""
    m, n = sl.shape
    squeeze = x.ndim == 1
    x2 = x[:, None] if squeeze else x
    if x2.ndim != 2 or x2.shape[0] != n:
        raise ValueError(f"x must have shape ({n},) or ({n}, k), got {tuple(x.shape)}")
    if not x.is_cuda:
        if sl.slabs.is_cuda:
            raise ValueError(f"X on {x.device} but the plan on {sl.slabs.device}")
        y = bdia_spmm_slab_reference(sl, x2, out_dtype=out_dtype)
    else:
        k = int(x2.shape[1])
        y = torch.empty((m, k), dtype=result_dtype(sl.dtype, x.dtype, out_dtype),
                        device=x.device)
        if m and k:
            _launch(sl, x2, y, 0, m, "bdia_spmm_slab")
            bdia_spmm_slab.launches += 1
    return y[:, 0] if squeeze else y


def bdia_spmm_slab_padded(sl: "BdiaSlabs", xpad: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """Slab part of ``A·X`` in the padded chain layout of
    :meth:`BdiaSlabs.to_padded` (square blocks, so ``Y`` has ``X``'s
    layout and products chain): the counterpart of
    ``bdia_spmm_slab_padded`` and ``bdia_spmm_slab_ring_padded``.  Pad rows
    of ``Y`` are zero.  The CUDA kernel for a CUDA ``xpad``, the plain twin
    for a CPU one."""
    br, bc = sl.blocksize
    if br != bc:
        raise ValueError("padded slab chain layout needs square blocks")
    total = 2 * sl.pad_tiles + sl.ntiles
    if xpad.ndim != 2 or xpad.shape[0] != total * sl.gb_c:
        raise ValueError(f"xpad rows {tuple(xpad.shape)} != ({total * sl.gb_c}, k)")
    if not xpad.is_cuda:
        if sl.slabs.is_cuda:
            raise ValueError(f"X on {xpad.device} but the plan on {sl.slabs.device}")
        return bdia_spmm_slab_reference(sl, xpad, padded=True, out_dtype=out_dtype)
    k = int(xpad.shape[1])
    y = torch.empty((total * sl.gb_r, k), dtype=result_dtype(sl.dtype, xpad.dtype, out_dtype),
                    device=xpad.device)
    p = sl.pad_tiles * sl.gb_r
    y[:p].zero_()
    y[p + sl.ntiles * sl.gb_r :].zero_()
    if k:
        _launch(sl, xpad, y, sl.pad_tiles, y.shape[0], "bdia_spmm_slab_padded")
        bdia_spmm_slab_padded.launches += 1
    return y


bdia_spmm_slab.launches = 0  # kernel launches since the last reset
bdia_spmm_slab_padded.launches = 0
