"""POH SpMV and SpMM: the hand-written CUDA kernels, their wrappers and their
plain twins.

:func:`poh_spmv` computes ``A·x`` and :func:`poh_spmm` ``A·X`` for a
:class:`cask_tpu_torch.ops.poh.PohMatrix`.  On a CUDA tensor each launches
its kernel (``csrc/poh_spmv.cu``, ``csrc/poh_spmm.cu``) or raises; on a CPU
tensor it runs its plain PyTorch twin.  They replace
``cask_tpu/ops/pallas/poh_kernels.py:poh_spmv_pallas`` (B16) and
``:poh_spmm_pallas`` (B17), whose one-hot MXU products are the TPU's way to
gather and scatter: the Hopper kernels gather x and scatter into a
shared-memory panel accumulator directly, in plain FP32/FP64.  Each kernel
works in pieces of its own, built once with the plan (:func:`spmv_pieces`,
:func:`spmm_pieces`); the SpMV kernel also reads each panel's two heaviest
rows (:func:`heavy_rows`), which it sums in registers.

Types (:func:`out_dtype`): f32 or f64 values and operand of one type, or
the half path (bf16 or f16 values or operand, with the other of the same
half type or f32), which sums in f32 and returns f32, as the reference's
``promote(values, x, f32)``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import TYPE_CHECKING, Optional

import numpy as np
import torch

from cask_tpu_torch.ops.kernels.bdia_kernels import (_out_dtype, bind, check_types, entry,
                                                     raise_on)

if TYPE_CHECKING:
    from cask_tpu_torch.ops.poh import PohMatrix

_MAX_SMEM = 232448  # bytes of shared memory a block may opt in to (227 KB)
_CTAS_PER_SM = 16  # SpMV: pieces of about ntiles / (16 · SMs) tiles
_SMS = 132  # an H100 SXM's SMs: the SpMV pieces are a plan-time table
_HEAVY = 2  # rows per panel the SpMV kernel sums in registers


def _slot_coords(p: "PohMatrix"):
    """Global (row, col) of every slot, flattened, as int64."""
    nt = p.ntiles
    rows = p.panel.long()[:, None] * p.row_panel + p.rloc.reshape(nt, -1).long()
    cols = p.wlo.long()[:, None] * p.col_window + p.cloc.reshape(nt, -1).long()
    return rows.reshape(-1), cols.reshape(-1)


def _x_padded(p: "PohMatrix", x: torch.Tensor) -> torch.Tensor:
    """``x`` (or ``X``) with zero rows up to the last window's end, so every
    slot's column (< (nseg + 1)·C) indexes it."""
    xp = x.new_zeros(((p.nseg + 1) * p.col_window,) + tuple(x.shape[1:]))
    xp[: p.shape[1]] = x
    return xp


def spmm_pieces(panel_ptr: torch.Tensor, cap: Optional[int] = None) -> torch.Tensor:
    """The SpMM kernel's work pieces, ``(P, 4)`` int32 rows ``(panel, first
    tile, end tile, cut)`` on ``panel_ptr``'s device.  A panel of more than
    ``cap`` tiles (default: the mean tile count, rounded up) is cut into the
    fewest even runs of at most ``cap`` tiles, each flagged ``cut``; any
    other panel, an empty one too, is one piece.  Every tile lies in exactly
    one piece, and every panel has at least one, so every row of Y is
    written.  Pieces are ordered largest first, so the longest blocks start
    first."""
    ptr = panel_ptr.cpu().numpy().astype(np.int64)
    counts = np.diff(ptr)
    if cap is None:
        cap = -(-int(ptr[-1]) // max(len(counts), 1))
    cap = max(int(cap), 1)
    n = np.maximum(-(-counts // cap), 1)  # pieces per panel
    panel = np.repeat(np.arange(len(counts)), n)
    i = np.arange(len(panel)) - np.repeat(np.cumsum(n) - n, n)  # index within the panel
    lo = ptr[panel] + counts[panel] * i // n[panel]
    hi = ptr[panel] + counts[panel] * (i + 1) // n[panel]
    pieces = np.stack([panel, lo, hi, (n[panel] > 1).astype(np.int64)], axis=1)
    pieces = pieces[np.argsort(lo - hi, kind="stable")]
    return torch.from_numpy(pieces.astype(np.int32)).to(panel_ptr.device)


def spmv_pieces(panel_ptr: torch.Tensor) -> torch.Tensor:
    """The SpMV kernel's work pieces: :func:`spmm_pieces` at a cap of
    ``ceil(ntiles / (16 · 132))`` tiles, so an H100's 132 SMs get about
    sixteen blocks each of about equal work (a hub panel of 4x the mean tile
    count is cut like any other): on the 1M-row power law 8 tiles, 173 µs,
    against 181 µs at 16 and 225 at 64 (``kernel_probe.py --poh-spmv``,
    NVIDIA H100 80GB HBM3 at 700 W)."""
    ntiles = int(panel_ptr[-1]) if panel_ptr.numel() else 0
    return spmm_pieces(panel_ptr, -(-ntiles // (_CTAS_PER_SM * _SMS)))


def heavy_rows(vals: torch.Tensor, rloc: torch.Tensor, panel: torch.Tensor, n_panels: int,
               row_panel: int) -> torch.Tensor:
    """``(n_panels, 2)`` int32 on ``vals``' device: the panel-local rows
    (``rloc``) holding the most and the next most live slots (value ≠ 0) of
    each panel, -1 where a panel has fewer such rows; slots with ``rloc``
    outside ``[0, row_panel)`` do not count.  The SpMV kernel sums these
    rows' slots in registers in place of shared atomics on one address."""
    nt = vals.shape[0]
    r = rloc.reshape(nt, -1).long()
    keep = (vals.reshape(nt, -1) != 0) & (r >= 0) & (r < row_panel)
    key = (panel.long()[:, None] * row_panel + r)[keep]
    counts = torch.bincount(key, minlength=n_panels * row_panel)[: n_panels * row_panel]
    best = counts.view(n_panels, row_panel).topk(_HEAVY, dim=1)
    return torch.where(best.values > 0, best.indices, -1).to(torch.int32)


def out_dtype(vals_dtype: torch.dtype, x_dtype: torch.dtype) -> torch.dtype:
    """The POH kernels' output type: ``promote(values, x, f32)`` (the
    reference's ``out_dt``, poh_kernels.py:408), f32 for every half
    combination."""
    return torch.promote_types(_out_dtype(vals_dtype, x_dtype), torch.float32)


def poh_spmv_reference(p: "PohMatrix", x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``y[row] += val · x[col]`` over every slot: each side
    widened exactly, products in :func:`out_dtype`, the result in that type.
    The scatter sums in f64: ``index_add_`` on a CUDA tensor adds in no fixed
    order, and a power-law hub row gathers thousands of products, so an f32
    scatter would differ from run to run by more than the kernel's own
    rounding.  Works on any device; the CUDA kernel is held against it."""
    acc = out_dtype(p.vals.dtype, x.dtype)
    rows, cols = _slot_coords(p)
    prod = p.vals.reshape(-1).to(acc) * _x_padded(p, x)[cols].to(acc)
    wide = torch.promote_types(acc, torch.float64)
    y = prod.new_zeros(p.n_panels * p.row_panel, dtype=wide).index_add_(0, rows, prod.to(wide))
    return y[: p.shape[0]].to(acc)


def poh_spmm_reference(p: "PohMatrix", x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``Y[row, :] += val · X[col, :]`` over every slot, as
    :func:`poh_spmv_reference`."""
    acc = out_dtype(p.vals.dtype, x.dtype)
    rows, cols = _slot_coords(p)
    prod = p.vals.reshape(-1, 1).to(acc) * _x_padded(p, x)[cols].to(acc)
    wide = torch.promote_types(acc, torch.float64)
    y = prod.new_zeros((p.n_panels * p.row_panel, x.shape[1]), dtype=wide)
    return y.index_add_(0, rows, prod.to(wide))[: p.shape[0]].to(acc)


@functools.lru_cache(maxsize=None)
def _lib(name: str) -> ctypes.CDLL:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if name == "poh_spmv":  # ..., pieces, heavy, x, y, n_pieces, R, C, T, m, n, stream
        args = [p] * 8 + [i, i, i, i, ll, ll, p]
    else:  # ..., pieces, X, Y, n_pieces, R, C, T, m, n, k, stream
        args = [p] * 7 + [i, i, i, i, ll, ll, i, p]
    return bind(name, f"cask_{name}", args, spmm=False)


def _check(p: "PohMatrix", x: torch.Tensor, ndim: int, what: str, whole_panel: bool) -> None:
    """Raise on what the kernels do not take (``whole_panel``: the kernel
    holds a panel's R partial sums in shared memory)."""
    n = p.shape[1]
    if any(t.device != x.device for t in (p.vals, p.cloc, p.rloc, p.wlo, p.panel_ptr)):
        raise ValueError(f"{what} on {x.device} but the plan on {p.vals.device}")
    if x.ndim != ndim or x.shape[0] != n:
        raise ValueError(f"{what} must have shape ({n}{', k' if ndim == 2 else ''}), "
                         f"got {tuple(x.shape)}")
    check_types(p.vals.dtype, x.dtype)
    slots = (p.ntiles, p.slot_rows, 128)
    if p.vals.shape != slots or p.cloc.shape != slots or p.rloc.shape != slots \
            or p.cloc.dtype != torch.int32 or p.rloc.dtype != torch.int32 \
            or p.wlo.dtype != torch.int32 or p.wlo.shape != (p.ntiles,):
        raise ValueError("vals/cloc/rloc/wlo are not the POH packing (ntiles, S, 128) "
                         "with int32 indices")
    if not all(t.is_contiguous() for t in (x, p.vals, p.cloc, p.rloc, p.wlo)):
        raise ValueError("kernel needs contiguous operands and slot arrays")
    # the panel's partial sums are of the output type, whatever x's width
    acc_bytes = p.row_panel * out_dtype(p.vals.dtype, x.dtype).itemsize
    if whole_panel and acc_bytes > _MAX_SMEM:
        raise ValueError(f"row_panel {p.row_panel} needs {acc_bytes} bytes of shared "
                         f"memory; a block has at most {_MAX_SMEM}")


def poh_spmv(p: "PohMatrix", x: torch.Tensor) -> torch.Tensor:
    """``A·x``: the CUDA kernel for a CUDA ``x``, the plain twin for a CPU
    ``x``.  Raises on what the kernel does not take."""
    if not x.is_cuda:
        if p.vals.is_cuda:
            raise ValueError(f"x on {x.device} but the plan on {p.vals.device}")
        return poh_spmv_reference(p, x)
    _check(p, x, 1, "x", whole_panel=True)
    m, n = p.shape
    y = torch.zeros(m, dtype=out_dtype(p.vals.dtype, x.dtype), device=x.device)  # added into
    if m == 0 or n == 0:
        return y
    pieces, heavy = p.spmv_pieces, p.heavy_row
    if pieces.device != x.device or heavy.device != x.device:
        raise ValueError(f"x on {x.device} but the plan's tables on {pieces.device}")
    lib = _lib("poh_spmv")
    fn = getattr(lib, entry("cask_poh_spmv", p.vals.dtype, x.dtype))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(p.vals.data_ptr(), p.cloc.data_ptr(), p.rloc.data_ptr(), p.wlo.data_ptr(),
                 pieces.data_ptr(), heavy.data_ptr(), x.data_ptr(), y.data_ptr(),
                 pieces.shape[0], p.row_panel, p.col_window, p.slot_rows * 128, m, n, stream)
    raise_on(lib, err, "poh_spmv")
    poh_spmv.launches += 1
    return y


def poh_spmm(p: "PohMatrix", x: torch.Tensor) -> torch.Tensor:
    """``A·X`` for a dense row-major ``X (n, k)``, any k: the CUDA kernel for
    a CUDA ``X``, the plain twin for a CPU ``X``.  Raises on what the kernel
    does not take."""
    if not x.is_cuda:
        if p.vals.is_cuda:
            raise ValueError(f"X on {x.device} but the plan on {p.vals.device}")
        return poh_spmm_reference(p, x)
    _check(p, x, 2, "X", whole_panel=False)  # the kernel splits a panel's rows
    m, n = p.shape
    k = int(x.shape[1])
    out = out_dtype(p.vals.dtype, x.dtype)
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, k), dtype=out, device=x.device)
    pieces = p.spmm_pieces
    # a cut panel's pieces add into Y; otherwise every element is written
    cut = pieces.shape[0] > p.n_panels
    y = (torch.zeros if cut else torch.empty)((m, k), dtype=out, device=x.device)
    lib = _lib("poh_spmm")
    fn = getattr(lib, entry("cask_poh_spmm", p.vals.dtype, x.dtype))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(p.vals.data_ptr(), p.cloc.data_ptr(), p.rloc.data_ptr(), p.wlo.data_ptr(),
                 pieces.data_ptr(), x.data_ptr(), y.data_ptr(), pieces.shape[0], p.row_panel,
                 p.col_window, p.slot_rows * 128, m, n, k, stream)
    raise_on(lib, err, "poh_spmm")
    poh_spmm.launches += 1
    return y


poh_spmv.launches = 0  # kernel launches since the last reset
poh_spmm.launches = 0
