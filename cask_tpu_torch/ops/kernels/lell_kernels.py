"""LELL SpMV: the hand-written CUDA kernels, their wrappers and their plain twins.

:func:`lell_lane_sums` computes the packed part of a lane-bucketed ELL
product: for slot row ``s`` and group ``g``, the sum over the ``L`` layers
and the group's ``B = 128 / G`` lanes of ``vals · x[idx·B + b]``.  One
kernel (``csrc/lell_spmv.cu``) serves the grouped tier of a
:class:`cask_tpu_torch.ops.lell.LellMatrix` (G = ``groups``) and the hub tier
of a :class:`cask_tpu_torch.ops.lell.ChunkedLell` (G = 1), as ``_lell_call``
serves both in the reference.  :func:`lell_spmv` is the whole product of a
``LellMatrix`` or a ``HybLell`` (its two tiers): the grouped tier's sums
written as y, then the hub tier's slot-row sums and the COO remainder added
into y by atomics, two launches (three for an f16 · f16 y with a hub tier
or remainder, summed in an f32 y and rounded once) and no other device
operation.  On a CUDA tensor each launches its kernels or raises; on a CPU
tensor it runs its plain twin (:func:`lell_lane_sums_reference`,
:func:`lell_spmv_reference`).  They replace
``cask_tpu/ops/pallas/lell_kernels.py:lell_spmv_pallas`` and
``:_lell_lane_sums`` (B18), whose bucket-replicated x layout and its
4096-row cap (``_SB_CAP``) are TPU gather rules the Hopper kernel does not
need: it reads x directly, at any width.

Types (:func:`out_dtype`, the reference's ``_out_dtype``): f32 or f64 values
and x of one type, or the half path (bf16 or f16 values or x, with the
other of the same half type or f32), which sums in f32 and returns f32, but
f16 for f16 values and x (each f32 sum rounded once).
"""

from __future__ import annotations

import ctypes
import functools
from typing import TYPE_CHECKING, Optional

import torch

from cask_tpu_torch.ops.kernels.bdia_kernels import (_out_dtype, bind, check_types, entries,
                                                     entry, raise_on)

if TYPE_CHECKING:
    from cask_tpu_torch.ops.lell import ChunkedLell, LellMatrix

_LANE = 128
out_dtype = _out_dtype  # f32 where either side is bf16 or one is f32; f16 · f16 -> f16


def lell_lane_sums_reference(vals: torch.Tensor, idx: torch.Tensor, x: torch.Tensor,
                             groups: int) -> torch.Tensor:
    """Plain PyTorch group sums ``(S_pad, G)``: gather ``x[idx·B + b]`` (0 at
    index ≥ n), multiply, sum the layers, then the B lanes of each group, in
    ``promote(out, f32)`` with each side widened exactly; the sums in
    :func:`out_dtype`, rounded once.  Works on any device; the CUDA kernel is
    held against it."""
    L, s_pad, _ = vals.shape
    B = _LANE // groups
    n = x.shape[0]
    out = out_dtype(vals.dtype, x.dtype)
    acc = torch.promote_types(out, torch.float32)
    lane_b = torch.arange(_LANE, device=x.device) % B
    pos = idx.long() * B + lane_b
    xp = x.new_zeros(-(-max(n, 1) // B) * B)
    xp[:n] = x
    g = xp[pos.clamp(max=xp.shape[0] - 1)] * (pos < n)
    lanes = (vals.to(acc) * g.to(acc)).sum(0)  # (S_pad, 128)
    return lanes.reshape(s_pad, groups, B).sum(-1).to(out)


def _grouped_y_reference(main: "LellMatrix", x: torch.Tensor) -> torch.Tensor:
    """``A·x`` of a grouped tier and its COO remainder in plain PyTorch: the
    twin of the rows kernel and the remainder's atomics."""
    m = main.shape[0]
    y = lell_lane_sums_reference(main.vals, main.idx, x, main.groups).reshape(-1)[:m]
    if y.shape[0] < m:
        # trailing empty rows past the last packed slot row: the slot rows
        # stop there, so y is padded (the reference returns it short)
        y = torch.cat([y, y.new_zeros(m - y.shape[0])])
    if main.rem_data.shape[0]:
        # products and their sum in the output's sum type (f32 for a half
        # output), rounded once: the reference rounds each half product
        acc = torch.promote_types(y.dtype, torch.float32)
        prod = main.rem_data.to(acc) * x[main.rem_col.long()].to(acc)
        y = y.to(acc).index_add(0, main.rem_row.long(), prod).to(y.dtype)
    return y


def hub_partial(hub: "ChunkedLell", x: torch.Tensor, lane_sums) -> torch.Tensor:
    """A hub tier's per-row partial sums (length m, zeros for non-hub rows):
    ``lane_sums`` at G = 1, then a segment sum by ``slot2row`` in PyTorch."""
    m = hub.shape[0]
    sums = lane_sums(hub.vals, hub.idx, x, 1).reshape(-1)  # (S_pad,)
    acc = torch.promote_types(sums.dtype, torch.float32)  # a half output sums in f32
    return (sums.new_zeros(m + 1, dtype=acc).index_add_(0, hub.slot2row.long(),
                                                        sums.to(acc))[:m].to(sums.dtype))


def lell_spmv_reference(main: "LellMatrix", hub: Optional["ChunkedLell"],
                        x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``A·x`` of a grouped tier with its remainder and an
    optional hub tier, on any device: the grouped tier's group sums as y,
    the remainder, then :func:`hub_partial` around
    :func:`lell_lane_sums_reference`.  An f16 · f16 y is rounded at each of
    those steps; the kernels round it once."""
    y = _grouped_y_reference(main, x)
    if hub is not None and hub.vals.shape[1] > 0:
        y = y + hub_partial(hub, x, lell_lane_sums_reference)
    return y


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib = bind("lell_spmv", "cask_lell_spmv", [p, p, p, p, i, ll, i, ll, p], spmm=False)
    # vals, idx, x, y, L, s_pad, G, m, n, stream
    for name in entries("cask_lell_rows", spmm=False) + ["cask_lell_rows_f16_f16_f32"]:
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [p, p, p, p, i, ll, i, ll, ll, p], ctypes.c_int
    # vals, idx, slot2row, L, s_pad, rem_data, rem_row, rem_col, n_rem, x, y, m, n, stream
    for name in entries("cask_lell_hub", spmm=False):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = [p, p, p, i, ll, p, p, p, ll, p, p, ll, ll, p], ctypes.c_int
    lib.cask_lell_round_f16.argtypes = [p, p, ll, p]
    lib.cask_lell_round_f16.restype = ctypes.c_int
    return lib


def _check_tier(vals: torch.Tensor, idx: torch.Tensor, x: torch.Tensor) -> None:
    """Raise on a tier the kernels do not take."""
    if vals.device != x.device or idx.device != x.device:
        raise ValueError(f"x on {x.device} but the plan on {vals.device}")
    if vals.ndim != 3 or vals.shape[2] != _LANE or idx.shape != vals.shape \
            or idx.dtype != torch.int32:
        raise ValueError(f"vals {tuple(vals.shape)} / idx {tuple(idx.shape)} {idx.dtype} "
                         f"are not the LELL packing (L, S_pad, 128) with int32 indices")
    if not (vals.is_contiguous() and idx.is_contiguous()):
        raise ValueError("kernel needs contiguous x, vals and idx")
    if vals.data_ptr() % min(4 * vals.element_size(), 16) or idx.data_ptr() % 16:
        raise ValueError("kernel needs vals and idx aligned to its vector loads")


def lell_lane_sums(vals: torch.Tensor, idx: torch.Tensor, x: torch.Tensor,
                   groups: int) -> torch.Tensor:
    """Group sums ``(S_pad, groups)`` of a packed LELL tier: the CUDA kernel
    for a CUDA ``x``, the plain twin for a CPU ``x``.  Raises on what the
    kernel does not take."""
    if groups < 1 or _LANE % groups:
        raise ValueError(f"groups must divide 128, got {groups}")
    if not x.is_cuda:
        if vals.is_cuda:
            raise ValueError(f"x on {x.device} but the plan on {vals.device}")
        return lell_lane_sums_reference(vals, idx, x, groups)
    if x.ndim != 1:
        raise ValueError(f"x must be 1-D, got shape {tuple(x.shape)}")
    check_types(vals.dtype, x.dtype)
    _check_tier(vals, idx, x)
    if not x.is_contiguous():
        raise ValueError("kernel needs contiguous x, vals and idx")
    L, s_pad, _ = vals.shape
    odt = out_dtype(vals.dtype, x.dtype)
    if s_pad == 0 or L == 0:
        return torch.zeros((s_pad, groups), dtype=odt, device=x.device)
    out = torch.empty((s_pad, groups), dtype=odt, device=x.device)  # all written
    lib = _lib()
    fn = getattr(lib, entry("cask_lell_spmv", vals.dtype, x.dtype))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(vals.data_ptr(), idx.data_ptr(), x.data_ptr(), out.data_ptr(), L, s_pad,
                 groups, x.shape[0], stream)
    raise_on(lib, err, "lell_spmv")
    lell_lane_sums.launches += 1
    return out


def lell_spmv(main: "LellMatrix", hub: Optional["ChunkedLell"],
              x: torch.Tensor) -> torch.Tensor:
    """``A·x`` (length m) of a grouped tier with its COO remainder and an
    optional hub tier: the CUDA kernels for a CUDA ``x`` (the grouped tier's
    rows written, then one launch adding the hub tier and the remainder, and
    for an f16 y with either the rounding of its f32 sums), the plain twin
    :func:`lell_spmv_reference` for a CPU ``x``.  Raises on what the kernels
    do not take."""
    if not x.is_cuda:
        if main.vals.is_cuda:
            raise ValueError(f"x on {x.device} but the plan on {main.vals.device}")
        return lell_spmv_reference(main, hub, x)
    m, n = main.shape
    if x.ndim != 1 or x.shape[0] != n:
        raise ValueError(f"x must have shape ({n},), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("kernel needs contiguous x, vals and idx")
    vdt = main.vals.dtype
    check_types(vdt, x.dtype)
    _check_tier(main.vals, main.idx, x)
    has_hub = hub is not None and hub.vals.shape[1] > 0
    if has_hub:
        _check_tier(hub.vals, hub.idx, x)
        if hub.vals.dtype != vdt or hub.slot2row.dtype != torch.int32 \
                or hub.slot2row.shape != (hub.vals.shape[1],) \
                or not hub.slot2row.is_contiguous() or hub.slot2row.device != x.device:
            raise ValueError("the hub tier needs the grouped tier's value type and a "
                             "contiguous int32 slot2row of length S_pad on x's device")
    rem = (main.rem_data.to(vdt), main.rem_row, main.rem_col)
    n_rem = rem[0].shape[0]
    if any(t.device != x.device or not t.is_contiguous() for t in rem) \
            or rem[1].dtype != torch.int32 or rem[2].dtype != torch.int32 \
            or not rem[1].shape == rem[2].shape == (n_rem,):
        raise ValueError("the remainder needs contiguous int32 rows and columns of its "
                         "length on x's device")
    odt = out_dtype(vdt, x.dtype)
    adds = has_hub or n_rem > 0
    acc = torch.promote_types(odt, torch.float32)  # the atomics' type
    y = torch.empty(m, dtype=acc if adds else odt, device=x.device)  # every row written
    if m == 0:
        return y.to(odt)
    lib = _lib()
    L, s_pad, _ = main.vals.shape
    rows = entry("cask_lell_rows", vdt, x.dtype) + ("_f32" if y.dtype != odt else "")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, rows)(main.vals.data_ptr(), main.idx.data_ptr(), x.data_ptr(),
                                 y.data_ptr(), L, s_pad, main.groups, m, n, stream)
        raise_on(lib, err, "lell_spmv rows")
        lell_spmv.launches += 1
        if not adds:
            return y
        hv, hi, hs = (hub.vals, hub.idx, hub.slot2row) if has_hub else (main.vals, main.idx,
                                                                        main.idx)
        err = getattr(lib, entry("cask_lell_hub", vdt, x.dtype))(
            hv.data_ptr(), hi.data_ptr(), hs.data_ptr(), hv.shape[0],
            hv.shape[1] if has_hub else 0, rem[0].data_ptr(), rem[1].data_ptr(),
            rem[2].data_ptr(), n_rem, x.data_ptr(), y.data_ptr(), m, n, stream)
        raise_on(lib, err, "lell_spmv hub")
        lell_spmv.launches += 1
        if y.dtype == odt:
            return y
        out = torch.empty(m, dtype=odt, device=x.device)
        err = lib.cask_lell_round_f16(y.data_ptr(), out.data_ptr(), m, stream)
        raise_on(lib, err, "lell_spmv round")
        lell_spmv.launches += 1
    return out


lell_lane_sums.launches = 0  # kernel launches since the last reset
lell_spmv.launches = 0
