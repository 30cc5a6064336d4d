"""LELL group sums: the hand-written CUDA kernel, its wrapper and its plain twin.

:func:`lell_lane_sums` computes the packed part of a lane-bucketed ELL
product: for slot row ``s`` and group ``g``, the sum over the ``L`` layers
and the group's ``B = 128 / G`` lanes of ``vals · x[idx·B + b]``.  One
kernel (``csrc/lell_spmv.cu``) serves the grouped tier of a
:class:`cask_tpu_torch.ops.lell.LellMatrix` (G = ``groups``) and the hub tier
of a :class:`cask_tpu_torch.ops.lell.ChunkedLell` (G = 1), as ``_lell_call``
serves both in the reference.  On a CUDA tensor it launches the kernel or
raises; on a CPU tensor it runs :func:`lell_lane_sums_reference`.  It
replaces ``cask_tpu/ops/pallas/lell_kernels.py:lell_spmv_pallas`` and
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

import torch

from cask_tpu_torch.ops.kernels.bdia_kernels import (_out_dtype, bind, check_types, entry,
                                                     raise_on)

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


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return bind("lell_spmv", "cask_lell_spmv", [p, p, p, p, i, ll, i, ll, p], spmm=False)


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
    if vals.device != x.device or idx.device != x.device:
        raise ValueError(f"x on {x.device} but the plan on {vals.device}")
    if x.ndim != 1:
        raise ValueError(f"x must be 1-D, got shape {tuple(x.shape)}")
    check_types(vals.dtype, x.dtype)
    if vals.ndim != 3 or vals.shape[2] != _LANE or idx.shape != vals.shape \
            or idx.dtype != torch.int32:
        raise ValueError(f"vals {tuple(vals.shape)} / idx {tuple(idx.shape)} {idx.dtype} "
                         f"are not the LELL packing (L, S_pad, 128) with int32 indices")
    if not (x.is_contiguous() and vals.is_contiguous() and idx.is_contiguous()):
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


lell_lane_sums.launches = 0  # kernel launches since the last reset
