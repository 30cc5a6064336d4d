"""BDIA SpMV and SpMM: the hand-written CUDA kernels, their wrappers and their
plain twins.

:func:`bdia_spmv` computes the packed block diagonals' part of ``A·x`` for
a :class:`cask_tpu_torch.ops.bdia.BdiaMatrix` (the COO remainder is added
by the caller, as in the JAX package).  On a CUDA tensor it launches the
kernel of ``csrc/bdia_spmv.cu`` or raises; on a CPU tensor it runs
:func:`bdia_spmv_reference`, the same sum in plain PyTorch.  One kernel
stands in for both TPU kernels of the path,
``cask_tpu/ops/pallas/bdia_kernels.py:bdia_spmv_pallas_fused`` and
``:bdia_spmv_pallas_resident``: on Hopper, natural-order vectors need no
relayout, so the solver layout is the natural one.

:func:`bdia_spmm_ring` is the SpMM of the same packed values, ``A·X`` for a
dense ``X (n, k)``: the kernel of ``csrc/bdia_spmm.cu`` on CUDA tensors,
:func:`bdia_spmm_ring_reference` on CPU tensors.  It replaces
``bdia_kernels.py:bdia_spmm_pallas_ring`` (B4), whose 4-bank VMEM ring of
component strips has no counterpart: Hopper reads natural-order X rows,
each once per warp's block rows and chunk of consecutive block offsets,
into a register window.
"""

from __future__ import annotations

import ctypes
import functools
from typing import TYPE_CHECKING

import torch

from cask_tpu_torch.formats.matrix import torch_dtype
from cask_tpu_torch.ops.kernels import build

if TYPE_CHECKING:
    from cask_tpu_torch.ops.bdia import BdiaMatrix

_LANE = 128
MAX_PAIRS = 80  # (d, c) slots a plan may hold for the kernel (kMaxDiags)
_KERNEL_DTYPES = (torch.float32, torch.float64)  # values and operand of one type
# the half types every kernel takes on its half path: values and operand each
# H or f32, at least one H, summed in f32 (the reference's value types)
HALVES = (torch.bfloat16, torch.float16)
VALUE_DTYPES = (*_KERNEL_DTYPES, *HALVES)  # a plan's value types the kernels take
_NAMES = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16",
          torch.float16: "f16"}


def _out_dtype(vals_dtype: torch.dtype, x_dtype: torch.dtype) -> torch.dtype:
    """``promote(values, operand)``, with bf16 promoted to f32: the SpMV
    output type of the block and banded kernels and LELL's (the reference's
    ``bdia_kernels.py:84-86``, ``lell_kernels.py:_out_dtype``: f16 values and
    operand give f16, f16 with f32 gives f32)."""
    acc = torch.promote_types(vals_dtype, x_dtype)
    if torch.bfloat16 in (vals_dtype, x_dtype):
        acc = torch.promote_types(acc, torch.float32)
    return acc


def _half(vals_dtype: torch.dtype, x_dtype: torch.dtype):
    """The half type of a half-path combination, else None."""
    return next((h for h in HALVES if h in (vals_dtype, x_dtype)), None)


def kernel_types_ok(vals_dtype: torch.dtype, x_dtype: torch.dtype) -> bool:
    """Do the kernels take these value and operand types?  One f32 or f64
    type, or one half type H (bf16 or f16) with H or f32, at least one H
    (summed in f32)."""
    if vals_dtype in _KERNEL_DTYPES and x_dtype == vals_dtype:
        return True
    h = _half(vals_dtype, x_dtype)
    return h is not None and {vals_dtype, x_dtype} <= {h, torch.float32}


def _type_error(vals_dtype, x_dtype, out=None) -> TypeError:
    got = f"values {vals_dtype}, operand {x_dtype}" + ("" if out is None else f", out {out}")
    return TypeError(f"the kernels take float32/float64 values and operand of one type (SpMM "
                     f"out of that type or float64), or bfloat16 or float16 values or operand "
                     f"with the other of the same half type or float32 (SpMM out float32 or "
                     f"that half type); got {got}")


def check_types(vals_dtype: torch.dtype, x_dtype: torch.dtype) -> None:
    """Raise ``TypeError``, naming the combination, unless the kernels take
    these value and operand types (:func:`kernel_types_ok`)."""
    if not kernel_types_ok(vals_dtype, x_dtype):
        raise _type_error(vals_dtype, x_dtype)


def entry(prefix: str, vals_dtype: torch.dtype, x_dtype: torch.dtype, out=None) -> str:
    """The C entry point of a type combination: ``<prefix>_f32`` /
    ``_f64`` (and ``_f32_f64`` for f64 sums) for one f32/f64 type, else
    ``<prefix>_<values>_<operand>`` with ``_<out>`` for SpMM."""
    if vals_dtype == x_dtype and vals_dtype in _KERNEL_DTYPES:
        tail = "" if out in (None, vals_dtype) else f"_{_NAMES[out]}"
        return f"{prefix}_{_NAMES[vals_dtype]}{tail}"
    tail = "" if out is None else f"_{_NAMES[out]}"
    return f"{prefix}_{_NAMES[vals_dtype]}_{_NAMES[x_dtype]}{tail}"


def entries(prefix: str, spmm: bool, f64_sums: bool = False):
    """Every C entry point of a kernel source, as :func:`entry` names them
    (``f64_sums``: it has the f32-in, f64-out SpMM entry; ``spmm``: its half
    entries name their output, f32 or the half type)."""
    names = {entry(prefix, t, t) for t in _KERNEL_DTYPES}
    if f64_sums:
        names.add(entry(prefix, torch.float32, torch.float32, torch.float64))
    for h in HALVES:
        path = (h, torch.float32)
        for v in path:
            for x in path:
                if h in (v, x):
                    outs = path[::-1] if spmm else (None,)
                    names.update(entry(prefix, v, x, o) for o in outs)
    return sorted(names)


def bdia_spmv_reference(a: "BdiaMatrix", x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``Σ_j vals[:, j] · x-shift`` over the packed pairs, in
    pair order: the port of ``BdiaMatrix._spmv_xla`` without its remainder.
    Summed in ``promote(out, f32)`` and rounded once to the output type
    :func:`_out_dtype` (f16 for f16 values and x), as the kernel sums.

    Works on any device; the CUDA kernel is held against it."""
    br, bc = a.blocksize
    m, n = a.shape
    nbr, nbc, lo, hi = a.nbr, a.nbc, a.lo, a.hi
    T, plane = a.n_tiles, a.ts * _LANE
    out = _out_dtype(a.vals.dtype, x.dtype)
    acc = torch.promote_types(out, torch.float32)
    xn = x.new_zeros(nbc * bc)
    xn[:n] = x
    # component rows x_c[i] = x[i·bc + c], zero outside [0, nbc): every
    # shifted window [lo + d, lo + d + T·plane) stays inside
    xp = x.new_zeros((bc, lo + max(nbc, T * plane) + hi + 1))
    xp[:, lo : lo + nbc] = xn.reshape(nbc, bc).T
    vt = a.vals.reshape(br, T, a.npairs, plane)
    y = torch.zeros((br, T, plane), dtype=acc, device=x.device)
    for j, (c, d) in enumerate(a.pairs):
        xs = xp[c, lo + d : lo + d + T * plane].reshape(T, plane)
        y += vt[:, :, j, :].to(acc) * xs.to(acc)
    return y.reshape(br, T * plane)[:, :nbr].T.reshape(-1)[:m].to(out)


def bdia_kernel_ok(a: "BdiaMatrix") -> bool:
    """Can the CUDA kernel take this plan (pair count and value type)?"""
    return a.npairs <= MAX_PAIRS and a.vals.dtype in VALUE_DTYPES


def result_dtype(vals_dtype: torch.dtype, x_dtype: torch.dtype, out=None) -> torch.dtype:
    """The SpMM entries' output type: ``out`` when given, else the
    promotion of values and X, bf16 promoted to f32 (the reference's
    policy, ``bdia_kernels.py:619-622``: f16 for f16 values and X)."""
    return torch_dtype(out) if out is not None else _out_dtype(vals_dtype, x_dtype)


def check_out_dtype(vals_dtype: torch.dtype, x_dtype: torch.dtype, out: torch.dtype) -> None:
    """Raise ``TypeError``, naming the combination, unless an SpMM kernel
    takes these types: f32 or f64 values and X of one type, out of the same
    type or f64 (``accum_dtype=float64``); or half values or X (bf16 or
    f16) with the other of the same half type or f32, out f32 or that half
    type (the fully-half chain)."""
    if not kernel_types_ok(vals_dtype, x_dtype):
        raise _type_error(vals_dtype, x_dtype, out)
    h = _half(vals_dtype, x_dtype)
    outs = (torch.float32, h) if h is not None else (vals_dtype, torch.float64)
    if out not in outs:
        raise _type_error(vals_dtype, x_dtype, out)


def raise_on(lib, err: int, name: str) -> None:
    """Raise when a kernel's launch returned a CUDA error."""
    if err != 0:
        msg = lib.cask_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err} ({msg})")


def vec_ok(k: int, *tensors: torch.Tensor) -> int:
    """1 when rows of ``k`` elements start 16-byte aligned in every tensor
    (the kernels' vector loads and stores), else 0."""
    return int(all((k * t.element_size()) % 16 == 0 and t.data_ptr() % 16 == 0
                   for t in tensors))


def bind(name: str, prefix: str, argtypes, *, spmm: bool, f64_sums: bool = False) -> ctypes.CDLL:
    """Load ``csrc/<name>.cu``'s library and give each entry point of
    :func:`entries` the argument types ``argtypes``."""
    lib = build.load(name)
    for fname in entries(prefix, spmm, f64_sums):
        fn = getattr(lib, fname)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.cask_cuda_error_string.argtypes = [ctypes.c_int]
    lib.cask_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return bind("bdia_spmv", "cask_bdia_spmv",
                [p, p, p, ctypes.POINTER(ctypes.c_int), i, i, i, ll, ll, ll, i, i, p], spmm=False)


@functools.lru_cache(maxsize=None)
def _mm_lib() -> ctypes.CDLL:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    return bind("bdia_spmm", "cask_bdia_spmm",
                [p, p, p, ctypes.POINTER(ctypes.c_int), i, i, i, ll, ll, ll, i, i, i, i, p],
                spmm=True, f64_sums=True)


def bdia_spmv(a: "BdiaMatrix", x: torch.Tensor) -> torch.Tensor:
    """``vals``-part of ``A·x``: the CUDA kernel for a CUDA ``x``, the plain
    twin for a CPU ``x``.  Raises on what the kernel does not take."""
    if not x.is_cuda:
        if a.vals.is_cuda:
            raise ValueError(f"x on {x.device} but the plan on {a.vals.device}")
        return bdia_spmv_reference(a, x)
    br, bc = a.blocksize
    m, n = a.shape
    if a.vals.device != x.device:
        raise ValueError(f"x on {x.device} but the plan on {a.vals.device}")
    if x.ndim != 1 or x.shape[0] != n:
        raise ValueError(f"x must have shape ({n},), got {tuple(x.shape)}")
    check_types(a.vals.dtype, x.dtype)
    if a.npairs > MAX_PAIRS:
        raise ValueError(f"plan has {a.npairs} (d, c) pairs; the kernel takes "
                         f"at most {MAX_PAIRS}")
    if a.vals.shape != (br, a.n_tiles, a.npairs, a.ts, _LANE):
        raise ValueError(f"vals shape {tuple(a.vals.shape)} is not the packed "
                         f"(br, T, npairs, ts, 128) layout")
    if not (x.is_contiguous() and a.vals.is_contiguous()):
        raise ValueError("kernel needs contiguous x and vals")
    y = torch.empty(m, dtype=_out_dtype(a.vals.dtype, x.dtype), device=x.device)
    if m == 0:
        return y
    lib = _lib()
    fn = getattr(lib, entry("cask_bdia_spmv", a.vals.dtype, x.dtype))
    offs = (ctypes.c_int * len(a.block_offsets))(*a.block_offsets)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(a.vals.data_ptr(), x.data_ptr(), y.data_ptr(), offs, len(a.block_offsets),
                 br, bc, m, n, a.nbr, a.n_tiles, a.ts * _LANE, stream)
    raise_on(lib, err, "bdia_spmv")
    bdia_spmv.launches += 1
    return y


bdia_spmv.launches = 0  # kernel launches since the last reset


# -- SpMM (B4) -----------------------------------------------------------------

# The reference's gate for its ring kernel (bdia_kernels.py:467-502), kept so
# that the port's k > 64 route takes the ring exactly where the reference's
# does.  The TPU picks a strip length tm that divides the padded block rows,
# covers the farthest block offset and fits VMEM; only whether one exists
# matters here (the tm itself is a TPU grid choice).  The Hopper kernel
# takes every plan the BDIA SpMV kernel takes.
_MM_TMS = (1024, 512, 256, 128)
_MM_BANKS = 4
_MM_VMEM_BUDGET = 12 * 1024 * 1024  # the reference's _SPMM_VMEM_BUDGET


def bdia_mm_ok(a: "BdiaMatrix", k: int) -> bool:
    """The reference's ``bdia_mm_ok``: at most ``MAX_PAIRS`` (c, d) pairs
    and a strip length whose ring fits the reference's VMEM budget (with
    4-byte X and Y, as the reference asks)."""
    if a.npairs > MAX_PAIRS:
        return False
    br, bc = a.blocksize
    kp = max(_LANE, -(-k // _LANE) * _LANE)
    dv = a.vals.element_size()
    for tm in _MM_TMS:
        if a.nb_pad % tm or a.lo > tm or a.hi > tm:
            continue
        need = bc * _MM_BANKS * tm * kp * 4 + (2 * br + 1) * tm * kp * 4 \
            + 2 * tm * a.npairs * dv
        if need <= _MM_VMEM_BUDGET:
            return True
    return False


def bdia_spmm_ring_reference(a: "BdiaMatrix", x: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """Plain PyTorch ``Σ_j vals[:, :, j] · X-shift`` over the packed pairs, in
    pair order: the product of ``bdia_spmm_pallas_ring`` without the
    remainder, summed in ``promote(out, f32)``.  Works on any device; the
    CUDA kernel is held against it."""
    br, bc = a.blocksize
    m, n = a.shape
    k = x.shape[1]
    nbc, lo, hi, nb_pad = a.nbc, a.lo, a.hi, a.nb_pad
    out = result_dtype(a.vals.dtype, x.dtype, out_dtype)
    acc = torch.promote_types(out, torch.float32)
    xn = x.new_zeros((nbc * bc, k))
    xn[:n] = x
    # component c's rows x_c[i] = X[i·bc + c], zero outside [0, nbc)
    xp = x.new_zeros((bc, lo + max(nbc, nb_pad) + hi + 1, k))
    xp[:, lo : lo + nbc] = xn.reshape(nbc, bc, k).transpose(0, 1)
    v = a.vals.permute(0, 1, 3, 4, 2).reshape(br, nb_pad, a.npairs)  # v[r, i, j]
    y = torch.zeros((br, nb_pad, k), dtype=acc, device=x.device)
    for j, (c, d) in enumerate(a.pairs):
        y += v[:, :, j, None].to(acc) * xp[c, lo + d : lo + d + nb_pad].to(acc)
    return y.transpose(0, 1).reshape(nb_pad * br, k)[:m].to(out)


def bdia_spmm_ring(a: "BdiaMatrix", x: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """``vals``-part of ``A·X`` for a dense row-major ``X (n, k)``: the CUDA
    kernel for a CUDA ``X``, the plain twin for a CPU ``X``.  ``out_dtype``
    as the reference's.  Raises on what the kernel does not
    take."""
    if not x.is_cuda:
        if a.vals.is_cuda:
            raise ValueError(f"X on {x.device} but the plan on {a.vals.device}")
        return bdia_spmm_ring_reference(a, x, out_dtype)
    br, bc = a.blocksize
    m, n = a.shape
    out = result_dtype(a.vals.dtype, x.dtype, out_dtype)
    if a.vals.device != x.device:
        raise ValueError(f"X on {x.device} but the plan on {a.vals.device}")
    if x.ndim != 2 or x.shape[0] != n:
        raise ValueError(f"X must have shape ({n}, k), got {tuple(x.shape)}")
    check_out_dtype(a.vals.dtype, x.dtype, out)
    if a.npairs > MAX_PAIRS:
        raise ValueError(f"plan has {a.npairs} (d, c) pairs; the kernel takes "
                         f"at most {MAX_PAIRS}")
    if a.vals.shape != (br, a.n_tiles, a.npairs, a.ts, _LANE):
        raise ValueError(f"vals shape {tuple(a.vals.shape)} is not the packed "
                         f"(br, T, npairs, ts, 128) layout")
    if not (x.is_contiguous() and a.vals.is_contiguous()):
        raise ValueError("kernel needs contiguous X and vals")
    k = int(x.shape[1])
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, k), dtype=out, device=x.device)
    y = torch.empty((m, k), dtype=out, device=x.device)
    vec = vec_ok(k, x, y)
    lib = _mm_lib()
    fn = getattr(lib, entry("cask_bdia_spmm", a.vals.dtype, x.dtype, out))
    offs = (ctypes.c_int * len(a.block_offsets))(*a.block_offsets)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(a.vals.data_ptr(), x.data_ptr(), y.data_ptr(), offs, len(a.block_offsets),
                 br, bc, m, n, a.nbr, a.n_tiles, a.ts * _LANE, k, vec, stream)
    raise_on(lib, err, "bdia_spmm_ring")
    bdia_spmm_ring.launches += 1
    return y


bdia_spmm_ring.launches = 0
