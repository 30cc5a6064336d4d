"""Unpreconditioned CG's vector updates in two fused passes: the hand-written
CUDA kernels of ``csrc/cg_vector.cu``, their wrappers and their plain twins.

:func:`cg_update_xr` forms ``alpha = rz / pAp``, updates ``x += alpha·p`` and
``r -= alpha·ap`` in place and returns ``r·r`` as a 0-d tensor;
:func:`cg_update_p` forms ``beta = rz_new / rz`` and updates ``p = r + beta·p``
in place.  On CUDA tensors they launch the kernels or raise; on CPU tensors
they run :func:`cg_update_xr_reference` and :func:`cg_update_p_reference`,
the lines of :func:`cask_tpu_torch.solvers.cg` for ``M = None``, in place.

They replace no TPU kernel: the reference's ``lax.while_loop`` leaves these
element-wise operations to XLA, which fuses them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cask_tpu_torch.ops.kernels import build
from cask_tpu_torch.ops.kernels.bdia_kernels import raise_on

_NAMES = {torch.float32: "f32", torch.float64: "f64"}


def cg_update_xr_reference(x: torch.Tensor, p: torch.Tensor, r: torch.Tensor,
                           ap: torch.Tensor, rz: torch.Tensor, pap: torch.Tensor) -> torch.Tensor:
    """``x += alpha·p``, ``r -= alpha·ap`` in place, ``alpha = rz / pap``;
    returns ``vdot(r, r)``: the rounding of ``x + alpha * p``, ``r - alpha * ap``
    and ``torch.vdot``, on any device."""
    alpha = rz / pap
    x += alpha * p
    r -= alpha * ap
    return torch.vdot(r, r)


def cg_update_p_reference(p: torch.Tensor, r: torch.Tensor, rz_new: torch.Tensor,
                          rz: torch.Tensor) -> None:
    """``p = r + beta·p`` in place, ``beta = rz_new / rz``: the rounding of
    ``r + beta * p``, on any device."""
    beta = rz_new / rz
    p.mul_(beta).add_(r)


def fusable(*vectors: torch.Tensor) -> bool:
    """Do the kernels take these vectors?  Real f32 or f64, one dtype, one
    device, 1-D, one length, contiguous."""
    v0 = vectors[0]
    return all(isinstance(v, torch.Tensor) and v.dtype == v0.dtype and v.device == v0.device
               and v.ndim == 1 and v.shape == v0.shape and v.is_contiguous()
               for v in vectors) and v0.dtype in _NAMES


def _span(t: torch.Tensor) -> tuple:
    """The bytes a contiguous tensor's elements take: [start, end)."""
    return t.data_ptr(), t.data_ptr() + t.numel() * t.element_size()


def _check(vectors: dict, scalars: dict, written: tuple) -> None:
    """Raise on anything the kernels do not take: see :func:`fusable`; the
    scalars 0-d of the same dtype and device; a written vector overlapping
    the memory of any other operand, vector or scalar, in any byte (the
    kernels' pointers are ``__restrict__``)."""
    if not fusable(*vectors.values()):
        raise ValueError("the CG kernels need contiguous 1-D f32 or f64 vectors of one dtype, "
                         "device and length, got " + ", ".join(
                             f"{k} {tuple(v.shape)} {v.dtype} {v.device}"
                             for k, v in vectors.items()))
    v0 = next(iter(vectors.values()))
    for k, s in scalars.items():
        if s.ndim != 0 or s.dtype != v0.dtype or s.device != v0.device:
            raise ValueError(f"{k} must be a 0-d {v0.dtype} tensor on {v0.device}, got "
                             f"{tuple(s.shape)} {s.dtype} {s.device}")
    operands = {**vectors, **scalars}
    for k in written:
        lo, hi = _span(vectors[k])
        for j, v in operands.items():
            j_lo, j_hi = _span(v)
            if j != k and lo < j_hi and j_lo < hi:
                raise ValueError(f"{k} is updated in place and must not overlap {j}")


def _vec(*vectors: torch.Tensor) -> int:
    """1 where every vector starts 16-byte aligned (the kernels' vector loads)."""
    return int(all(v.data_ptr() % 16 == 0 for v in vectors))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    p, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib = build.load("cg_vector")
    for t in _NAMES.values():
        fn = getattr(lib, f"cask_cg_update_xr_{t}")
        fn.argtypes = [p, p, p, p, p, p, p, p, ll, p, ll, i, p]
        fn.restype = i
        fn = getattr(lib, f"cask_cg_update_p_{t}")
        fn.argtypes = [p, p, p, p, ll, ll, i, p]
        fn.restype = i
    lib.cask_cuda_error_string.argtypes = [i]
    lib.cask_cuda_error_string.restype = ctypes.c_char_p
    return lib


# The most blocks a launch takes, this many an SM: one tile (16 KB of each
# vector) a block up to 2.2 GB vectors on 132 SMs, past that more than one.
# The xr kernel keeps one partial sum a block (1.1 MB of slots).
BLOCKS_PER_SM = 1024


@functools.lru_cache(maxsize=None)
def _max_blocks(device: torch.device) -> int:
    return BLOCKS_PER_SM * torch.cuda.get_device_properties(device).multi_processor_count


def cg_update_xr(x: torch.Tensor, p: torch.Tensor, r: torch.Tensor, ap: torch.Tensor,
                 rz: torch.Tensor, pap: torch.Tensor) -> torch.Tensor:
    """``x += alpha·p``, ``r -= alpha·ap`` in place, ``alpha = rz / pap``;
    returns ``rz_new = r·r`` (0-d): the kernel for CUDA tensors (one pass,
    the sum in a fixed order), the plain twin for CPU tensors.  Raises on
    what the kernel does not take."""
    _check({"x": x, "p": p, "r": r, "ap": ap}, {"rz": rz, "pap": pap}, ("x", "r"))
    if not x.is_cuda:
        return cg_update_xr_reference(x, p, r, ap, rz, pap)
    rz_new = torch.empty((), dtype=x.dtype, device=x.device)
    lib = _lib()
    fn = getattr(lib, f"cask_cg_update_xr_{_NAMES[x.dtype]}")
    blocks = _max_blocks(x.device)
    # the per-block partial sums (f64 slots; an f32 partial takes half of
    # one) and, in the last slot, the last-block counter, which the C side
    # zeroes on the stream before the launch: a launch's own, from the
    # caching allocator, so launches on other streams share nothing
    work = torch.empty(blocks + 1, dtype=torch.float64, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), p.data_ptr(), r.data_ptr(), ap.data_ptr(), rz.data_ptr(),
                 pap.data_ptr(), work.data_ptr(), work[blocks:].data_ptr(), blocks,
                 rz_new.data_ptr(), x.numel(), _vec(x, p, r, ap), stream)
    raise_on(lib, err, "cg_update_xr")
    cg_update_xr.launches += 1
    return rz_new


def cg_update_p(p: torch.Tensor, r: torch.Tensor, rz_new: torch.Tensor,
                rz: torch.Tensor) -> None:
    """``p = r + beta·p`` in place, ``beta = rz_new / rz``: the kernel for CUDA
    tensors, the plain twin for CPU tensors.  Raises on what the kernel does
    not take."""
    _check({"p": p, "r": r}, {"rz_new": rz_new, "rz": rz}, ("p",))
    if not p.is_cuda:
        cg_update_p_reference(p, r, rz_new, rz)
        return
    lib = _lib()
    fn = getattr(lib, f"cask_cg_update_p_{_NAMES[p.dtype]}")
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream(p.device).cuda_stream
        err = fn(p.data_ptr(), r.data_ptr(), rz_new.data_ptr(), rz.data_ptr(),
                 _max_blocks(p.device), p.numel(), _vec(p, r), stream)
    raise_on(lib, err, "cg_update_p")
    cg_update_p.launches += 1


cg_update_xr.launches = 0  # kernel launches since the last reset
cg_update_p.launches = 0
