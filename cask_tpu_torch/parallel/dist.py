"""Multi-device SpMV/SpMM over ``torch.distributed``, one shard a rank.

The PyTorch counterpart of :mod:`cask_tpu.parallel.dist`.  Each rank holds
its shard of a partition (:mod:`cask_tpu_torch.parallel.partition`) on its
device and runs the per-shard program; the exchanges are the collectives of
:mod:`cask_tpu_torch.parallel.mesh`.  Every program is written so that the
bulk of the local compute does not depend on the exchange's result:

    pending   = exchange(edge slices)          # issued first
    y         = interior(local values, local x) # the shard's kernel
    left, right = pending.wait()
    y         = y + fixup(halo)                # tiny edge correction

With ``overlap=True`` the exchange is issued before the interior and
waited on after it (NCCL runs it on its own stream); with
``overlap=False`` the program waits before the interior, which is the
reference's ``optimization_barrier``: the time between the two is the
exchange the overlap hides.

The shard interiors are the port's CUDA kernels: BDIA SpMV (``"fused"``
and ``"pallas"``, both the kernel of ``csrc/bdia_spmv.cu``, which stands in
for both TPU kernels), DIA SpMV (``"pallas"``), the slab SpMM
(``mm_interior="slab"``) and POH SpMV and SpMM.  ``"plain"`` is the plain
PyTorch formulation (the reference's ``"xla"``).  On the CPU every wrapper
runs its plain twin, because the tensors lie there.

Not ported: ``operands`` and ``padded_op_with``, the reference's way to
pass its plans through a jitted loop as arguments (a TPU compile-request
limit).  A torch loop calls :attr:`DistSpmv.padded_op` directly.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from cask_tpu_torch.formats.matrix import to_device, torch_dtype
from cask_tpu_torch.ops.bdia import BdiaMatrix
from cask_tpu_torch.ops.dia import DiaMatrix
from cask_tpu_torch.ops.kernels.bdia_kernels import (bdia_kernel_ok, bdia_spmm_ring_reference,
                                                     bdia_spmv, bdia_spmv_reference)
from cask_tpu_torch.ops.kernels.dia_kernels import (dia_spmm_reference, dia_spmv,
                                                    dia_spmv_reference)
from cask_tpu_torch.ops.poh import PohMatrix
from cask_tpu_torch.parallel.mesh import Mesh2D, Pending, RowMesh, mesh_2d, row_mesh
from cask_tpu_torch.parallel.partition import (BdiaPartition, BdiaRankShard, Coo2DPartition,
                                               CooPartition, DiaPartition, PohPartition)
from cask_tpu_torch.utils.profiling import annotate

_WARN_BYTES = 64 * 1024 * 1024  # a gathered global y above this warns
_SLAB_GS = (16, 8, 4)  # slab tile sizes, largest first (the reference's order)
_BDIA = (BdiaPartition, BdiaRankShard)  # the block-row plans: every shard, or this rank's


class ShardOperator:
    """``v → A·v`` on this rank's padded shard of a distributed operator.
    ``mesh`` is the axis over which the shards of a vector sum: the Krylov
    solvers reduce their inner products and norms over it.  It has no
    ``shape``, so the solvers take it as an operator and not as a matrix;
    ``spmv(op, v)`` and ``spmm(op, V)`` apply it."""

    def __init__(self, apply: Callable, mesh: RowMesh):
        self._apply = apply
        self.mesh = mesh

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return self._apply(v)


# ---------------------------------------------------------------------------
# shards on the rank's device
# ---------------------------------------------------------------------------


def _take(a: np.ndarray, p: int, device, dtype=None) -> torch.Tensor:
    return to_device(a[p], device, dtype)


@dataclasses.dataclass
class _CooShard:
    int_data: torch.Tensor
    int_row: torch.Tensor  # int64
    int_col: torch.Tensor
    ext_data: torch.Tensor
    ext_row: torch.Tensor
    ext_col: torch.Tensor
    mloc: int

    @classmethod
    def of(cls, plan: CooPartition, p: int, device) -> "_CooShard":
        return cls(*(_take(getattr(plan, f), p, device, torch.int64 if f[4:] != "data" else None)
                     for f in ("int_data", "int_row", "int_col", "ext_data", "ext_row",
                               "ext_col")), mloc=plan.mloc)


def _segment_sum(data, row, col, x, m: int) -> torch.Tensor:
    prod = data * x[col] if x.ndim == 1 else data[:, None] * x[col]
    return prod.new_zeros((m,) + tuple(prod.shape[1:])).index_add_(0, row, prod)


def _coo_apply(sh: _CooShard, x, gather: Pending) -> torch.Tensor:
    """Interior (local x) plus exterior (the gathered x, waited for after the
    interior) of a COO shard."""
    y = _segment_sum(sh.int_data, sh.int_row, sh.int_col, x, sh.mloc)
    return y + _segment_sum(sh.ext_data, sh.ext_row, sh.ext_col, gather.wait(), sh.mloc)


def _empty_rem(vals: torch.Tensor):
    zi = torch.zeros(0, dtype=torch.int32, device=vals.device)
    return dict(rem_data=vals.new_zeros(0), rem_row=zi, rem_col=zi)


def _bdia_shard_matrix(plan, vals: torch.Tensor) -> BdiaMatrix:
    """A shard's local (mloc × mloc) BdiaMatrix (no remainder: that rides the
    embedded CooPartition)."""
    return BdiaMatrix(vals=vals, **_empty_rem(vals), block_offsets=plan.block_offsets,
                      shape=(plan.mloc, plan.mloc), blocksize=plan.blocksize, ts=plan.ts)


def _bdia_shard_meta(plan) -> BdiaMatrix:
    """The shard matrix of a :class:`BdiaPartition` or a
    :class:`BdiaRankShard` on the ``meta`` device: lets the interior gates
    run without moving any values."""
    vals = torch.empty(plan.vals.shape[-5:], dtype=torch_dtype(plan.vals.dtype), device="meta")
    return _bdia_shard_matrix(plan, vals)


def slab_choice(plan) -> Tuple[Optional[int], Optional[int]]:
    """``(g, bytes)``: the largest slab tile size ``g`` the shard geometry
    admits whose per-shard slab pack stays under
    :data:`cask_tpu_torch.ops.bdia_slab.SLAB_MAX_BYTES`, and that pack's
    bytes; ``(None, bytes)`` with the smallest admitted pack's bytes when
    every one is over the cap, ``(None, None)`` when none is admitted."""
    from cask_tpu_torch.ops import bdia_slab

    meta = _bdia_shard_meta(plan)
    br, bc = plan.blocksize
    nfar = sum(1 for d in plan.block_offsets if abs(d) > 1)
    smallest = None
    for g in _SLAB_GS:
        if not bdia_slab.bdia_slab_ok(meta, g):
            continue
        nbytes = meta.nb_pad * br * (2 * bc + g * bc * (1 + nfar)) * meta.vals.element_size()
        if nbytes <= bdia_slab.SLAB_MAX_BYTES:
            return g, nbytes
        smallest = nbytes if smallest is None else min(smallest, nbytes)
    return None, smallest


def _slab_refusal(plan, nbytes: Optional[int]) -> str:
    from cask_tpu_torch.ops import bdia_slab

    if nbytes is None:
        return "no slab tile size fits the shard geometry (bdia_slab_ok)"
    return (f"each shard's slab pack would take {nbytes} bytes, over the cap "
            f"SLAB_MAX_BYTES = {bdia_slab.SLAB_MAX_BYTES}")


def resolve_interiors(plan, device, interior: str = "auto",
                      mm_interior: str = "auto") -> Tuple[str, str]:
    """The SpMV and SpMM interiors a :class:`DistSpmv` of ``plan`` runs on
    ``device``, as the reference resolves them, with the slab under its
    byte cap (``'auto'`` never survives).  Raises ``ValueError`` for an
    interior the plan's geometry does not admit."""
    on_card = torch.device(device).type == "cuda"
    if isinstance(plan, DiaPartition):
        interior = "plain" if interior == "auto" else interior
        if interior not in ("plain", "pallas"):
            raise ValueError(f"unknown DIA interior {interior!r} (plain or pallas)")
        if interior == "pallas" and plan.mloc % 8192:
            raise ValueError("interior='pallas' needs partition_dia(..., align=8192)")
    elif isinstance(plan, _BDIA):
        ok = bdia_kernel_ok(_bdia_shard_meta(plan))
        if interior == "auto":
            interior = "fused" if on_card and ok else "plain"
        if interior not in ("plain", "fused", "pallas"):
            raise ValueError(f"unknown BDIA interior {interior!r} (plain, fused or pallas)")
        if interior != "plain" and not ok:
            raise ValueError(f"interior={interior!r} needs a shard the BDIA kernel takes "
                             f"(at most 80 (c, d) pairs, f32/f64/bf16/f16 values); this "
                             f"one has {plan.npairs} pairs of {plan.vals.dtype}")
    else:
        own = "poh" if isinstance(plan, PohPartition) else "plain"
        if interior not in ("auto", own):
            raise ValueError(f"a {type(plan).__name__} has one interior, {own!r}")
        interior = own
    if isinstance(plan, _BDIA):
        if mm_interior == "auto":
            g, _ = slab_choice(plan)
            mm_interior = "slab" if on_card and g is not None else "plain"
        elif mm_interior == "slab":
            g, nbytes = slab_choice(plan)
            if g is None:
                raise ValueError("mm_interior='slab' refused: " + _slab_refusal(plan, nbytes))
        elif mm_interior != "plain":
            raise ValueError(f"unknown BDIA SpMM interior {mm_interior!r} (plain or slab)")
    elif mm_interior == "slab":
        raise ValueError("mm_interior='slab' needs a BdiaPartition or a BdiaRankShard")
    elif mm_interior not in ("auto", "plain"):
        raise ValueError(f"unknown SpMM interior {mm_interior!r}")
    else:
        mm_interior = "plain"
    return interior, mm_interior


# ---------------------------------------------------------------------------
# per-shard programs
# ---------------------------------------------------------------------------


def _start(mesh: RowMesh, x, lo: int, hi: int, rem) -> Tuple[Pending, Optional[Pending]]:
    """Issue the ring exchange and, for a remainder, the all-gather."""
    return mesh.ring_halo(x, lo, hi), (mesh.all_gather(x) if rem is not None else None)


def _settle(halo: Pending, gather: Optional[Pending]) -> None:
    halo.wait()
    if gather is not None:
        gather.wait()


def _add_edges(y, head, tail, mloc: int):
    if head is not None:
        y[: head.shape[0]] += head.to(y.dtype)
    if tail is not None:
        y[mloc - tail.shape[0]:] += tail.to(y.dtype)
    return y


def _with_remainder(y, rem, x, gather):
    if rem is None:
        return y
    return y + _coo_apply(rem, x, gather).to(y.dtype)


def _dia_edges(y, a: DiaMatrix, left, right, lo: int, hi: int):
    """Add the per-offset edge terms the zero-padded interior left out to the
    first ``lo`` and last ``hi`` rows of ``y``, once the halo has landed."""
    mloc = y.shape[0]
    for d, off in enumerate(a.offsets):
        if off < 0 and lo:
            v = a.vals[d, :-off]
            y[:-off] += (v if y.ndim == 1 else v[:, None]) * left[lo + off: lo]
        elif off > 0 and hi:
            v = a.vals[d, mloc - off:]
            y[mloc - off:] += (v if y.ndim == 1 else v[:, None]) * right[:off]
    return y


def _bdia_edge_fixups(sh, left, right):
    """Component-plane halo corrections (head, tail) as natural-order deltas
    of the first ``lo_b·br`` / last ``hi_b·br`` scalar rows.  ``head_vals`` and
    ``tail_vals`` are zero wherever the zero-padded interior already covered
    the term, so each pair's window FMA adds exactly the out-of-shard part."""
    br, bc = sh.blocksize
    lo_b, hi_b = sh.lo_b, sh.hi_b
    head_nat = tail_nat = None
    if lo_b and left is not None:
        rest = tuple(left.shape[1:])
        acc = torch.promote_types(sh.head_vals.dtype, left.dtype)
        lp = left.reshape((lo_b, bc) + rest).movedim(1, 0)  # (bc, lo_b[, k])
        lpad = torch.cat([lp, lp.new_zeros(lp.shape)], dim=1)  # reads past it hit zeroed vals
        head = torch.zeros((br, lo_b) + rest, dtype=acc, device=left.device)
        for j, (c, d) in enumerate(sh.pairs):
            if d >= 0:
                continue
            w = sh.head_vals[:, j, :, None] if rest else sh.head_vals[:, j, :]
            head = head + w * lpad[c, lo_b + d: 2 * lo_b + d]
        head_nat = head.movedim(0, 1).reshape((lo_b * br,) + rest)
    if hi_b and right is not None:
        rest = tuple(right.shape[1:])
        acc = torch.promote_types(sh.tail_vals.dtype, right.dtype)
        rp = right.reshape((hi_b, bc) + rest).movedim(1, 0)
        rpad = torch.cat([rp.new_zeros(rp.shape), rp], dim=1)
        tail = torch.zeros((br, hi_b) + rest, dtype=acc, device=right.device)
        for j, (c, d) in enumerate(sh.pairs):
            if d <= 0:
                continue
            w = sh.tail_vals[:, j, :, None] if rest else sh.tail_vals[:, j, :]
            tail = tail + w * rpad[c, d: d + hi_b]
        tail_nat = tail.movedim(0, 1).reshape((hi_b * br,) + rest)
    return head_nat, tail_nat


@dataclasses.dataclass
class _DiaShard:
    local: DiaMatrix
    rem: Optional[_CooShard]
    lo: int
    hi: int


def _dia_local(sh: _DiaShard, x, mesh: RowMesh, interior: str, overlap: bool):
    a = sh.local
    halo, gather = _start(mesh, x, sh.lo, sh.hi, sh.rem)
    if not overlap:
        _settle(halo, gather)
    # interior: shifted FMAs against zero-padded local x, no halo dependence
    # (the SpMM interior is plain, as the reference's)
    if x.ndim == 2:
        y = dia_spmm_reference(a, x)
    else:
        y = dia_spmv(a, x) if interior == "pallas" else dia_spmv_reference(a, x)
    left, right = halo.wait()
    return _with_remainder(_dia_edges(y, a, left, right, sh.lo, sh.hi), sh.rem, x, gather)


@dataclasses.dataclass
class _BdiaShard:
    local: BdiaMatrix
    head_vals: torch.Tensor  # (br, npairs, max(lo_b, 1))
    tail_vals: torch.Tensor
    rem: Optional[_CooShard]
    slabs: object  # BdiaSlabs of the shard for the slab SpMM interior, or None
    lo_b: int
    hi_b: int

    @property
    def blocksize(self):
        return self.local.blocksize

    @property
    def pairs(self):
        return self.local.pairs


def _bdia_local(sh: _BdiaShard, x, mesh: RowMesh, interior: str, mm_interior: str,
                overlap: bool):
    """Ring halo + collective-free interior + edge fix-ups.  The interior
    reads zero-padded local x (pairs reaching past the shard read zeros, with
    no halo dependence): for SpMM the slab kernel on the shard's pre-sheared
    slabs, or the plain sum over the packed pairs.  Spans: ``dist.exchange``
    (the exchange issued; without overlap, also waited for),
    ``dist.interior``, ``dist.fixup`` (the wait, the edge terms and the
    remainder)."""
    bc, mloc = sh.blocksize[1], sh.local.shape[0]
    with annotate("dist.exchange"):
        halo, gather = _start(mesh, x, sh.lo_b * bc, sh.hi_b * bc, sh.rem)
        if not overlap:
            _settle(halo, gather)
    with annotate("dist.interior"):
        if x.ndim == 1:
            y = bdia_spmv_reference(sh.local, x) if interior == "plain" \
                else bdia_spmv(sh.local, x)
        elif mm_interior == "slab":
            from cask_tpu_torch.ops.kernels.bdia_slab_kernels import bdia_spmm_slab

            y = bdia_spmm_slab(sh.slabs, x)
        else:
            y = bdia_spmm_ring_reference(sh.local, x)
    with annotate("dist.fixup"):
        left, right = halo.wait()
        head, tail = _bdia_edge_fixups(sh, left, right)
        return _with_remainder(_add_edges(y, head, tail, mloc), sh.rem, x, gather)


def _poh_local(sh, x, mesh: RowMesh, overlap: bool):
    """The interior pack runs collective-free; the exterior pack consumes the
    all-gathered x.  Both are the POH kernel (SpMV or SpMM)."""
    int_m, ext_m = sh
    gather = mesh.all_gather(x)
    if not overlap:
        gather.wait()
    if x.ndim == 2:
        return int_m.spmm(x) + ext_m.spmm(gather.wait())
    return int_m.spmv(x) + ext_m.spmv(gather.wait())


def _coo_local(sh: _CooShard, x, mesh: RowMesh, overlap: bool):
    """Interior/exterior split: the interior is independent of the gather."""
    gather = mesh.all_gather(x)
    if not overlap:
        gather.wait()
    return _coo_apply(sh, x, gather)


def _poh_shard(plan: PohPartition, p: int, device, pfx: str, n: int) -> PohMatrix:
    g = {f: _take(getattr(plan, f"{pfx}_{f}"), p, device)
         for f in ("vals", "cloc", "rloc", "wlo", "whi", "panel", "first", "last")}
    return PohMatrix(**g, shape=(plan.mloc, n), row_panel=plan.row_panel,
                     col_window=plan.col_window)


# ---------------------------------------------------------------------------
# user-facing executors
# ---------------------------------------------------------------------------


class DistSpmv:
    """A partitioned matrix bound to a mesh of ranks; callable on global
    vectors.

    ``DistSpmv(plan, mesh)(x)`` takes a global ``x`` (numpy or tensor, on
    every rank) and returns the global ``y`` on the rank's device.  For
    iteration (solvers), use :meth:`padded` and :attr:`padded_op`: each
    rank then keeps only its shard, with no gathers between products.
    ``plan`` is a partition of every shard, whose shard ``rank`` moves to
    the rank's device here, or a :class:`BdiaRankShard` already there.
    ``interior`` and ``mm_interior`` are resolved as
    :func:`resolve_interiors` says; an interior that resolves to the plain
    formulation on a CUDA device says so in a ``RuntimeWarning``.

    Counters: ``calls`` (products on this rank's shard) and ``halo_bytes``
    (the bytes this rank sent in ring exchanges with other ranks).
    """

    def __init__(self, plan, mesh: Optional[RowMesh] = None, *, interior: str = "auto",
                 overlap: bool = True, mm_interior: str = "auto"):
        if isinstance(plan, Coo2DPartition):
            raise TypeError("a Coo2DPartition runs on Dist2DSpmv")
        self.plan = plan
        self.mesh = mesh if mesh is not None else row_mesh()
        if self.mesh.size != plan.nshards:
            raise ValueError(f"plan has {plan.nshards} shards but the mesh has "
                             f"{self.mesh.size} ranks")
        dev, p = self.mesh.device, self.mesh.rank
        if isinstance(plan, BdiaRankShard) and (plan.rank != p or plan.vals.device != dev):
            raise ValueError(f"the shard of rank {plan.rank} (on {plan.vals.device}) was given "
                             f"to rank {p} (on {dev})")
        self.calls = self.halo_bytes = 0
        self._ring_rows = 0  # rows of x a product sends to the ring neighbours
        asked = (interior, mm_interior)
        self.interior, self.mm_interior = resolve_interiors(plan, dev, interior, mm_interior)
        self.overlap = overlap
        if dev.type == "cuda":
            self._say_plain(asked)

        if isinstance(plan, DiaPartition):
            vals = _take(plan.vals, p, dev)
            local = DiaMatrix(vals=vals, **_empty_rem(vals), vals_t=None, offsets=plan.offsets,
                              shape=(plan.mloc, plan.mloc))
            sh = _DiaShard(local, self._rem(plan, p, dev), plan.halo_lo, plan.halo_hi)
            self._shard = sh
            self._program = lambda x: _dia_local(sh, x, self.mesh, self.interior, overlap)
            self._ring_rows = sh.lo + sh.hi
        elif isinstance(plan, _BDIA):
            if isinstance(plan, BdiaRankShard):
                vals, head, tail = plan.vals, plan.head_vals, plan.tail_vals
            else:
                vals, head, tail = (_take(a, p, dev)
                                    for a in (plan.vals, plan.head_vals, plan.tail_vals))
            local = _bdia_shard_matrix(plan, vals)
            slabs = None
            if self.mm_interior == "slab":
                from cask_tpu_torch.ops.bdia_slab import bdia_slab_plan

                slabs = bdia_slab_plan(local, slab_choice(plan)[0])  # sheared once, here
            sh = _BdiaShard(local, head, tail, self._rem(plan, p, dev), slabs, plan.halo_lo_b,
                            plan.halo_hi_b)
            self._shard = sh
            self._program = lambda x: _bdia_local(sh, x, self.mesh, self.interior,
                                                  self.mm_interior, overlap)
            self._ring_rows = (sh.lo_b + sh.hi_b) * plan.blocksize[1]
        elif isinstance(plan, PohPartition):
            sh = (_poh_shard(plan, p, dev, "int", plan.mloc),
                  _poh_shard(plan, p, dev, "ext", plan.nshards * plan.mloc))
            self._shard = sh
            self._program = lambda x: _poh_local(sh, x, self.mesh, overlap)
        elif isinstance(plan, CooPartition):
            sh = _CooShard.of(plan, p, dev)
            self._shard = sh
            self._program = lambda x: _coo_local(sh, x, self.mesh, overlap)
        else:
            raise TypeError(f"not a partition plan: {type(plan).__name__}")
        self.padded_op = ShardOperator(self._apply, self.mesh)

    def _apply(self, x: torch.Tensor) -> torch.Tensor:
        """The per-shard program on this rank's padded ``x``, counted."""
        self.calls += 1
        if self.mesh.size > 1:
            self.halo_bytes += self._ring_rows * math.prod(x.shape[1:]) * x.element_size()
        return self._program(x)

    def _say_plain(self, asked) -> None:
        """Say where an ``auto`` interior resolved to the plain formulation on
        the card (a kernel was there to run)."""
        plan = self.plan
        if asked[0] == "auto" and self.interior == "plain" \
                and isinstance(plan, (DiaPartition,) + _BDIA):
            why = ("the DIA interior stays plain unless interior='pallas' is asked for"
                   if isinstance(plan, DiaPartition) else "the BDIA kernel does not take "
                   "this shard")
            warnings.warn(f"DistSpmv on {self.mesh.device}: SpMV interior is the plain "
                          f"formulation ({why})", RuntimeWarning, stacklevel=3)
        if asked[1] == "auto" and self.mm_interior == "plain" and isinstance(plan, _BDIA):
            warnings.warn(f"DistSpmv on {self.mesh.device}: SpMM interior is the plain "
                          f"formulation, the slab refused: "
                          f"{_slab_refusal(plan, slab_choice(plan)[1])}",
                          RuntimeWarning, stacklevel=3)

    @staticmethod
    def _rem(plan, p: int, device) -> Optional[_CooShard]:
        return None if plan.remainder is None else _CooShard.of(plan.remainder, p, device)

    @property
    def padded_n(self) -> int:
        return self.plan.nshards * self.plan.mloc

    def padded(self, x) -> torch.Tensor:
        """This rank's shard of a global vector or matrix ``x``, its rows
        padded with zeros to ``mloc``, on the rank's device."""
        return _shard_rows(x, self.mesh.rank, self.plan.mloc, self.mesh.device)

    def _unpad(self, y_shard: torch.Tensor) -> torch.Tensor:
        """The global y: every rank's shard gathered, the row padding cut."""
        _warn_replicated(y_shard, self.mesh.size, "DistSpmv", stacklevel=4)
        return self.mesh.all_gather(y_shard).wait()[: self.plan.shape[0]]

    def __call__(self, x) -> torch.Tensor:
        return self._unpad(self._apply(self.padded(x)))


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


def _shard_rows(x, p: int, rows: int, device) -> torch.Tensor:
    """Rows ``[p·rows, (p+1)·rows)`` of ``x``, zero past its end, on ``device``."""
    x = _as_tensor(x)
    lo, hi = p * rows, min((p + 1) * rows, x.shape[0])
    out = torch.zeros((rows,) + tuple(x.shape[1:]), dtype=x.dtype, device=device)
    if hi > lo:
        out[: hi - lo] = x[lo:hi].to(device)
    return out


def _warn_replicated(y_shard, ranks: int, who: str, stacklevel: int) -> None:
    nbytes = y_shard.numel() * y_shard.element_size() * ranks
    if nbytes > _WARN_BYTES:
        warnings.warn(f"{who} convenience path gathers the full {nbytes / 2**20:.0f} MB result "
                      "onto every rank to cut the row padding; at this scale use `padded_op` "
                      "with padded shards to stay distributed.", RuntimeWarning,
                      stacklevel=stacklevel)


# ---------------------------------------------------------------------------
# 2-D (SUMMA-style) executor
# ---------------------------------------------------------------------------


def _local_2d(sh, x, mesh: Mesh2D, mr: int):
    """Partial block product on one rank, summed over the grid row."""
    part = _segment_sum(*sh, x, mr)
    return mesh.cols.all_reduce(part).wait()


class Dist2DSpmv:
    """2-D block-partitioned SpMV/SpMM over a ``pr × pc`` grid of ranks.

    Each rank's x footprint is n/pc (against the 1-D plans' all-gathered
    n), and the collective of a product is a sum of y partials over the
    ranks of a grid row.
    """

    def __init__(self, plan: Coo2DPartition, mesh: Optional[Mesh2D] = None):
        if not isinstance(plan, Coo2DPartition):
            raise TypeError(f"Dist2DSpmv takes a Coo2DPartition, got {type(plan).__name__}")
        self.plan = plan
        self.mesh = mesh if mesh is not None else mesh_2d(plan.pr, plan.pc)
        if self.mesh.shape != (plan.pr, plan.pc):
            raise ValueError("mesh shape does not match the plan's pr × pc")
        r, dev = self.mesh.i * plan.pc + self.mesh.j, self.mesh.device
        self._shard = (_take(plan.data, r, dev), _take(plan.row, r, dev, torch.int64),
                       _take(plan.col, r, dev, torch.int64))
        self.padded_op = ShardOperator(self._padded_op, self.mesh.cols)

    def padded_x(self, x) -> torch.Tensor:
        """This rank's block of columns of a global ``x`` (padded to ``mc``
        rows), on its device."""
        return _shard_rows(x, self.mesh.j, self.plan.mc, self.mesh.device)

    @property
    def square_padded(self) -> bool:
        return self.plan.pr * self.plan.mr == self.plan.pc * self.plan.mc

    def _y(self, xp: torch.Tensor) -> torch.Tensor:
        """The full padded y (pr·mr rows) on this rank."""
        y_i = _local_2d(self._shard, xp, self.mesh, self.plan.mr)
        return self.mesh.rows.all_gather(y_i).wait()

    def _padded_op(self, xp: torch.Tensor) -> torch.Tensor:
        """Operator on this rank's padded x block for solver loops: y comes
        back in x's layout (block ``j`` of ``mc`` rows).  Needs the padded
        operator square (pr·mr == pc·mc)."""
        if not self.square_padded:
            raise ValueError(
                "padded_op needs pr*mr == pc*mc (square padded operator); "
                f"got {self.plan.pr}x{self.plan.mr} vs {self.plan.pc}x{self.plan.mc}")
        mc, j = self.plan.mc, self.mesh.j
        return self._y(xp)[j * mc: (j + 1) * mc]

    def __call__(self, x) -> torch.Tensor:
        xp = self.padded_x(x)
        y_i = _local_2d(self._shard, xp, self.mesh, self.plan.mr)
        _warn_replicated(y_i, self.plan.pr, "Dist2DSpmv", stacklevel=3)
        return self.mesh.rows.all_gather(y_i).wait()[: self.plan.shape[0]]
