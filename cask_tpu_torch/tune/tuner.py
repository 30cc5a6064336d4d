"""Per-matrix autotuner: the JAX package's design-space search, on the card.

The PyTorch counterpart of :mod:`cask_tpu.tune.tuner`.  An analytic
byte-traffic model ranks the variants (:func:`enumerate_variants`), the
best few are built and timed on the operand's device
(:func:`cask_tpu_torch.tune.timing.measure`), and the winner is cached by
sparsity signature (:class:`cask_tpu_torch.tune.cache.TunerCache`).  The
variant names, the cache key and the entry format are the reference's, so
one cache file serves both packages.

Variants:

- ``csr_xla``, ``bsr_xla:<b>``, ``dia_xla`` (and ``rcm:dia_xla``): the
  gather formulations of ``spmv``/``spmm(method="xla")`` in plain PyTorch,
  the port's counterparts of the reference's XLA formulations; ``dia_xla``
  runs the matrix's gather product, the name kept for the cache.
- ``dia_pallas`` (and ``rcm:dia_pallas``): the DIA plan with its CUDA SpMV
  and SpMM kernels.
- ``bsr_pallas:<b>``: at SpMV the BDIA plan with its CUDA SpMV kernel; at
  k > 64 ``spmm(plan, X)``, the BDIA wide-k chain (the slab, else the
  ring), where the reference's ``bdia_mm_ok`` admits the plan; else the
  ELL-packed BSR SpMM kernel.
- ``poh[:T]``, ``poh_fast:T`` (SpMV) and ``poh_mm``, ``poh_mm_fast``: the
  POH plan with its CUDA kernels.  The port's kernels ignore the
  reference's ``precision``, so each ``_fast`` variant runs its twin's
  kernel; the names stay for the cache and ``precision="f32"``.

Variants that build one callable under two names (``dia_xla`` and
``csr_xla``, ``poh_fast:T`` and ``poh:T``, ``poh_mm_fast`` and ``poh_mm``)
are timed once a tune: the second name's entry copies the first's reading
under ``same_as`` and does not compete.
- ``lell:<g>``: the LELL plan; built by name, never enumerated (as in the
  reference).

On a CUDA operand each kernel variant runs its kernel; on a CPU operand
(the caller asked for the CPU) its plain twin.  A plan that a kernel's gate
refuses (its ``ValueError``) is recorded in the cache entry as refused; any
other error in a build or a launch propagates, and on a CUDA device so does
a non-finite product of the finite operand.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from cask_tpu_torch.formats.convert import csr_to_bsr
from cask_tpu_torch.formats.matrix import BSR, COO, CSR, torch_dtype
from cask_tpu_torch.formats.signature import Signature, signature as compute_signature
from cask_tpu_torch.ops.spmm import spmm
from cask_tpu_torch.ops.spmv import spmv
from cask_tpu_torch.tune.cache import TunerCache, default_cache
from cask_tpu_torch.tune.timing import measure
from cask_tpu_torch.utils.platform import hbm_bandwidth, plan_device

log = logging.getLogger("cask_tpu_torch.tune")

_BSR_CANDIDATES = (4, 8, 16, 32)
# csr_xla's time-equivalent bytes per entry and column of its gathers: a
# ranking term of the reference's model (tuner.py:169-176), kept for parity
_GATHER_PEN = 1000.0
_HBM_STAND_IN = 3.35e12  # bytes/s for a card missing from the bandwidth table


@dataclasses.dataclass
class Variant:
    name: str  # e.g. "csr_xla", "bsr_pallas:4", "dia_pallas"
    est_bytes: float  # analytic traffic per op application

    def build(self, a: CSR, k: Optional[int], device=None,
              plans: Optional[dict] = None) -> Tuple[object, Callable]:
        """Return (device_matrix, step_fn(x)->y) for this variant, on
        ``device`` (default: where ``a``'s tensors are, the CUDA device for
        host numpy arrays).  ``plans`` holds the plans built for ``a`` so
        far, for variants that share one (``poh:T`` and ``poh_fast:T``,
        ``bsr_xla:b`` and the BSR SpMM kernel's ``bsr_pallas:b``); ``tune``
        passes one per matrix."""
        device = plan_device(a.data, device)
        plans = {} if plans is None else plans

        def plan(key, make):
            if key not in plans:
                plans[key] = make()
            return plans[key]

        if self.name in ("csr_xla", "dia_xla"):
            dev = plan("csr", lambda: a.to(device))
            if k is None:
                return dev, lambda x: spmv(dev, x, method="xla")
            return dev, lambda x: spmm(dev, x, method="xla")
        if self.name.startswith(("bsr_xla:", "bsr_pallas:")):
            b = int(self.name.split(":")[1])
            bsr = plan(("bsr", b), lambda: csr_to_bsr(a, (b, b)))
        if self.name.startswith("bsr_xla:"):
            dev = plan(("bsr_dev", b), lambda: bsr.to(device))
            if k is None:
                return dev, lambda x: spmv(dev, x, method="xla")
            return dev, lambda x: spmm(dev, x, method="xla")
        if self.name == "dia_pallas":
            from cask_tpu_torch.ops.dia import dia_plan

            dev = plan("dia", lambda: dia_plan(a, device=device))
            return dev, (dev.spmv if k is None else dev.spmm)
        if self.name.startswith("bsr_pallas:"):
            from cask_tpu_torch.ops.bdia import bdia_plan

            if k is None or k > 64:
                bd = plan(("bdia", b), lambda: bdia_plan(bsr, device=device))
            if k is None:
                # tuned BSR SpMV: the BDIA block-diagonal kernel
                return bd, bd.spmv
            if k > 64:
                # wide-k block SpMM: the BDIA chain of spmm(plan, X)
                from cask_tpu_torch.ops.kernels.bdia_kernels import bdia_mm_ok

                if bdia_mm_ok(bd, k):
                    return bd, lambda x: spmm(bd, x)
            from cask_tpu_torch.ops.bsr_spmm import BsrSpmmKernel

            kern = plan(("bsr_spmm", b), lambda: BsrSpmmKernel.plan(bsr, k=k, device=device))
            return kern, kern.__call__
        if self.name.startswith("lell:"):
            from cask_tpu_torch.ops.lell import lell_plan_hyb

            dev = lell_plan_hyb(a, groups=int(self.name.split(":")[1]), device=device)
            return dev, dev.spmv
        if self.name.split(":")[0] in ("poh", "poh_fast", "poh_mm", "poh_mm_fast"):
            from cask_tpu_torch.ops.poh import poh_plan

            parts = self.name.split(":")
            ts = int(parts[1]) if len(parts) > 1 else 2048
            prec = "fast" if parts[0].endswith("_fast") else "split"
            dev = plan(("poh", ts), lambda: poh_plan(a, tile_slots=ts, device=device))
            if parts[0].startswith("poh_mm"):
                return dev, functools.partial(dev.spmm, precision=prec)
            return dev, functools.partial(dev.spmv, precision=prec)
        if self.name.startswith("rcm:"):
            dev, fn, _ = self.build_full(a, k, device, plans)
            return dev, fn
        raise ValueError(f"unknown variant {self.name!r}")

    def build_full(self, a: CSR, k: Optional[int], device=None,
                   plans: Optional[dict] = None) -> Tuple[object, Callable, dict]:
        """Like :meth:`build`, plus an info dict.  For ``rcm:*`` variants
        the dict carries ``perm`` (the RCM row/col permutation) and
        ``inner_fn`` (the kernel in the *reordered* space), so solver
        loops can reorder once and stay reordered instead of paying two
        boundary vector permutes per application."""
        if not self.name.startswith("rcm:"):
            dev, fn = self.build(a, k, device, plans)
            return dev, fn, {}
        from cask_tpu_torch.formats.reorder import reorder_rcm

        device = plan_device(a.data, device)
        plans = {} if plans is None else plans
        if "rcm" not in plans:  # the reordered matrix, and the plans built for it
            plans["rcm"] = (*reorder_rcm(a), {})
        a_r, perm, plans_r = plans["rcm"]
        dev, fn = Variant(self.name[4:], 0.0).build(a_r, k, device, plans_r)
        pd = torch.as_tensor(perm.astype(np.int64), device=device)
        ipd = torch.as_tensor(np.argsort(perm).astype(np.int64), device=device)
        info = {"perm": np.asarray(perm), "inner_fn": fn}
        return dev, lambda x: fn(x[pd])[ipd], info


def _same_callable(name: str) -> str:
    """The variant whose callable ``name`` builds (itself for most)."""
    base, _, ts = name.partition(":")
    if base in ("dia_xla", "poh_mm_fast"):
        return {"dia_xla": "csr_xla", "poh_mm_fast": "poh_mm"}[base]
    if base in ("poh", "poh_fast"):
        return "poh" if ts in ("", "2048") else f"poh:{ts}"
    return name


def _dtype_bytes(dt) -> int:
    return torch_dtype(dt).itemsize


def enumerate_variants(a: CSR, sig: Signature, k: Optional[int],
                       include_pallas: bool = True,
                       calib: Optional[dict] = None) -> List[Variant]:
    """Analytic traffic model per variant (reference ``tuner.py:148-264``):
    ranks candidates before any is built.

    Per SpMV/SpMM application, modeled bytes:
    - ``csr_xla``:    values+indices, plus the gathered-X and partial
      product arrays (2·nnz·k·db), plus the reference's gather penalty
    - ``bsr_xla:b``:  same shape but gathers/partials are per *block*
      (÷ b), at the cost of ``stored ≥ nnz`` block fill
    - ``dia_pallas``: streamed diagonals once (k-independent) + X/Y
    - ``bsr_pallas:b``: values once + per-block X slices (kp·db/b); at
      SpMV the BDIA split's streamed entries
    - ``poh*``: time-equivalent bytes from the calibration record
    """
    m, n = a.shape
    nnz = a.nnz
    db = _dtype_bytes(a.dtype)
    kk = k or 1
    kp = max(128, -(-kk // 128) * 128) if k else 1  # lane-padded dense width
    xbytes = (n + m) * db * kk

    gather_pen = nnz * _GATHER_PEN * kk if include_pallas else 0.0
    out: List[Variant] = [
        Variant("csr_xla", nnz * (db + 4) + 2.0 * nnz * db * kk + xbytes + gather_pen)
    ]

    for b, fill_pct in zip(Signature.BLOCK_PROBE, sig.block_fill):
        if b not in _BSR_CANDIDATES:
            continue
        fill = max(fill_pct, 1) / 100.0
        stored = nnz / fill  # entries incl. block fill
        if fill >= 0.35:
            est = stored * db + (stored / (b * b)) * 4 + 2.0 * stored * db * kk / b + xbytes
            out.append(Variant(f"bsr_xla:{b}", est))
        if include_pallas and fill >= 0.3 and k:
            est = stored * db + (stored / (b * b)) * 4 + stored * kp * db / b + m * kp * db
            out.append(Variant(f"bsr_pallas:{b}", est))
        if fill >= 0.3 and k is None:
            from cask_tpu_torch.ops.bdia import estimate_bdia_traffic

            bd = estimate_bdia_traffic(a, b)
            if bd is not None and include_pallas:
                out.append(Variant(f"bsr_pallas:{b}", bd[0] * db + 1.5 * xbytes))

    from cask_tpu_torch.ops.dia import estimate_dia_traffic

    est = estimate_dia_traffic(a)
    if est is not None:
        if include_pallas:
            out.append(Variant("dia_pallas", est * db + 1.5 * xbytes))
        out.append(Variant("dia_xla", est * db + 2.0 * xbytes))

    if calib is None:
        from cask_tpu_torch.tune.calibrate import poh_equiv_bytes

        calib = poh_equiv_bytes()
    if include_pallas and k is None and db <= 4:
        from cask_tpu_torch.tune.calibrate import poh_equiv_bytes_analytic

        for ts, names in ((2048, ("poh", "poh_fast:2048")),
                          (8192, ("poh:8192", "poh_fast:8192"))):
            eb_s = poh_equiv_bytes_analytic(m, n, nnz, ts, calib=calib)
            eb_f = poh_equiv_bytes_analytic(m, n, nnz, ts, fast=True, calib=calib)
            out.append(Variant(names[0], nnz * eb_s + xbytes))
            out.append(Variant(names[1], nnz * eb_f + xbytes))
    if include_pallas and k is not None and k <= 64 and db <= 4:
        out.append(Variant("poh_mm", nnz * calib["poh_mm"] * kk + xbytes))
        out.append(Variant("poh_mm_fast", nnz * calib["poh_mm_fast"] * kk + xbytes))

    # RCM reordering toward the banded kernels, probed only when the natural
    # ordering has no usable diagonal split and the matrix is square
    if est is None and m == n and nnz:
        from cask_tpu_torch.formats.reorder import reorder_rcm

        a_r, _ = reorder_rcm(a)
        est_r = estimate_dia_traffic(a_r)
        if est_r is not None:
            permute = 8.0 * m * db * kk  # boundary vector gathers
            if include_pallas:
                out.append(Variant("rcm:dia_pallas", est_r * db + 1.5 * xbytes + permute))
            out.append(Variant("rcm:dia_xla", est_r * db + 2.0 * xbytes + permute))
    return out


@dataclasses.dataclass
class TunedSpmv:
    """A matrix bound to its tuned kernel: the user-facing product of
    tuning."""

    variant: str
    matrix: object  # device-side matrix/plan in the winning format
    _fn: Callable
    signature_key: str
    seconds_per_op: Optional[float] = None
    # rcm:* winners only: the permutation and the reordered-space kernel
    perm: Optional[np.ndarray] = None
    _inner_fn: Optional[Callable] = None

    def __call__(self, x):
        return self._fn(x)

    @property
    def is_reordered(self) -> bool:
        return self.perm is not None

    def reordered(self) -> Tuple[Callable, np.ndarray]:
        """``(fn, perm)`` for solver loops on ``rcm:*`` winners: ``fn``
        applies the kernel in the *reordered* space (no boundary
        permutes).  Reorder the right-hand side once (``b[perm]``),
        iterate with ``fn``, and un-permute the solution once
        (``x[argsort(perm)]``)."""
        if self.perm is None:
            raise ValueError(
                f"variant {self.variant!r} is not RCM-reordered; "
                "call the TunedSpmv directly")
        return self._inner_fn, self.perm


def _op_bytes(a: CSR, k: Optional[int]) -> float:
    """The bytes that any variant must move for one product: each stored
    value read once, x read and y written once.  The plausibility floor
    divides them by the card's bandwidth; the variants' modeled bytes carry
    ranking terms (the gather penalty, the TPU's lane padding of X, the POH
    variants' time-equivalent bytes), which the H100's readings beat."""
    db = _dtype_bytes(a.dtype)
    m, n = a.shape
    return a.nnz * db + (m + n) * db * (k or 1)


def tune(a: CSR, *, k: Optional[int] = None, cache: Optional[TunerCache] = None,
         time_budget: int = 3, include_pallas: Optional[bool] = None,
         force: bool = False, wall_budget_s: Optional[float] = None,
         precision: str = "any", device=None) -> TunedSpmv:
    """Pick the fastest kernel variant for matrix ``a`` (SpMV, or SpMM
    with ``k`` dense columns); cache the winner by sparsity signature.

    ``device``: where the variants are built and timed (default: where
    ``a``'s tensors are, the CUDA device for host numpy arrays; raises
    without one).  ``time_budget``: how many top analytic candidates to
    time.  ``include_pallas`` (default: the device is a CUDA device)
    enumerates the kernel variants; on the CPU they run their plain twins.
    ``wall_budget_s``: stop timing further candidates once this much wall
    clock has passed (default 900 s on a CUDA device, where a kernel's
    first build takes about a minute; unlimited elsewhere); at least one
    candidate is always timed, and a truncated run records
    ``"truncated": true``.  ``precision``: ``'any'`` lets the ``_fast``
    variants compete, ``'f32'`` excludes them from enumeration and from
    cache hits.  On a CUDA device a reading below half the floor (the bytes
    the product must move, :func:`_op_bytes`, over the card's bandwidth) is
    implausible and cannot win outright.
    """
    if not isinstance(a, CSR):
        from cask_tpu_torch.formats.convert import bsr_to_csr, coo_to_csr

        if isinstance(a, COO):
            a = coo_to_csr(a)
        elif isinstance(a, BSR):
            a = bsr_to_csr(a)
        else:
            raise TypeError(f"cannot tune {type(a)}")
    if precision not in ("any", "f32"):
        raise ValueError(f"unknown precision constraint {precision!r}")
    device = plan_device(a.data, device)
    on_card = device.type == "cuda"
    if include_pallas is None:
        include_pallas = on_card
    cache = cache or default_cache()
    sig = compute_signature(a)
    cache_key = f"{sig.key()}:k={k or 0}"
    if precision == "f32":
        cache_key += ":f32"  # 'any' winners may be the _fast variants

    if not force:
        hit = cache.get(cache_key)
        if hit is not None:
            var = Variant(hit["variant"], 0.0)
            dev, fn, info = var.build_full(a, k, device)
            return TunedSpmv(
                variant=var.name, matrix=dev, _fn=fn, signature_key=cache_key,
                seconds_per_op=hit.get("seconds_per_op"),
                perm=info.get("perm"), _inner_fn=info.get("inner_fn"),
            )

    from cask_tpu_torch.tune.calibrate import poh_equiv_bytes

    variants = enumerate_variants(a, sig, k, include_pallas=include_pallas,
                                  calib=poh_equiv_bytes(cache, device))
    if precision == "f32":
        variants = [v for v in variants if "_fast" not in v.name]
    variants.sort(key=lambda v: v.est_bytes)
    candidates = variants[: max(time_budget, 1)]
    # diversity rule: a mis-ranked prefilter must never drop the best
    # gather variant, the class that always builds, from timing
    if not any("_xla" in v.name for v in candidates):
        xla = next((v for v in variants if "_xla" in v.name), None)
        if xla is not None:
            candidates.append(xla)

    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(rng.standard_normal((a.shape[1], k) if k else a.shape[1])).to(
        device=device, dtype=torch_dtype(a.dtype))

    # Plausibility gate: the bytes the product must move bound every
    # reading from below; a reading under _floor_frac of that floor is
    # discarded, and a reliable time may outrank an unreliable-but-plausible
    # one only within a factor.
    gate = _gated(device)
    bw, bw_known = hbm_bandwidth() if gate else (None, False)
    bw = bw or _HBM_STAND_IN
    _floor_frac = 0.5 if bw_known else 0.125
    floor = _op_bytes(a, k) / bw if gate else 0.0

    if wall_budget_s is None and on_card:
        wall_budget_s = 900.0
    t_tune0 = time.time()
    truncated = False

    def finite(var, meas) -> bool:
        """Whether ``var``'s product of the finite ``x0`` was finite.  On a
        CUDA device a non-finite one is a broken variant and raises, unless
        the exact product itself overflows the value type."""
        if np.isfinite(meas.checksum):
            return True
        if gate:
            from cask_tpu_torch.formats.convert import to_scipy

            y = to_scipy(a).astype(np.float64) @ x0.cpu().double().numpy()
            if np.abs(y).max(initial=0.0) <= torch.finfo(x0.dtype).max:
                raise RuntimeError(f"tune {cache_key}: variant {var.name} gave a non-finite "
                                   "product of a finite operand")
        return False

    plans = {}  # the plans built for ``a``, shared by the variants that use one
    results_t = []  # (var, dev, fn, info, meas)
    timings = {}  # every variant's measurement (or refusal) persists in the cache
    for var in candidates:
        first = next((n for n in timings if _same_callable(n) == _same_callable(var.name)),
                     None)
        if first is not None:  # one callable, timed under its first name
            timings[var.name] = dict(timings[first], same_as=first)
            continue
        if (wall_budget_s is not None and results_t
                and time.time() - t_tune0 > wall_budget_s):
            truncated = True
            log.warning("tune %s: wall budget %.0fs exceeded; skipping %s "
                        "and later candidates", cache_key, wall_budget_s, var.name)
            break
        try:
            dev, fn, info = var.build_full(a, k, device, plans)
            meas = measure(fn, x0)
        except ValueError as e:  # a kernel's gate refuses the plan
            log.warning("tune %s: variant %s refused: %s", cache_key, var.name, e)
            timings[var.name] = {"refused": str(e)}
            continue
        plausible = meas.seconds_per_iter >= _floor_frac * floor
        log.info("tune %s: variant=%s t=%.3g s/op reliable=%s plausible=%s",
                 cache_key, var.name, meas.seconds_per_iter, meas.reliable, plausible)
        timings[var.name] = {"seconds_per_op": meas.seconds_per_iter,
                             "reliable": bool(meas.reliable),
                             "floor_seconds": floor,
                             "plausible": bool(plausible)}
        if not finite(var, meas):
            timings[var.name]["non_finite"] = True
            continue
        results_t.append((var, dev, fn, info, meas))

    def _secs(r):
        return r[4].seconds_per_iter

    tier0 = [r for r in results_t
             if r[4].reliable and _secs(r) >= _floor_frac * floor]
    tier1 = [r for r in results_t
             if not r[4].reliable and _secs(r) >= _floor_frac * floor]
    best = min(tier0, key=_secs) if tier0 else None
    if tier1:
        u = min(tier1, key=_secs)
        if best is None or _secs(u) * 8.0 < _secs(best):
            # the gap is too large to ignore: re-measure the unreliable
            # candidate and take it unless it also comes out implausible
            var_u, dev_u, fn_u, info_u, meas_u = u

            def _better(m_new, m_old):
                if not finite(var_u, m_new):
                    return False
                if m_new.seconds_per_iter < _floor_frac * floor:
                    return False  # still implausible
                if bool(m_new.reliable) != bool(m_old.reliable):
                    return bool(m_new.reliable)
                return m_new.seconds_per_iter < m_old.seconds_per_iter

            for _ in range(2):
                m2 = measure(fn_u, x0)
                if _better(m2, meas_u):
                    meas_u = m2
                if m2.reliable:
                    break
            plaus_u = meas_u.seconds_per_iter >= _floor_frac * floor
            timings[var_u.name].update(
                seconds_per_op=meas_u.seconds_per_iter,
                reliable=bool(meas_u.reliable),
                plausible=bool(plaus_u),
                remeasured=True,
            )
            u = (var_u, dev_u, fn_u, info_u, meas_u)
            if meas_u.reliable and plaus_u:
                if best is None or _secs(u) < _secs(best):
                    best = u
            elif best is None or _secs(u) * 8.0 < _secs(best):
                best = u
    if best is None and results_t:  # nothing plausible: least-bad reading
        best = min(results_t, key=lambda r: (not r[4].reliable, _secs(r)))

    if best is None:  # always possible: csr_xla
        var = Variant("csr_xla", 0.0)
        dev, fn = var.build(a, k, device)
        best = (var, dev, fn, {}, None)

    var, dev, fn, info, meas_b = best
    secs = meas_b.seconds_per_iter if meas_b is not None else float("nan")
    cache.put(cache_key, {"variant": var.name, "seconds_per_op": secs,
                          "shape": list(a.shape), "nnz": int(a.nnz),
                          "truncated": truncated, "timings": timings})
    return TunedSpmv(variant=var.name, matrix=dev, _fn=fn,
                     signature_key=cache_key, seconds_per_op=secs,
                     perm=info.get("perm"), _inner_fn=info.get("inner_fn"))


def _gated(device: torch.device) -> bool:
    """Whether readings on ``device`` meet the plausibility gate and a
    non-finite product raises: on a CUDA device, whose bandwidth bounds its
    readings and whose variants run their kernels."""
    return device.type == "cuda"
