"""Per-card calibration of the POH kernel cost model.

The PyTorch counterpart of :mod:`cask_tpu.tune.calibrate`.  The tuner
costs the panel one-hot (POH) variants in time-equivalent device-memory
bytes per packed slot (time per slot × the card's bandwidth), since their
time is not set by the bytes they move.  The constants come from one timing
probe on the card (:func:`calibrate_poh`), kept in the tuner cache under the
card's name; :func:`poh_equiv_bytes` reads them, or the seeds below where
no probe has run.  The model's form and its dimensionless parameters
(``POH_ALPHA``, ``POH_TILE_EQUIV``, ``POH_FILL``) are the JAX package's, so
that both enumerate the same variants at the same costs from one
calibration record.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import torch

from cask_tpu_torch.tune.cache import TunerCache, default_cache

log = logging.getLogger("cask_tpu_torch.tune")

# The rate that turns a time into equivalent bytes: the published HBM
# bandwidth of the H100 SXM5 (80 GB HBM3).
HBM_BYTES_PER_S = 3.35e12

# Seeds: calibrate_poh's defaults run on an NVIDIA H100 80GB HBM3 at a
# 700 W power limit (time × 3.35 TB/s / packed slots; chip_smoke.py's
# [calibrate]), used until calibrate_poh runs on the card at hand.  The port's POH kernels ignore
# ``precision``, so each ``_fast`` variant times the same kernel as its
# twin.  ``_c_ref`` is the probe matrix's auto column window at 2048-slot
# tiles, which anchors the window-aware model below.
SEED_EQUIV_BYTES: Dict[str, float] = {
    "poh:2048": 25.8,
    "poh_fast:2048": 25.8,
    "poh:8192": 24.6,
    "poh_fast:8192": 24.7,
    "poh_mm": 9.6,
    "poh_mm_fast": 9.6,
    "_c_ref": 2048.0,
}

# Window-aware model: per-slot cost eb_slot(C) = base · (C / C_ref)^alpha in
# the auto column window C, plus a per-tile term; dimensionless, the
# reference's (calibrate.py:63-79).
POH_ALPHA = 0.965
POH_TILE_EQUIV = 6000.0  # equivalent bytes per tile
POH_FILL = 0.9  # typical packed-slot fill


def poh_auto_window(m: int, n: int, nnz: int, tile_slots: int,
                    row_panel: int = 4096) -> int:
    """The auto ``col_window`` C that :func:`cask_tpu_torch.ops.poh.poh_plan`
    picks: the prefilter costs the plan that will be built (floors and the
    8192 cap included)."""
    lane = 128
    R = max(-(-row_panel // lane) * lane, lane)
    R = max(min(R, max(-(-max(m, 1) // lane) * lane, lane)), 8 * lane)
    nnz_per_panel = max(nnz * R / max(m, 1), 1.0)
    span = tile_slots * max(n, 1) / nnz_per_panel
    c = 128
    while c < min(span, 8192):
        c *= 2
    return max(c, 8 * lane)


def poh_equiv_bytes_analytic(m: int, n: int, nnz: int, tile_slots: int, *,
                             fast: bool = False,
                             calib: Optional[Dict[str, float]] = None) -> float:
    """Per-nnz time-equivalent bytes for a ``poh[:T]`` variant, from the
    matrix's structure (auto window and tile count)."""
    calib = calib or poh_equiv_bytes()
    key = "poh_fast:2048" if fast else "poh:2048"
    base = float(calib.get(key, SEED_EQUIV_BYTES[key]))
    c_ref = float(calib.get("_c_ref", SEED_EQUIV_BYTES["_c_ref"]))
    c = poh_auto_window(m, n, nnz, tile_slots)
    eb_slot = base * (c / c_ref) ** POH_ALPHA
    return (eb_slot + POH_TILE_EQUIV / tile_slots) / POH_FILL


def backend_kind(device=None) -> str:
    """The name of ``device``'s card (default: CUDA device 0) in the form of
    the reference's device kinds (``nvidia_h100_80gb_hbm3``), or ``cpu`` for
    the CPU or without a CUDA device."""
    if not torch.cuda.is_available() or (device is not None
                                         and torch.device(device).type != "cuda"):
        return "cpu"
    return torch.cuda.get_device_name(device).replace(" ", "_").lower()


def _key(device=None) -> str:
    return f"calibration:poh:{backend_kind(device)}"


def poh_equiv_bytes(cache: Optional[TunerCache] = None, device=None) -> Dict[str, float]:
    """Calibrated equivalent bytes per POH slot for ``device``'s card
    (default: CUDA device 0), or the seeds where no calibration record
    exists."""
    cache = cache or default_cache()
    hit = cache.get(_key(device))
    if hit and isinstance(hit.get("equiv_bytes"), dict):
        out = dict(SEED_EQUIV_BYTES)
        out.update({k: float(v) for k, v in hit["equiv_bytes"].items()})
        return out
    return dict(SEED_EQUIV_BYTES)


def calibrate_poh(cache: Optional[TunerCache] = None, *, n: int = 150_000,
                  avg_degree: int = 24, k: int = 32, force: bool = False,
                  device=None) -> Dict[str, float]:
    """Time each POH variant on a power-law matrix and store the equivalent
    bytes per slot in the tuner cache, keyed on the card.

    The probe is ``power_law(n, avg_degree=avg_degree, seed=0)`` in f32: by
    default 150,000 rows of 6.9 M entries, whose packs (values, column and
    row ids: 12 bytes a slot, 83 MB and more) exceed the H100's 50 MB L2, so
    the probe times the kernels reading device memory, as the tuner's
    full-size matrices do (the reference's 30,000-row probe of 0.24 M
    entries fits in L2 there).  Its auto column window is 2048 at 2048-slot
    tiles and 8192 at 8192-slot ones, as the reference probe's, which
    anchors the window model at ``_c_ref`` = 2048.  Run it
    with ``python -m cask_tpu_torch.bench.cli calibrate``; the tuner only
    reads the record.  ``device`` as :func:`cask_tpu_torch.tune.tune`.
    """
    import numpy as np

    from cask_tpu_torch.formats.generate import power_law
    from cask_tpu_torch.ops.poh import poh_plan
    from cask_tpu_torch.tune.timing import measure
    from cask_tpu_torch.utils.platform import plan_device

    device = plan_device(None, device)
    cache = cache or default_cache()
    if not force:
        hit = cache.get(_key(device))
        if hit and isinstance(hit.get("equiv_bytes"), dict):
            return poh_equiv_bytes(cache, device)

    a = power_law(n, avg_degree=avg_degree, seed=0, dtype=np.float32)
    rng = np.random.default_rng(0)
    x1 = torch.as_tensor(rng.standard_normal(a.shape[1]).astype(np.float32), device=device)
    xk = torch.as_tensor(rng.standard_normal((a.shape[1], k)).astype(np.float32),
                         device=device)

    results: Dict[str, float] = {}
    pack_bytes: Dict[str, int] = {}

    def record(name, seconds, slots, kk=1):
        eb = seconds * HBM_BYTES_PER_S / max(slots * kk, 1)
        results[name] = round(float(eb), 1)
        log.info("calibrate %s: %.3g s/op -> %.0f equiv-B/slot", name, seconds, eb)

    for ts in (2048, 8192):
        dev = poh_plan(a, tile_slots=ts, device=device)
        slots = dev.ntiles * ts  # packed slot count incl. tile fill
        pack_bytes[str(ts)] = slots * (dev.vals.element_size() + 8)
        for prec, name in (("split", f"poh:{ts}"), ("fast", f"poh_fast:{ts}")):
            m1 = measure(lambda v, d=dev, p=prec: d.spmv(v, precision=p), x1)
            record(name, m1.seconds_per_iter, slots)
        if ts == 8192:
            for prec, name in (("split", "poh_mm"), ("fast", "poh_mm_fast")):
                m2 = measure(lambda v, d=dev, p=prec: d.spmm(v, precision=p), xk)
                record(name, m2.seconds_per_iter, slots, kk=k)
        del dev

    results["_c_ref"] = float(poh_auto_window(n, n, int(a.nnz), 2048))
    cache.put(_key(device), {"equiv_bytes": results, "n": n, "avg_degree": avg_degree,
                             "k": k, "nnz": int(a.nnz), "pack_bytes": pack_bytes})
    return poh_equiv_bytes(cache, device)
