"""Benchmark harness: JSON-lines records over matrix suites.

The PyTorch counterpart of :mod:`cask_tpu.bench.harness` (``bench_matrix``
and ``bench_suite``).  Synthetic suites or user ``.mtx`` files, the tuner's
variants timed on the card, one JSON line per variant: {matrix, op,
variant, device, seconds, GB/s, nnz/s, roofline share, scipy's host time}.
A variant whose plan a kernel's gate refuses is a record with ``refused``;
any other error propagates.  The JAX package's ``bench_scaling``,
``bench_overlap`` and ``bench_solve`` wait for the port's multi-device
SpMV and ``pipelined_cg`` (ROADMAP Queue A 7 and A 2).
"""

from __future__ import annotations

import json
import sys
import time
from typing import Iterable, Optional, TextIO

import numpy as np
import torch

from cask_tpu_torch.bench.roofline import chip_bandwidth, spmv_traffic
from cask_tpu_torch.formats.convert import to_scipy
from cask_tpu_torch.formats.matrix import BSR, CSR, host
from cask_tpu_torch.formats.signature import signature
from cask_tpu_torch.ops.bdia import BdiaMatrix
from cask_tpu_torch.ops.dia import DiaMatrix
from cask_tpu_torch.ops.poh import PohMatrix
from cask_tpu_torch.tune.timing import measure
from cask_tpu_torch.tune.tuner import Variant, enumerate_variants
from cask_tpu_torch.utils.platform import plan_device

_MODELED = (CSR, BSR, DiaMatrix, BdiaMatrix, PohMatrix)  # spmv_traffic's formats


def bench_matrix(name: str, a: CSR, *, k: Optional[int] = None,
                 variants: Optional[Iterable[str]] = None,
                 dtype=np.float32, out: TextIO = sys.stdout, device=None) -> list:
    """Time variants of SpMV (or SpMM-k) on one matrix; emit JSON lines.
    ``variants`` default to the tuner's top three by modeled traffic (the
    kernel variants among them on a CUDA device); ``device`` as
    :func:`cask_tpu_torch.tune.tune` (the CUDA device unless given)."""
    a = CSR(data=host(a.data).astype(dtype), indices=host(a.indices),
            indptr=host(a.indptr), shape=a.shape)
    device = plan_device(None, device)
    on_card = device.type == "cuda"
    if variants is None:
        cand = enumerate_variants(a, signature(a), k, include_pallas=on_card)
        cand.sort(key=lambda v: v.est_bytes)
        cand = cand[:3]
    else:
        cand = [Variant(v, 0.0) for v in variants]

    rng = np.random.default_rng(0)
    xh = rng.standard_normal((a.shape[1], k) if k else a.shape[1]).astype(dtype)
    x0 = torch.from_numpy(xh).to(device)
    # host scipy baseline (the CPU comparison column)
    s = to_scipy(a).astype(dtype)
    s @ xh  # warm
    scipy_s = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        s @ xh
        scipy_s = min(scipy_s, time.perf_counter() - t0)
    bandwidth = chip_bandwidth() if on_card else None
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    records = []
    for var in cand:
        rec = {
            "matrix": name,
            "op": f"spmm_k{k}" if k else "spmv",
            "variant": var.name,
            "device": kind,
            "rows": a.shape[0],
            "nnz": a.nnz,
            "dtype": str(np.dtype(dtype)),
            "ts": time.time(),
        }
        try:
            dev, fn = var.build(a, k, device)
            meas = measure(fn, x0)
        except ValueError as e:  # a kernel's gate refuses the plan
            rec["refused"] = f"{type(e).__name__}: {e}"
        else:
            traffic = spmv_traffic(dev if isinstance(dev, _MODELED) else a, var.name, k or 1)
            rec.update(traffic.record(meas.seconds_per_iter, bandwidth=bandwidth))
            rec["reliable"] = meas.reliable
            if not np.isfinite(meas.checksum):
                rec["non_finite"] = True  # a finite operand's product: a broken variant
            if meas.seconds_per_iter > 0:
                rec["scipy_seconds"] = scipy_s
                rec["speedup_vs_scipy"] = round(scipy_s / meas.seconds_per_iter, 2)
        records.append(rec)
        print(json.dumps(rec), file=out, flush=True)
    return records


def bench_suite(size: str = "small", *, k: Optional[int] = None, dtype=np.float32,
                out: TextIO = sys.stdout, device=None) -> list:
    from cask_tpu_torch.formats.generate import suite

    all_recs = []
    for name, a in suite(size).items():
        all_recs += bench_matrix(name, a, k=k, dtype=dtype, out=out, device=device)
    return all_recs
