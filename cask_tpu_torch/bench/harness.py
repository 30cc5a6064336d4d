"""Benchmark harness: JSON-lines records over matrix suites.

The PyTorch counterpart of :mod:`cask_tpu.bench.harness` (``bench_matrix``
and ``bench_suite``).  Synthetic suites or user ``.mtx`` files, the tuner's
variants timed on the card, one JSON line per variant: {matrix, op,
variant, device, seconds, GB/s, nnz/s, roofline share, scipy's host time}.
A variant whose plan a kernel's gate refuses is a record with ``refused``;
any other error propagates.

``bench_scaling`` and ``bench_overlap`` time the distributed halo SpMV
(:class:`cask_tpu_torch.parallel.DistSpmv`) on a world of ranks spawned on
this host (NCCL ranks, one a GPU; or gloo ranks on the CPU with
``device="cpu"``), through the rank program of
:mod:`cask_tpu_torch.examples.scaling_job`, and keep its records.
``bench_solve`` times an iteration of ``cg`` and ``pipelined_cg`` on a
Poisson system built on the device.
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


def _ranks_available(device) -> int:
    """Ranks this host can run: one per GPU (NCCL refuses two on one card),
    or the CPU cores."""
    import os

    return torch.cuda.device_count() if device.type == "cuda" else os.cpu_count() or 1


def _scaling_job(side: int, shards, device) -> list:
    """Rank 0's records of :func:`cask_tpu_torch.examples.scaling_job.job`
    (the one rank program behind both benches) on ``max(shards)`` ranks
    spawned on this host: NCCL ranks on the card, gloo ranks on the CPU."""
    from cask_tpu_torch.examples import scaling_job
    from cask_tpu_torch.parallel import launch

    cpu = device.type != "cuda"
    args = dict(rows_per_shard=side * side, shards=list(shards), kind="dia", mm=0, trace=None)
    return launch(scaling_job.job, max(shards), args, "cpu" if cpu else None,
                  backend="gloo" if cpu else "nccl", timeout=1800.0)[0]


def _emit(records, ops, out: TextIO) -> list:
    kept = [r for r in records if r["op"] in ops]
    for rec in kept:
        print(json.dumps(rec), file=out, flush=True)
    return kept


def bench_scaling(side: int = 512, *, nshards_list=(1, 2, 4, 8), out: TextIO = sys.stdout,
                  device=None) -> list:
    """Weak scaling of the distributed halo SpMV: the 5-point stencil of
    ``side·√P`` points a side on ``P`` ranks, for each ``P`` the host can
    run; ``efficiency`` is ns per row at the first ``P`` over ns per row
    at this one.  On the card the DIA kernel is the shard interior."""
    device = plan_device(None, device)
    shards = [p for p in nshards_list if p <= _ranks_available(device)]
    return _emit(_scaling_job(side, shards, device), ("dist_spmv_weak_scaling",), out)


def bench_overlap(side: int = 512, *, nshards: Optional[int] = None,
                  out: TextIO = sys.stdout, device=None) -> list:
    """A/B on ``nshards`` ranks (default: all the host can run): the halo
    exchange overlapped with the interior against serialized before it,
    over the stencil of ``side·√P`` points a side.  Overlapped should
    approach max(exchange, interior) and serialized pay their sum; the
    difference is the exchange hidden."""
    device = plan_device(None, device)
    p = nshards or _ranks_available(device)
    return _emit(_scaling_job(side, [p], device), ("dist_spmv_overlap_ab",), out)


SOLVE_LADDER = (10, 200, 400, 600)  # iteration counts of bench_solve's k-ladder


def bench_solve(side: int = 512, *, dtype=np.float32, out: TextIO = sys.stdout,
                device=None) -> list:
    """Per-iteration cost of ``cg`` and ``pipelined_cg`` on the 5-point
    Poisson system of ``side²`` rows, built on the device
    (:func:`~cask_tpu_torch.formats.device_gen.stencil2d_dia_device`) under
    a :class:`~cask_tpu_torch.ops.dia.DiaOperator`, by the k-ladder: solves
    at ``tol=0`` and ``maxiter=k`` for each k of :data:`SOLVE_LADDER`, two
    rounds, the least wall for each k, and the median of the slopes between
    every pair of ks.  A wall is the host clock between two device syncs;
    the solvers sync at every loop test, so it is the solve's own time.  A
    solve that stops short of its k (a residual of exactly 0, or not a
    number) raises: its slope would not be a cost per iteration.
    ``device``: the CUDA device unless given (raises without one)."""
    from cask_tpu_torch.formats.device_gen import stencil2d_dia_device
    from cask_tpu_torch.ops.dia import DiaOperator
    from cask_tpu_torch.solvers import cg, pipelined_cg

    device = plan_device(None, device)
    on_card = device.type == "cuda"
    m = side * side
    op = DiaOperator(stencil2d_dia_device(side, dtype=dtype, device=device))
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    bp = op.to_padded(torch.randn(m, generator=gen, device=device, dtype=op.dia.dtype))

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    def per_iteration(name, solver):
        def run(k):
            sync()
            t0 = time.perf_counter()
            res = solver(op, bp, tol=0.0, maxiter=k)
            sync()
            wall = time.perf_counter() - t0
            if res.iterations != k:
                raise RuntimeError(f"bench_solve: {name} stopped after {res.iterations} of "
                                   f"{k} iterations (residual {res.residual_norm:.3e})")
            return wall

        ks = SOLVE_LADDER
        run(ks[0])
        run(ks[-1])
        walls = {}
        for _ in range(2):
            for k in ks:
                walls[k] = min(walls.get(k, float("inf")), run(k))
        slopes = sorted((walls[b] - walls[a]) / (b - a) for a in ks for b in ks if b > a)
        return slopes[len(slopes) // 2]

    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    records = []
    for name, solver in (("cg", cg), ("pipelined_cg", pipelined_cg)):
        per_iter = per_iteration(name, solver)
        rec = {
            "op": "pcg_per_iteration",
            "solver": name,
            "matrix": f"stencil5_{side}x{side}",
            "rows": m,
            "operator_mode": op.mode,
            "us_per_iteration": round(per_iter * 1e6, 2),
            "iterations_per_s": round(1.0 / per_iter, 1),
            "device": kind,
        }
        records.append(rec)
        print(json.dumps(rec), file=out, flush=True)
    return records
