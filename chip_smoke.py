#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU and check it.

    python3 chip_smoke.py

The quickest proof that ``cask_tpu_torch`` still builds and runs on the
card.  Phases, one line each:

1. device — the card's name and power limit; TF32 off.
2. build — ``nvcc`` builds the BDIA kernel from ``cask_tpu_torch/csrc``.
3. small — the kernel against its plain PyTorch twin on small FEM
   matrices (dof 2/4/8), one with a COO remainder and one with (4, 2)
   blocks, in f32 and f64.
4. spmv — ``spmv(bsr, x)`` through the public entry point on the
   1,048,576-row dof-4 FEM matrix (f32); the kernel's launch count must
   rise, and y must match the twin and scipy (f64, host).
5. cg — ``cg(BdiaOperator(...), b)`` on an SPD block system of the same
   size; it must converge, with a true residual checked in f64 on the host.
6. timing — the kernel and the twin with CUDA events at the 1M-row size.

It needs one CUDA device and exits non-zero without one; any failed check
raises.  The last two lines are JSON: the kernels that ran (launches,
errors and times measured in this run), then the device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

NX = 512  # grid side: 512² nodes × dof 4 = 1,048,576 rows
DOF = 4
SEED = 0
F32_TOL = 1e-5  # normwise relative; f32 sums of ≤ 80 products, same order
F64_TOL = 1e-12  # same products in the same pair order as the twin
SOURCE = "cask_tpu_torch/csrc/bdia_spmv.cu"
REPLACES_FUSED = "cask_tpu/ops/pallas/bdia_kernels.py:290"
REPLACES_RESIDENT = "cask_tpu/ops/pallas/bdia_kernels.py:70"


def _relerr(y, ref) -> float:
    return float((y.double() - ref.double()).norm() / ref.double().norm())


def _check(name: str, err: float, tol: float) -> None:
    if not err <= tol:
        raise AssertionError(f"{name}: normwise relative error {err:.3e} > {tol:.0e}")


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _remainder_matrix(dtype):
    """fem_blocks(6, dof=4) plus scattered 4×4 blocks that spill to the COO
    remainder (the construction of the JAX package's fused-with-remainder
    test)."""
    import numpy as np

    from cask_tpu_torch.formats.convert import csr_to_bsr, from_scipy, to_scipy
    from cask_tpu_torch.formats.generate import fem_blocks

    s = to_scipy(fem_blocks(6, dof=4, dtype=np.float64)).tolil()
    rng = np.random.default_rng(16)
    for _ in range(6):
        bi, bj = int(rng.integers(0, 20)), int(rng.integers(0, 20))
        s[bi * 4 : bi * 4 + 4, bj * 4 : bj * 4 + 4] = rng.standard_normal((4, 4))
    return csr_to_bsr(from_scipy(s.tocsr().astype(dtype)), (4, 4))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check runs on a GPU",
              file=sys.stderr)
        return 1

    import numpy as np

    import cask_tpu_torch as ct
    from cask_tpu_torch.formats.convert import csr_to_bsr, from_scipy, to_scipy
    from cask_tpu_torch.formats.generate import _diag_shift, fem_blocks
    from cask_tpu_torch.ops.kernels import build
    from cask_tpu_torch.ops.kernels.bdia_kernels import bdia_spmv, bdia_spmv_reference
    from cask_tpu_torch.ops.spmv import default_plan_cache
    from cask_tpu_torch.tune.timing import time_cuda
    from cask_tpu_torch.utils.platform import default_device, hbm_bandwidth

    t_start = time.perf_counter()
    dev = default_device()
    kind = torch.cuda.get_device_name(0)
    card = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {kind}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"TF32 off (matmul and cudnn); name and power limit:", flush=True)
    print(card, flush=True)

    # -- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib = build.build("bdia_spmv")
    ptxas = [ln.strip() for ln in lib.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[build] bdia_spmv.cu in {time.perf_counter() - t0:.1f} s; ptxas: "
          + " | ".join(ptxas), flush=True)

    # -- 3. kernel vs plain twin, small -----------------------------------
    rng = np.random.default_rng(SEED)
    cases = []
    for nx in (16, 33):
        for dof in (2, 4, 8):
            cases.append((f"fem{nx}_dof{dof}", lambda dt, nx=nx, dof=dof:
                          fem_blocks(nx, dof=dof, dtype=dt, return_bsr=True)))
    cases.append(("remainder", _remainder_matrix))
    cases.append(("rect4x2", lambda dt: csr_to_bsr(fem_blocks(6, dof=4, dtype=dt), (4, 2))))
    worst = {np.float32: 0.0, np.float64: 0.0}
    for name, make in cases:
        for dt in (np.float32, np.float64):
            bsr = make(dt)
            plan = ct.bdia_plan(bsr, device=dev)
            x = torch.from_numpy(rng.standard_normal(bsr.shape[1]).astype(dt)).to(dev)
            y = plan.spmv(x)
            torch.cuda.synchronize()
            tol = F32_TOL if dt == np.float32 else F64_TOL
            err = _relerr(y, plan._spmv_reference(x))
            _check(f"{name} {dt.__name__} kernel vs twin", err, tol)
            err_sp = _relerr(y.cpu(), torch.from_numpy(to_scipy(bsr).astype(np.float64)
                                                       @ x.cpu().double().numpy()))
            _check(f"{name} {dt.__name__} kernel vs scipy", err_sp, 10 * tol)
            worst[dt] = max(worst[dt], err)
    print(f"[small] {len(cases)} plans x f32/f64 (remainder: "
          f"{cases[-2][0]}, (4,2) blocks: {cases[-1][0]}): kernel vs twin worst "
          f"{worst[np.float32]:.2e} f32 (tol {F32_TOL:.0e}), {worst[np.float64]:.2e} f64 "
          f"(tol {F64_TOL:.0e})", flush=True)

    # -- 4. main path: spmv(bsr, x) at full size ---------------------------
    t0 = time.perf_counter()
    a_host = fem_blocks(NX, dof=DOF, dtype=np.float32, seed=SEED, return_bsr=True)
    t_gen = time.perf_counter() - t0
    a = a_host.to(dev)
    x = torch.from_numpy(rng.standard_normal(a.shape[1]).astype(np.float32)).to(dev)
    bdia_spmv.launches = 0  # counts from here on are the main path's
    t0 = time.perf_counter()
    y = ct.spmv(a, x)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches_spmv = bdia_spmv.launches
    if launches_spmv < 1:
        raise AssertionError("spmv(bsr, x) did not launch the BDIA kernel")
    plan = default_plan_cache.get(a)
    y_twin = plan._spmv_reference(x)
    err_twin = _relerr(y, y_twin)
    _check("1M spmv kernel vs twin", err_twin, F32_TOL)
    abs_spmv = float((y - y_twin).abs().max())
    a_sp = to_scipy(a_host)
    y_sp = a_sp.astype(np.float64) @ x.cpu().double().numpy()
    err_sp = _relerr(y.cpu(), torch.from_numpy(y_sp))
    _check("1M spmv kernel vs scipy f64", err_sp, F32_TOL)
    print(f"[spmv] {a.shape[0]} rows, nnz {a.nnz}, vals {tuple(plan.vals.shape)}, "
          f"offsets {plan.block_offsets}, ts {plan.ts}; host gen {t_gen:.1f} s, first call "
          f"(plan + launch) {t_first:.1f} s; launches {launches_spmv}; vs twin {err_twin:.2e} "
          f"(max abs {abs_spmv:.2e}), vs scipy f64 {err_sp:.2e} (tol {F32_TOL:.0e})", flush=True)

    # -- 5. CG over BdiaOperator on the SPD block system --------------------
    t0 = time.perf_counter()
    s_csr = _diag_shift(from_scipy((a_sp + a_sp.T).tocsr()), 1.1)
    s_bsr = csr_to_bsr(s_csr, (DOF, DOF))
    op = ct.BdiaOperator(ct.bdia_plan(s_bsr, device=dev))
    b = torch.from_numpy(rng.standard_normal(s_bsr.shape[0]).astype(np.float32)).to(dev)
    t_build = time.perf_counter() - t0
    before = bdia_spmv.launches
    t0 = time.perf_counter()
    res = ct.solvers.cg(op, b, tol=1e-6, maxiter=200)
    torch.cuda.synchronize()
    t_cg = time.perf_counter() - t0
    launches_cg = bdia_spmv.launches - before
    if launches_cg < 1:
        raise AssertionError("cg over BdiaOperator did not launch the BDIA kernel")
    if not res.converged:
        raise AssertionError(f"cg did not converge: {res.iterations} iterations, "
                             f"residual {res.residual_norm:.3e}")
    s64 = to_scipy(s_csr).astype(np.float64)
    b64 = b.cpu().double().numpy()
    x64 = res.x.cpu().double().numpy()
    true_rel = float(np.linalg.norm(b64 - s64 @ x64) / np.linalg.norm(b64))
    if not true_rel <= 1e-5:
        raise AssertionError(f"cg true relative residual {true_rel:.3e} > 1e-5")
    # the same solve again, warm: the first one also pays one-time set-up
    # (library handles, allocator growth)
    t0 = time.perf_counter()
    warm = ct.solvers.cg(op, b, tol=1e-6, maxiter=200)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    print(f"[cg] mode {op.mode}, {s_bsr.shape[0]} rows, nnz {s_bsr.nnz}: converged in "
          f"{res.iterations} iterations, first solve {t_cg * 1e3:.1f} ms, warm solve "
          f"{t_warm * 1e3:.2f} ms = {t_warm / max(warm.iterations, 1) * 1e6:.0f} us per "
          f"iteration (host clock, one host sync per iteration); true relative residual "
          f"{true_rel:.2e} (f64 host, tol 1e-5); system build {t_build:.1f} s; "
          f"launches {launches_cg}", flush=True)

    # -- 6. timing: kernel vs plain twin, both entries ----------------------
    y_op, y_op_twin = op(b), op.bdia._spmv_reference(b)  # counts were read above
    _check("1M operator kernel vs twin", _relerr(y_op, y_op_twin), F32_TOL)
    abs_op = float((y_op - y_op_twin).abs().max())
    bw, bw_known = hbm_bandwidth()
    entries = []
    for name, replaces, p, v, launches, max_abs in (
            ("bdia_spmv [spmv(bsr, x)]", REPLACES_FUSED, plan, x, launches_spmv, abs_spmv),
            ("bdia_spmv [BdiaOperator in cg]", REPLACES_RESIDENT, op.bdia, b, launches_cg,
             abs_op)):
        kernel = lambda p=p, v=v: bdia_spmv(p, v)  # noqa: E731
        plain = lambda p=p, v=v: bdia_spmv_reference(p, v)  # noqa: E731
        runs = [time_cuda(f, warmup=3, runs=20, reps=10) for f in (plain, kernel, kernel, plain)]
        ms = float(np.median(runs[1].samples_ms + runs[2].samples_ms))
        plain_ms = float(np.median(runs[0].samples_ms + runs[3].samples_ms))
        nbytes = (p.vals.numel() + p.shape[0] + p.shape[1]) * p.vals.element_size()
        gbs = nbytes / (ms * 1e-3) / 1e9
        frac = f"{gbs * 1e9 / bw:.3f} of {bw / 1e12:.2f} TB/s" if bw_known else "unknown card"
        print(f"[timing] {name}: kernel {ms * 1e3:.1f} us, plain twin {plain_ms * 1e3:.1f} us; "
              f"{nbytes / 1e6:.1f} MB moved -> {gbs:.0f} GB/s, HBM fraction {frac}; "
              f"card {card}; median of 2x20 samples of 10 calls (CUDA events)", flush=True)
        entries.append({"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
                        "launches": launches, "max_abs_err": max_abs, "ms": ms,
                        "plain_ms": plain_ms})

    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
