#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one GPU and check them.

    python3 chip_smoke.py

The quickest proof that ``cask_tpu_torch`` still builds and runs on the
card.  Phases, one line each:

1. device — the card's name and power limit; TF32 off.
2. build — ``nvcc`` builds every kernel from ``cask_tpu_torch/csrc``, one
   compiler per source, all at once; the ptxas register and spill lines,
   per instantiation for the redesigned kernels (the slab's tensor-core
   kernel, POH SpMM and SpMV and the LELL kernels, their half
   instantiations too), none of which may spill; the DIA and ring SpMM
   kernels, which read X through a register window, the BSR SpMM kernel
   that stages its values in shared memory and the BDIA SpMV kernel,
   summarised per source and held to no spills as well.
3. small — the BDIA kernel against its plain PyTorch twin on small FEM
   matrices (dof 2/4/8), one with a COO remainder and one with (4, 2)
   blocks, in f32 and f64.
4. small-dia — the DIA SpMV and SpMM kernels against their twins and scipy
   on small plans: a stencil, a band, a plan with a remainder, asymmetric
   offsets, both rectangular shapes and a transposed tall plan; f32 and
   f64, SpMM at k ∈ {1, 20, 32, 100, 128}.
5. small-slab — the slab (natural and padded frames), BDIA ring and BSR
   SpMM kernels against their twins and scipy on eight small plans (dof 2
   and 4, a remainder, far offsets not divisible by g, none, one
   asymmetric, eight far offsets, a ragged rectangular matrix); f32 and
   f64, k ∈ {1, 65, 128}; and the f32 slab kernel (4xTF32) within 2e-6 of
   f64 on values whose low mantissa bits one TF32 pass would drop.
6. small-poh — the POH SpMV and SpMM kernels against their twins and scipy
   on the edge plans of the JAX package's POH tests (power law, both
   rectangles, a band, one dense column, empty rows and columns, the
   all-zero matrix, n below the window, other panel, window and tile
   sizes, ``graph_pattern_120.mtx`` through ``read_mtx``, one hub row
   whose panel both kernels cut into pieces, two panels whose live slots
   each hold one row, one tile per panel): ``spmv``, ``transposed`` and
   ``spmm`` at k ∈ {1, 32, 150}, f32 and f64.
7. small-lell — the LELL kernels against their twins and scipy:
   ``lell_plan`` at groups ∈ {1, 2, 4, ..., 128}, at one layer, with two
   trailing layers of padding and cut to 61 slot rows (not a multiple of a
   block's eight), and ``lell_plan_hyb`` on a uniform matrix, a power law,
   a rectangle, a plan wider than the reference's 4096·B cap and a hub row
   whose hub slot rows run across blocks.
7b. small-bf16, small-f16 — the half value paths (values and operand each
   H or f32, at least one H, for H bf16 and then f16; SpMM out f32 or H,
   SpMV out f16 for f16 values and x, else f32): the BDIA SpMV, DIA SpMV and
   SpMM, ring and slab kernels (both frames) against their twins on the
   small plans of phases 3-5, spmv and spmm at k ∈ {1, 12, 32, 65, 128}, f32
   outputs within 1e-5, half outputs within one ulp of the twin's f32 sum;
   and each slab kernel's error against f64 within 4x of its plain FP32
   twin's (4xTF32 for f32, two TF32 passes with one half operand, one with
   two f16 ones), on the headline-shaped and the TF32-sensitive case.
7c. small-half — the half path of BSR SpMM, POH SpMV and SpMM and LELL
   (values and operand each bf16 or f16 or f32, at least one half, of one
   half type) against their twins on the small plans of phases 5-7 (LELL:
   each tier's group sums and the whole ``spmv`` of each plan): f32
   outputs within 1e-5, half outputs (BSR's, the values' type; LELL's f16
   for f16 values and x) within one ulp of the twin's f32 sum.
8. spmv — ``spmv(bsr, x)`` through the public entry point on the
   1,048,576-row dof-4 FEM matrix (f32).
9. cg — ``cg(BdiaOperator(...), b)`` on an SPD block system of that size.
10. block-cg — ``block_cg`` over that system's BDIA plan with 128 right-hand
   sides and Jacobi: the slab kernel once per iteration.
11. dia-spmv — ``spmv(csr, x)`` on the 4,194,304-row 5-point stencil (f32).
12. dia-cg — ``cg(solver_operator(S), b)`` with S = I + that stencil.
13. spmm — ``spmm(csr, X)`` on the 1,048,576-row stencil at k = 32 and 128
   (BASELINE config 3 and its wide k) and ``spmm(bsr, X)`` on the FEM
   matrix at k = 32 (f32).
14. spmm-wide — the FEM matrix at k = 128: ``spmm(bsr, X)`` (the slab
   kernel), ``spmm(plan, X, method="pallas_bdia")`` (the ring),
   ``spmm(bsr, X, method="pallas_bsr")`` and ``spmm`` of the scalar-DIA
   plan (the DIA SpMM kernel, the route ``spmm(bsr, X)`` took before the
   slab).
15. poh-spmv — ``spmv(poh_plan(A), x)`` on ``power_law(1_000_000,
   avg_degree=12)`` (f32): the unstructured path, one ``poh_spmv`` launch.
16. poh-spmm — ``spmm(plan, X)`` on the same plan at k = 32, in the
   plan's pieces.
17. lell — ``lell_plan_hyb(A).spmv(x)``: two launches, the grouped tier's
   rows, then the hub tier and the COO remainder added by atomics.
18. poh-cg — CG with Jacobi over the POH plan of the SPD ``A + Aᵀ`` with
   each row's diagonal raised by 1.1 × its absolute row sum: one
   ``poh_spmv`` launch per operator application; ``[poh-cg-bf16]`` the same
   over the system's bf16 POH plan, iterations within 2 of the f32 solve.
19. bf16, f16 — the paths of phases 8, 9, 11, 12 and 14 at full width with
   the matrices' values in bf16 and then f16 (f32 vectors): ``[spmv-H]``
   spmv(bsr_H, x), ``[cg-H]`` cg over a BdiaOperator of the H plan,
   ``[dia-spmv-H]`` and ``[dia-cg-H]`` on the stencils, ``[spmm-H]``
   spmm(bsr_H, X) at k = 32 (scalar DIA) and 128 (the H slab), the ring
   with f32 out and with ``accum_dtype=H`` (H X), scalar DIA at k = 128
   with f32 and H out; each against its twin and scipy f64 of the
   H-rounded matrix, and spmm(csr_H, X) on the phase-13 stencil at k = 32.
   The f16 run adds f16 x to both SpMVs (f16 y), and its CG solves must
   stay within 2 iterations of the f32 ones.
19b. half — the power law with bf16 and with f16 values: ``[poh-spmv-half]``
   spmv(poh_plan(A_h), x), ``[poh-spmm-half]`` spmm at k = 32,
   ``[lell-half]`` lell_plan_hyb(A_h).spmv(x) (two launches, three for an
   f16 y: summed in f32, then rounded once); ``[spmm-wide-half]``
   spmm(bsr_h, X, method="pallas_bsr") on the FEM matrix at k = 128; each
   with its operand in the half type and in f32, against its twin and
   scipy f64 of the rounded inputs.
19c. trisolve — the level-scheduled solve (``trisolve``, exact: f64 against
   scipy's ``spsolve_triangular``) and five Jacobi sweeps (five ``dia_spmv``
   launches; five ``dia_spmm`` on an (n, 32) block) on the lower and upper
   triangles of the 4,194,304-row stencil, each held to its twin's sweeps
   and to the same sweeps in scipy f64.
19d. ilu-cg — the slice's main path: ``cg(solver_operator(S), b, M=...)`` on
   S = I + that stencil in f64 and f32, with ``ilu0(S)`` (the native core)
   applied exactly (``apply``) and by five Jacobi sweeps a triangle
   (``jacobi_applier(5)``: ten ``dia_spmv`` launches an apply), ``ic0(S)``
   and ``ssor(S, 1.0)``, and no preconditioner; the operator's kernel once
   an iteration, each true residual in f64 on the host, the f32 solves
   within 2 iterations of the f64 ones.
19e. ilu-device — Chow–Patel ``ilu0_device(S, sweeps=8)`` at full size: its
   fixed-point residual and its distance to the host factors.
19f. spgemm — ``spgemm`` of the 1,048,576-row stencil by itself and by
   ``random_uniform(1_048_576, density=5e-6)`` (auto: the plan path, C on
   the card) and of ``power_law(10_000, avg_degree=8)`` by itself (auto: the
   native core, above 30 M products), f32 and f64 against scipy; each plan's
   gather numeric and its POH numeric (``bind_poh``: one ``poh_spmv``
   launch); ``sp_add`` and ``shift_identity``.  The port's native core is
   built with g++ beside the kernels in phase 2 (``[native]``).
20. timing — each kernel entry, its plain twin and the one PyTorch call
   that computes the same product (a cuSPARSE product through
   ``torch.sparse_csr_tensor``; in bf16 or f16 for the half entries, or
   the refusal where torch does not take it on CUDA), with CUDA events,
   beside the entry's bound; the DIA and ring SpMM rows also print the
   time PERF.md records for their kernels before the window, the BSR SpMM
   and BDIA SpMV rows theirs before their redesign.  Then the slice's paths
   that are no kernel of their own: the exact ILU(0) apply (beside two
   ``torch.triangular_solve`` calls on the sparse factors), its Jacobi
   apply and SpGEMM's gather numeric (beside a cuSPARSE sparse product),
   and the tuned FEM SpMV's winner.
19g. tune — ``tune`` at full width, each with a fresh cache, every
   enumerated variant timed (or refused by a kernel's gate) and each timed
   kernel variant's kernel launched: the FEM matrix at SpMV (the headline:
   its winner must be a kernel variant, its ``roofline_frac`` printed beside
   ``spmv(bsr, x)`` and cuSPARSE), k = 32 and k = 128, ``stencil_2d(2048)``,
   the 1M power law, ``stencil_2d(1024)`` at k = 32, and the 1M stencil and
   ``banded(1_048_576, 4)`` under a random symmetric permutation (RCM;
   ``TunedSpmv.reordered()``); each winner against its twin and scipy f64;
   a second ``tune`` of the FEM matrix on the same cache times nothing; the
   tuner's host steps (signature, traffic estimates, RCM) timed on the three
   largest matrices.
19h. tune-medium — ``suite("medium")`` (BASELINE config 2, about 100k rows,
   operands under the 50 MB L2): each variant's reading, floor and
   plausibility; a 16 MB ``copy_`` for the L2's rate.
19i. calibrate — ``calibrate_poh(force=True)``: the equivalent bytes per
   slot, the probe's pack bytes, the measured :8192/:2048 ratio beside the
   model's.
19j. bench-harness — ``bench_matrix`` on the FEM matrix and
   ``bench_suite("small")``: JSON lines with their roofline shares.
19k. krylov — over ``solver_operator(S)`` of phase 12 (tol 1e-6, f32):
   ``pipelined_cg``, ``bicgstab``, ``minres``, ``gmres(restart=32)`` and
   ``chebyshev`` with bounds from ``lanczos_extremal(iters=30)``; each
   solve's iterations beside phase 12's CG, its warm time, its true
   residual (f64 host, 1e-5) and its ``dia_spmv`` launches, equal to the
   products its recurrence makes and no other kernel launched (no gather
   route); ``lanczos_extremal`` and ``estimate_lmax`` within 5 % of the
   closed-form top of the spectrum; ``pipelined_cg`` and ``minres`` over
   phase 9's ``BdiaOperator`` too (B2).  Run before the tuner's phases,
   right after ``[spgemm]``, as are 19l-19o.
19l. ir — ``ir_solve`` on the f64 DIA plan of S (inner ``cg`` on its f32
   copy; both plans through the DIA SpMV kernel) to a true 1e-12, beside an
   f64 ``cg`` to 1e-12.
19m. amg — ``smoothed_aggregation_amg(stencil_2d(1024))`` (1,048,576 rows,
   f32 apply): host set-up split into strength, aggregation (the native
   core), plans and the rest; level sizes and routes; one V-cycle by CUDA
   events with its ``dia_spmv`` and ``poh_spmv`` launches (each nonzero),
   within 1e-5 of a scipy f64 V-cycle over levels rebuilt here; CG to
   1e-6 with no preconditioner, Jacobi, ``block_jacobi(64)``,
   ``chebyshev_precond`` (degree 8 over Jacobi, Lanczos bounds) and the
   V-cycle.
19n. eig — ``lobpcg`` on the eigenvalues example's case to convergence
   (``stencil_2d(100)`` f64, k = 4: smallest with IC(0), largest plain;
   Ritz values within 1e-6 of the closed form), then 10 and 20 iterations
   on ``stencil_2d(1024)`` f32 at k = 8 from one start block (the DIA SpMM
   kernel, k ≤ 64): Ritz values no larger at 20 than at 10, none below the
   closed form's.
19o. lstsq — ``cgls`` on the POH plan of ``random_uniform(2_097_152,
   1_048_576, density=4e-6)`` (8.8 M entries): A and its transposed plan
   through the POH SpMV kernel, two launches an iteration;
   ‖Aᵀ(b − Ax)‖/‖Aᵀb‖ ≤ 1e-5 in f64 on the host.

19p. dist — the multi-device half on one NCCL rank, in process, at BASELINE
   config 5's 10,240,000 rows: ``DistSpmv`` over
   ``fem_bdia_partition(1600, dof=4, nshards=1)`` with the ``"fused"`` (B1)
   and ``"pallas"`` (B2) interiors, ``mm_interior="slab"`` at k = 128 (B6;
   refused with its bytes above the slab's byte cap), the DIA ``"pallas"``
   interior (B9) over ``stencil_dia_partition(3200)``, POH SpMV and SpMM at
   k = 32 (B16, B17: the interior and the exterior pack) over
   ``partition_poh`` of the 1M power law (its defaults: ``poh_plan``'s
   tile and window), COO and the 1×1 grid: each
   kernel launched once a pack a call and no other, y against the plain
   shard formulation and the single-device product, both timed; ``cg`` and
   ``pipelined_cg`` over the FEM SPD system's partition, iterations within
   one of the single-device solve's; ``shard_ilu0``-PCG on
   I + ``stencil_2d(1024)`` against plain CG.
19q. dist-ranks — four gloo ranks on the one card through
   ``cask_tpu_torch.parallel.launch`` (NCCL refuses two ranks on one GPU,
   so every exchanged slice goes through the host), every partition built
   once in this process and shipped: B1, B6, B9, B16 and B17 as shard
   interiors at 4,194,304 rows a matrix (1,048,576 a shard), a DIA
   partition with a remainder, POH and the 2×2 grid; every rank's rows of
   y against its plain shard formulation (POH: the single-device plain
   gather in f64) and the single-device product, its launches; CG and
   pipelined CG across the four shards; ``shard_ilu0``-PCG with four
   blocks against one; each rank's time overlapped, serialized and of the
   exchange alone (four processes sharing one card: not scaling numbers).
   ``[dist]`` also times cuSPARSE on the CSR of each single-device plan
   (built on the card from the plan's arrays) and prints its entry count;
   ``[dist-ranks]`` holds rank 0's slab plan (B6, k = 16) against its twin
   in this process and times it in phase 20.
19r. device-gen — the bench's operands built on the card:
   ``fem_bdia_device(512, dof=4)``, ``stencil2d_dia_device(2048)`` (bit for
   bit its host plan) and ``banded_dia_device(1_048_576, 4)`` (offsets,
   ``ts``, shapes and nonzero pattern of their host plans), their
   generation seconds beside the host plans', each ``spmv`` one kernel
   launch within 1e-5 of its twin; ``poh_synth_device(n_panels=250)``
   (15,000 tiles, a 369 MB pack) checked by ``check_poh``, its ``spmv`` one
   ``poh_spmv`` launch, timed in phase 20 beside cuSPARSE on its CSR.
19s. bench-solve — ``bench_solve(side=2048)``'s ``cg`` and ``pipelined_cg``
   records on the card, beside ``[krylov]``'s; one counted solve of each at
   k = 200, its ``dia_spmv`` launches its products.
19t. profile — ``trace()`` around a warm ``cg`` of 20 iterations over phase
   9's operator: the Chrome trace's size, its ``bdia_spmv`` kernel events
   (equal to the launch counter) and the card's idle share of the range.

The host-side power law (generated once, shared by phases 15-18 and 19p-q) and its
plans add about half a minute of host time.  Every main path (phases 8-19f, 19k-19t)
runs with all launch counts set to 0 just before it and read just after,
and must launch its kernel; its result must match the twin and scipy
(f64, host).  It needs one CUDA device and exits
non-zero without one; any failed check raises.  ``[done]`` gives the
run's seconds by phase (host clock).  The last two lines are
JSON: the kernels that ran (launches, errors and times measured in this
run), then the device.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import tempfile
import time

NX = 512  # FEM grid side: 512² nodes × dof 4 = 1,048,576 rows
DOF = 4
GRID_SPMV = 2048  # stencil side for spmv/cg: 4,194,304 rows, 83.9 MB of f32 values
GRID_SPMM = 1024  # stencil side for spmm: 1,048,576 rows, X and Y 134 MB each
K = 32
K_WIDE = 128  # BASELINE config 3's wide k; above 64 the BDIA plan's wide-k chain
PL_N = 1_000_000  # power-law rows and columns for the unstructured path
PL_DEGREE = 12
PL_SEED = 3
BAND_N, BAND_W = 1_048_576, 4  # banded(BAND_N, BAND_W): the RCM variants' band, permuted
GRID_SPGEMM = 1024  # stencil side for A·A and A·B on the SpGEMM plan path: 26.2 M products
SPGEMM_B_DENSITY = 5e-6  # B = random_uniform(1_048_576, density=5e-6, seed=1)
PL_SMALL_N = 10_000  # power_law(10_000, avg_degree=8, seed=3): A·A, 39.3 M products (native)
JACOBI_SWEEPS = 5  # Jacobi-Richardson sweeps a triangle
SCIPY_COLS = 8  # columns of a k = 128 product also held against scipy f64 on the host
SEED = 0
F32_TOL = 1e-5  # normwise relative; f32 sums of a few dozen products, same order
F64_TOL = 1e-12  # same products in the same order as the twin
TF32_TOL = 2e-6  # the f32 slab's 4xTF32 products where one TF32 pass misses by > 1e-5
BF16_TOL = 1e-5  # f32 out, kernel vs twin: the same bf16 products summed in f32
BF16_SLAB_TOL = 2e-6  # f32 out, the bf16 slab's two TF32 passes vs its twin
BF16_KS = (1, 12, 32, 65, 128)  # 12 and 65: bf16 rows off the 16-byte vectors
F32_PEAK = 67e12  # FLOP/s, FP32 outside the tensor cores, H100 SXM (NVIDIA data sheet)
KERNELS = ("bdia_spmv", "dia_spmv", "dia_spmm", "bdia_slab_spmm", "bdia_spmm", "bsr_spmm",
           "poh_spmv", "poh_spmm", "lell_spmv")
BDIA_PY = "cask_tpu/ops/pallas/bdia_kernels.py"
DIA_PY = "cask_tpu/ops/pallas/dia_kernels.py"
SLAB_PY = "cask_tpu/ops/pallas/bdia_slab.py"
BSR_PY = "cask_tpu/ops/pallas/bsr_kernels.py"
POH_PY = "cask_tpu/ops/pallas/poh_kernels.py"
LELL_PY = "cask_tpu/ops/pallas/lell_kernels.py"

# the times of the DIA and ring SpMM [timing] rows (B4, B12-B15) before the
# kernels read X through a window, in us, as PERF.md §6 records them
# (NVIDIA H100 80GB HBM3, 700 W): printed beside this run's
BEFORE_WINDOW_US = {
    f"dia_spmm f32 [spmm(csr, X), k={K}]": 139.3,
    f"dia_spmm f32 [spmm(bsr, X), k={K}]": 475.9,
    f"bdia_spmm_ring f32 [spmm(plan, X, method='pallas_bdia'), k={K_WIDE}]": 971.3,
    f"dia_spmm f32 [spmm(scalar-DIA plan, X), k={K_WIDE}]": 1775.7,
    f"dia_spmm f16 [spmm(csr_f16, X f32), k={K}]": 136.6,
    **{name.format(h=h, K=K, K_WIDE=K_WIDE): us
       for name, uss in (("dia_spmm {h} [spmm(bsr_{h}, X f32), k={K}]", (477.1, 476.7)),
                         ("bdia_spmm_ring {h} [spmm(plan_{h}, X f32, method='pallas_bdia'), "
                          "k={K_WIDE}]", (953.6, 955.9)),
                         ("bdia_spmm_ring {h} [X and Y {h}: accum_dtype={h}], k={K_WIDE}",
                          (896.5, 895.0)),
                         ("dia_spmm {h} [spmm(scalar-DIA plan_{h}, X f32), k={K_WIDE}]",
                          (1724.9, 1722.1)),
                         ("dia_spmm {h} [X and Y {h}: out_dtype={h}], k={K_WIDE}",
                          (1013.1, 966.6)))
       for h, us in zip(("bf16", "f16"), uss)},
}
# the times of the BSR SpMM and BDIA SpMV [timing] rows (B7, B1/B2) before
# their redesign (values staged, a block of x in one vector), in us, as
# PERF.md §6 records them (NVIDIA H100 80GB HBM3, 700 W): printed beside
# this run's
BEFORE_REDESIGN_US = {
    "bdia_spmv f32 [spmv(bsr, x)]": 39.4,
    "bdia_spmv f32 [BdiaOperator in cg]": 38.8,
    "bdia_spmv f16 [spmv(bsr_f16, x f16): f16 y]": 30.0,
    f"bsr_spmm f32 [spmm(bsr, X, method='pallas_bsr'), k={K_WIDE}]": 679.0,
    **{f"bdia_spmv {h} [spmv(bsr_{h}, x f32)]": us for h, us in (("bf16", 28.9), ("f16", 29.0))},
    **{f"bdia_spmv {h} [BdiaOperator({h} plan) in cg]": 29.0 for h in ("bf16", "f16")},
    **{f"bsr_spmm {h} [spmm(bsr_{h}, X {x}, method='pallas_bsr'), k={K_WIDE}]": us
       for h, x, us in (("bf16", "bf16", 687.4), ("f16", "f16", 675.4),
                        ("bf16", "f32", 697.2), ("f16", "f32", 691.4))},
}
# the windowed kernels (mangled names), summarised per source: no spills allowed
WINDOWED = r"b?dia_spmm_kernelI\w+?EEv"
# the BSR SpMM kernel that stages its values in shared memory and the BDIA
# SpMV kernel (a block of x in one vector), mangled names, summarised per
# source: no spills allowed
REDESIGNED_SUMMED = r"(bsr_spmm_staged|bdia_spmv)_kernelI\w+?EEv"

# the instantiations this version redesigned (mangled names): no spills allowed
REDESIGNED = (r"(slab_spmm_tc_kernelI\w+?EEvPK|poh_spmm_kernelI\w+?Li\d+E"
              r"|poh_spmv_kernelI\w+?EEv|lell_\w+?_kernelI\w+?EEv)")


_LAPS = {}  # phase -> seconds, for the [done] line


def _lap(phase: str, t0: float) -> float:
    """Add the seconds since ``t0`` to ``phase``; return the clock now."""
    now = time.perf_counter()
    _LAPS[phase] = _LAPS.get(phase, 0.0) + now - t0
    return now


def _ptxas(log: str):
    """(mangled kernel name, registers, spill bytes) of each entry function
    in an ``nvcc -Xptxas -v`` log."""
    out = []
    for part in log.split("Compiling entry function '")[1:]:
        regs = re.search(r"Used (\d+) registers", part)
        spills = sum(int(v) for v in re.findall(r"(\d+) bytes spill (?:stores|loads)", part))
        out.append((part.split("'", 1)[0], int(regs.group(1)) if regs else 0, spills))
    return out


def _tf32(x):
    """f32 rounded to TF32 (10 explicit mantissa bits) as cvt.rna.tf32.f32."""
    import torch

    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _low_bits(a):
    """``a`` (f32 numpy) with the 12 mantissa bits below TF32's set on every
    nonzero: one TF32 pass rounds each value by about 2^-11."""
    bits = a.view("int32").copy()
    bits[a != 0] |= 0x0FFF
    return bits.view("float32")


def _relerr(y, ref) -> float:
    return float((y.double().cpu() - ref.double().cpu()).norm() / ref.double().cpu().norm())


def _check(name: str, err: float, tol: float) -> None:
    if not err <= tol:
        raise AssertionError(f"{name}: normwise relative error {err:.3e} > {tol:.0e}")


def _card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _counters():
    from cask_tpu_torch.ops.kernels.bdia_kernels import bdia_spmm_ring, bdia_spmv
    from cask_tpu_torch.ops.kernels.bdia_slab_kernels import (bdia_spmm_slab,
                                                              bdia_spmm_slab_padded)
    from cask_tpu_torch.ops.kernels.bsr_kernels import bsr_spmm
    from cask_tpu_torch.ops.kernels.dia_kernels import dia_spmm, dia_spmv
    from cask_tpu_torch.ops.kernels.lell_kernels import lell_spmv
    from cask_tpu_torch.ops.kernels.poh_kernels import poh_spmm, poh_spmv

    return {"bdia_spmv": bdia_spmv, "dia_spmv": dia_spmv, "dia_spmm": dia_spmm,
            "bdia_spmm_slab": bdia_spmm_slab, "bdia_spmm_slab_padded": bdia_spmm_slab_padded,
            "bdia_spmm_ring": bdia_spmm_ring, "bsr_spmm": bsr_spmm, "poh_spmv": poh_spmv,
            "poh_spmm": poh_spmm, "lell_spmv": lell_spmv}


def _reset() -> None:
    for fn in _counters().values():
        fn.launches = 0


def _launched(kernel: str, what: str) -> int:
    """The launch count of ``kernel`` since the last reset; raises at 0."""
    n = _counters()[kernel].launches
    if n < 1:
        raise AssertionError(f"{what} did not launch the {kernel} kernel")
    return n


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


def _dia_cases():
    """name -> scipy f64 CSR of the small DIA plans."""
    import numpy as np
    import scipy.sparse as sp

    from cask_tpu_torch.formats.convert import to_scipy
    from cask_tpu_torch.formats.generate import banded, stencil_2d

    def diags(m, n, offsets, seed):
        rng = np.random.default_rng(seed)
        lens = [min(m, n - k) if k >= 0 else min(m + k, n) for k in offsets]
        return sp.diags([rng.standard_normal(ln) for ln in lens], offsets, shape=(m, n)).tocsr()

    def remainder():
        s = to_scipy(banded(9000, 2, seed=1)) + to_scipy(banded(9000, 12, density=0.05, seed=3))
        rng = np.random.default_rng(4)
        r, c = rng.integers(0, 9000, 20), rng.integers(0, 9000, 20)
        return (s + sp.csr_matrix((rng.standard_normal(20), (r, c)), shape=s.shape)).tocsr()

    return {
        "stencil_2d(95)": to_scipy(stencil_2d(95)),
        "banded(9000,3)": to_scipy(banded(9000, 3, seed=2)),
        "remainder": remainder(),
        "offsets[1,3,7]": diags(2000, 2000, [1, 3, 7], 7),
        "offsets[-5,-2,0]": diags(2000, 2000, [-5, -2, 0], 8),
        "3000x1200": diags(3000, 1200, [-1500, -2, 0, 1, 700], 9),
        "1200x3000": diags(1200, 3000, [-700, -1, 0, 2, 1500], 10),
        "tall 20000x5000, transposed": diags(20000, 5000, [0, -1], 11),
    }


def _blocks_on(nb, b, offsets, seed):
    """Random b×b blocks on the given block offsets, as scipy f64 CSR."""
    import numpy as np
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    s = sp.lil_matrix((nb * b, nb * b))
    for i in range(nb):
        for d in offsets:
            if 0 <= i + d < nb:
                s[i * b : (i + 1) * b, (i + d) * b : (i + d + 1) * b] = rng.standard_normal((b, b))
    return s.tocsr()


def _slab_cases():
    """name -> BSR (f64, host) of the small wide-k plans."""
    import numpy as np

    from cask_tpu_torch.formats.convert import csr_to_bsr, from_scipy, to_scipy
    from cask_tpu_torch.formats.generate import fem_blocks

    def bsr(s):
        return csr_to_bsr(from_scipy(s.tocsr()), (4, 4))

    eight = (-70, -49, -33, -17, -1, 0, 1, 17, 33, 49, 70)  # W = 8 + 64·9 = 584 at g = 16
    return {
        "fem dof2": fem_blocks(16, dof=2, return_bsr=True),
        "fem dof4": fem_blocks(16, dof=4, return_bsr=True),
        "remainder": _remainder_matrix(np.float64),
        "far ±18 (g=16 does not divide)": bsr(_blocks_on(128, 4, (-18, 0, 18), 33)),
        "no far offsets": bsr(_blocks_on(96, 4, (-1, 0, 1), 31)),
        "one asymmetric far offset": bsr(_blocks_on(128, 4, (0, 1, 16), 32)),
        "eight far offsets (W=584)": bsr(_blocks_on(160, 4, eight, 34)),
        "ragged 517x576": bsr(to_scipy(fem_blocks(12, dof=4))[:517]),
    }


def _poh_cases():
    """name -> (scipy f64 CSR, poh_plan arguments): the edge plans of the JAX
    package's POH tests, and a Matrix Market graph through ``read_mtx``."""
    import os

    import numpy as np
    import scipy.sparse as sp

    from cask_tpu_torch.formats.convert import to_scipy
    from cask_tpu_torch.formats.generate import banded, power_law, random_uniform
    from cask_tpu_torch.formats.mtx import read_mtx

    def ru(*args, **kw):
        return to_scipy(random_uniform(*args, **kw))

    holes = ru(400, 400, density=0.02, seed=8).tolil()
    holes[100:200, :] = 0
    holes[:, 100:200] = 0
    m = 3000
    column = sp.csr_matrix((np.random.default_rng(0).standard_normal(m),
                            (np.arange(m), np.full(m, 7))), shape=(m, m))
    pl4k = to_scipy(power_law(4000, avg_degree=8, seed=9))
    mtx = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "data",
                       "graph_pattern_120.mtx")
    return {
        "power_law(5000)": (to_scipy(power_law(5000, avg_degree=12, seed=1)), {}),
        "3000x4700": (ru(3000, 4700, density=0.002, seed=2), {}),
        "4700x1100": (ru(4700, 1100, density=0.002, seed=3), {}),
        "banded(2000,9)": (to_scipy(banded(2000, 9, seed=4)), {}),
        "dense column": (column, {}),
        "empty rows and columns": (holes.tocsr(), {}),
        "all-zero 300x500": (sp.csr_matrix((300, 500)), {}),
        "n below the window": (ru(5000, 300, density=0.01, seed=7), {}),
        "50x70": (ru(50, 70, density=0.05, seed=6), {}),
        "row_panel=1024": (pl4k, {"row_panel": 1024}),
        "col_window=512": (pl4k, {"col_window": 512}),
        "tile_slots=1024": (pl4k, {"tile_slots": 1024}),
        "tile_slots=8192": (pl4k, {"row_panel": 8192, "tile_slots": 8192}),
        "graph_pattern_120.mtx": (to_scipy(read_mtx(mtx)), {}),
        "hub row (a cut panel)": (_hub_row(), {}),
        "one row per panel": (_one_row_per_panel(), {}),
        "one tile per panel": (ru(12000, 6000, density=5e-5, seed=81), {}),
    }


def _one_row_per_panel():
    """Two panels whose live slots each hold one row (rows 7 and 5000):
    every slot takes the SpMV kernel's heavy-row path."""
    import numpy as np
    import scipy.sparse as sp

    rng = np.random.default_rng(80)
    rows = np.repeat([7, 5000], [3000, 2500])
    cols = np.concatenate([rng.choice(9000, 3000, replace=False),
                           rng.choice(9000, 2500, replace=False)])
    return sp.csr_matrix((rng.standard_normal(5500), (rows, cols)), shape=(8192, 9000))


def _hub_row():
    """20,000 rows of 4 entries and row 5 with 15,000: its panel holds twice
    the mean tile count, so the POH SpMM kernel cuts it into pieces."""
    import numpy as np
    import scipy.sparse as sp

    from cask_tpu_torch.formats.convert import to_scipy
    from cask_tpu_torch.formats.generate import random_uniform

    s = to_scipy(random_uniform(20000, 20000, density=2e-4, seed=47))
    rng = np.random.default_rng(48)
    hub = sp.csr_matrix((rng.standard_normal(15000),
                         (np.full(15000, 5), rng.choice(20000, 15000, replace=False))),
                        shape=s.shape)
    return (s + hub).tocsr()


def _lell_cases():
    """name -> scipy f64 CSR of the small LELL plans; the last is wider than
    the reference kernel's 4096·B columns at groups 8 and 16."""
    from cask_tpu_torch.formats.convert import to_scipy
    from cask_tpu_torch.formats.generate import power_law, random_uniform

    return {
        "uniform 2000": to_scipy(random_uniform(2000, density=0.008, seed=3)),
        "power_law(3000)": to_scipy(power_law(3000, avg_degree=10, seed=6)),
        "1500x900": to_scipy(random_uniform(1500, 900, density=0.01, seed=7)),
        "500x70000 (past the reference's cap)": to_scipy(
            random_uniform(500, 70_000, density=2e-4, seed=43)),
        "hub rows across blocks": _hub_rows_across_blocks(),
    }


def _hub_rows_across_blocks():
    """The hub-row matrix with rows 40-42 of 3000 entries more: row 5's
    hub slot rows span several of a block's eight, and rows 40-42 start and
    end inside a block."""
    import numpy as np

    s = _hub_row().tolil()
    for r in (40, 41, 42):
        s[r, :3000] = np.random.default_rng(r).standard_normal(3000)
    return s.tocsr()


LELL_GROUPS = (1, 2, 4, 8, 16, 32, 64, 128)


def _lell_tiers(a, dev):
    """(name, LellMatrix, groups) of the LELL edges of CSR ``a``: every
    group count, one layer (the rest spills to the remainder), two trailing
    layers of padding, and 61 slot rows (not a multiple of a block's 8; the
    rows past them empty)."""
    import torch

    import cask_tpu_torch as ct

    out = [(f"groups={g}", ct.lell_plan(a, groups=g, device=dev), g) for g in LELL_GROUPS]
    out.append(("max_layers=1", ct.lell_plan(a, max_layers=1, device=dev), 8))
    p = ct.lell_plan(a, device=dev)
    pad = torch.zeros((2,) + tuple(p.vals.shape[1:]), dtype=p.vals.dtype, device=p.vals.device)
    out.append(("two trailing padding layers", dataclasses.replace(
        p, vals=torch.cat([p.vals, pad]), idx=torch.cat([p.idx, pad.int()])), 8))
    keep = p.rem_row < 61 * p.groups
    out.append(("61 slot rows", dataclasses.replace(
        p, vals=p.vals[:, :61].contiguous(), idx=p.idx[:, :61].contiguous(),
        rem_data=p.rem_data[keep], rem_row=p.rem_row[keep], rem_col=p.rem_col[keep]), 8))
    return out


def _widened_lell(main, hub, x):
    """The LELL twin on values, remainder and x widened to the kernels'
    working type (f64 for f64, else f32): the sums the output rounds once."""
    import torch

    from cask_tpu_torch.ops.kernels.lell_kernels import lell_spmv_reference

    w = torch.float64 if torch.float64 in (main.vals.dtype, x.dtype) else torch.float32
    main = dataclasses.replace(main, vals=main.vals.to(w), rem_data=main.rem_data.to(w))
    if hub is not None:
        hub = dataclasses.replace(hub, vals=hub.vals.to(w))
    return lell_spmv_reference(main, hub, x.to(w))


def _row_shifted_spd(s):
    """``A + Aᵀ`` (f32 scipy CSR) with each row's diagonal raised by 1.1 × its
    own absolute row sum (1.1 on an empty row): SPD and diagonally dominant
    row by row.  One shift for all rows, scaled by the largest row (a
    power-law hub's), dominates every other row so far that CG stops in two
    iterations; this one leaves Jacobi and CG their work."""
    import numpy as np
    import scipy.sparse as sp

    a = (s + s.T).tocsr()
    d = 1.1 * np.asarray(abs(a).sum(axis=1), np.float64).ravel()
    return (a + sp.diags(np.where(d > 0, d, 1.1))).tocsr().astype(np.float32)


def _relerr_or_zero(y, ref) -> float:
    """:func:`_relerr`, or the norm of ``y`` where the reference is all zero."""
    if float(ref.double().norm()) == 0.0:
        return float(y.double().norm())
    return _relerr(y, ref)


def _sparse_csr(s, dev, dtype):
    """The scipy CSR matrix as a torch sparse CSR tensor on ``dev``, values
    in ``dtype``: the library call's operand (cuSPARSE), timed beside the
    kernels only."""
    import numpy as np
    import torch

    return torch.sparse_csr_tensor(torch.from_numpy(s.indptr.astype(np.int32)),
                                   torch.from_numpy(s.indices.astype(np.int32)),
                                   torch.from_numpy(s.data).to(dtype), size=s.shape).to(dev)


def _pack_bytes(vals, index_bytes: int) -> int:
    """Bytes a slot pack's product must read: every slot's value (0 marks
    padding) and ``index_bytes`` of indices for each live slot only."""
    import torch

    return vals.numel() * vals.element_size() + int(torch.count_nonzero(vals)) * index_bytes


def _spmv_bytes(nnz: int, rows: int, cols: int, vb: int = 4) -> int:
    """Bytes a sparse matrix–vector product must move whatever the format
    that holds the matrix: each entry's value and 4-byte column index, the
    row pointers, x read once and y written once (the bound of a pack that
    pads most of its slots, which the pack's own bytes would flatter)."""
    return nnz * (vb + 4) + (rows + 1) * 4 + (rows + cols) * vb


def _fill(vals) -> float:
    """The share of a slot pack's slots that hold an entry (0 marks padding)."""
    import torch

    return int(torch.count_nonzero(vals)) / vals.numel()


def _short(dtype) -> str:
    """bf16, f16, f32 or f64 for a torch float type."""
    import torch

    return {torch.bfloat16: "bf16", torch.float16: "f16", torch.float32: "f32",
            torch.float64: "f64"}[dtype]


def _half_round(a, dtype):
    """f32 numpy values as the half type ``dtype`` (torch bfloat16 or
    float16) rounds them (to nearest even), as f64."""
    import numpy as np
    import torch

    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype).double().numpy()


def _half_matrix(s, dtype):
    """The scipy matrix a plan of ``s`` with values in the half type
    ``dtype`` holds, in f64."""
    import numpy as np

    out = s.astype(np.float64)
    out.data = _half_round(s.data, dtype)
    return out


def _half_ulps(y, twin32) -> float:
    """The largest distance of a bf16 or f16 ``y`` from the twin's f32
    sums, in ulps of ``y``'s type at each sum, beyond the f32 rounding by
    which two f32 sums of the same products may differ (2^-20 of the
    largest |sum|): at most 1 when ``y`` is each sum rounded once."""
    import torch

    if y.numel() == 0:
        return 0.0
    mant, emin = (7, -126) if y.dtype == torch.bfloat16 else (10, -14)
    y, ref = y.double().cpu(), twin32.double().cpu()
    exp = torch.floor(torch.log2(ref.abs().clamp_min(1e-30))).clamp_min(emin)
    ulp = torch.pow(2.0, exp - mant)
    excess = ((y - ref).abs() - 2.0 ** -20 * float(ref.abs().max())).clamp_min(0)
    return float((excess / ulp).max())


def _check_half_out(name: str, y, twin32) -> float:
    ulps = _half_ulps(y, twin32)
    if not ulps <= 1.0:
        raise AssertionError(f"{name}: {y.dtype} output {ulps:.2f} ulps from the twin's f32 sum")
    return ulps


def small_block_half(rng, dev, h) -> None:
    """[small-bf16] and [small-f16]: the BDIA SpMV, DIA SpMV and SpMM, ring
    and slab kernels against their twins on the small plans of the f32
    phases, for every type combination of the half path of ``h`` (values,
    operand: H/H, H/f32, f32/H; SpMM out f32 or H; SpMV out f16 for f16
    values and x, else f32), SpMV and SpMM at k in BF16_KS, the slab in both
    frames; then the slabs' error class against f64 (the plain FP32 twin's
    error times 4 at most)."""
    import numpy as np
    import torch

    import cask_tpu_torch as ct
    from cask_tpu_torch.formats.convert import csr_to_bsr, from_scipy
    from cask_tpu_torch.formats.generate import fem_blocks
    from cask_tpu_torch.ops.bdia_slab import slab_auto_plan
    from cask_tpu_torch.ops.kernels.bdia_kernels import (bdia_spmm_ring,
                                                         bdia_spmm_ring_reference, bdia_spmv,
                                                         bdia_spmv_reference)
    from cask_tpu_torch.ops.kernels.bdia_slab_kernels import (bdia_spmm_slab,
                                                              bdia_spmm_slab_padded,
                                                              bdia_spmm_slab_reference)
    from cask_tpu_torch.ops.kernels.dia_kernels import (dia_spmm, dia_spmm_reference,
                                                        dia_spmv, dia_spmv_reference)

    f32, ht = torch.float32, _short(h)
    phase = f"small-{ht}"
    combos = ((h, h), (h, f32), (f32, h))  # values, operand: at least one H
    worst = {}  # kernel -> (worst f32-out normwise error, worst half-out ulps)
    n_checks = 0

    def note(kernel, what, y, twin32, tol):
        """Hold ``y`` to the twin's f32 result ``twin32``: a half ``y``
        within one ulp, an f32 one normwise within ``tol``."""
        nonlocal n_checks
        e, u = worst.get(kernel, (0.0, 0.0))
        if y.dtype == h:
            u = max(u, _check_half_out(what, y, twin32))
        else:
            if y.dtype != f32:
                raise AssertionError(f"{what}: output {y.dtype}, not float32 or {h}")
            err = _relerr(y, twin32)
            _check(what, err, tol)
            e = max(e, err)
        worst[kernel] = (e, u)
        n_checks += 1

    def operand(shape, dt):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev).to(dt)

    def spmv_out(vdt, xdt):
        return torch.float16 if (vdt, xdt) == (torch.float16, torch.float16) else f32

    bdia_cases = [(f"fem{nx}_dof{dof}", fem_blocks(nx, dof=dof, dtype=np.float32,
                                                     return_bsr=True))
                  for nx in (16, 33) for dof in (2, 4, 8)]
    bdia_cases += [("remainder", _remainder_matrix(np.float32)),
                   ("rect4x2", csr_to_bsr(fem_blocks(6, dof=4, dtype=np.float32), (4, 2)))]
    for name, bsr in bdia_cases:
        plan32 = ct.bdia_plan(bsr, device=dev)
        for vdt, xdt in combos:
            plan = plan32.astype(vdt)
            x = operand(bsr.shape[1], xdt)
            y = bdia_spmv(plan, x)
            if y.dtype != spmv_out(vdt, xdt):
                raise AssertionError(f"{name} {vdt}/{xdt} bdia_spmv: out {y.dtype}")
            note("bdia_spmv", f"{name} {vdt}/{xdt} bdia_spmv", y,
                 bdia_spmv_reference(plan.astype(f32), x.float()), BF16_TOL)
            if plan.npairs > 80:
                continue
            for k in BF16_KS:
                X = operand((bsr.shape[1], k), xdt)
                for out in (f32, h):
                    note("bdia_spmm_ring", f"{name} {vdt}/{xdt} ring k={k} out {out}",
                         bdia_spmm_ring(plan, X, out_dtype=out),
                         bdia_spmm_ring_reference(plan, X, out_dtype=f32), BF16_TOL)
    for name, s64 in _dia_cases().items():
        s = s64.astype(np.float32)
        plan32 = ct.dia_plan(from_scipy(s), device=dev)
        if name.endswith("transposed"):
            plan32, s = ct.transposed(plan32), s.T.tocsr()
        for vdt, xdt in combos:
            plan = plan32.astype(vdt)
            x = operand(s.shape[1], xdt)
            y = dia_spmv(plan, x)
            if y.dtype != spmv_out(vdt, xdt):
                raise AssertionError(f"{name} {vdt}/{xdt} dia_spmv: out {y.dtype}")
            note("dia_spmv", f"{name} {vdt}/{xdt} dia_spmv", y,
                 dia_spmv_reference(plan.astype(f32), x.float()), BF16_TOL)
            for k in BF16_KS:
                X = operand((s.shape[1], k), xdt)
                for out in (f32, h):
                    note("dia_spmm", f"{name} {vdt}/{xdt} dia_spmm k={k} out {out}",
                         dia_spmm(plan, X, out_dtype=out),
                         dia_spmm_reference(plan, X, out_dtype=f32), BF16_TOL)
    widths = set()
    for name, b64 in _slab_cases().items():
        plan32 = ct.bdia_plan(b64.astype(np.float32), device=dev)
        for vdt, xdt in combos:
            sl = slab_auto_plan(plan32.astype(vdt))
            widths.add((sl.g, sl.width))
            for k in BF16_KS:
                X = operand((b64.shape[1], k), xdt)
                frames = [(False, X)] + ([(True, sl.to_padded(X))]
                                         if sl.blocksize[0] == sl.blocksize[1] else [])
                for padded, xin in frames:
                    entry = bdia_spmm_slab_padded if padded else bdia_spmm_slab
                    for out in (f32, h):
                        note("bdia_spmm_slab", f"{name} {vdt}/{xdt} slab{' padded' * padded} "
                             f"k={k} out {out}", entry(sl, xin, out_dtype=out),
                             bdia_spmm_slab_reference(sl, xin, padded=padded, out_dtype=f32),
                             BF16_SLAB_TOL)
    torch.cuda.synchronize()
    print(f"[{phase}] {n_checks} products (type combinations values/operand "
          f"{', '.join(f'{_short(v)}/{_short(x)}' for v, x in combos)}; out f32 and "
          f"{ht} for SpMM, SpMV out {'f16 for f16/f16, else ' if h == torch.float16 else ''}"
          f"f32; k in {'/'.join(map(str, BF16_KS))}; {len(bdia_cases)} BDIA, "
          f"{len(_dia_cases())} DIA and {len(_slab_cases())} slab plans, slab (g, W) "
          f"{sorted(widths)}, natural and padded frames): kernel vs twin worst "
          + ", ".join(f"{k} {e:.2e} (f32 out) / {u:.2f} ulp ({ht} out)"
                      for k, (e, u) in worst.items())
          + f"; tol {BF16_TOL:.0e}, slab {BF16_SLAB_TOL:.0e}, {ht} out 1 ulp", flush=True)

    # the slabs' error class (f32 slab 4xTF32; half slabs or X two passes, f16
    # with f16 one): each kernel within 4x of its plain FP32 twin's error
    # against f64
    base = fem_blocks(16, dof=4, dtype=np.float32, return_bsr=True)
    low = dataclasses.replace(base, data=_low_bits(np.asarray(base.data)))
    xs = rng.standard_normal((base.shape[1], K_WIDE)).astype(np.float32)
    rows = []
    kinds = ((f32, f32), (h, f32), (f32, h)) if h == torch.bfloat16 else combos
    for case, bsr, xh in (("headline-shaped", base, xs), ("TF32-sensitive", low, _low_bits(xs))):
        plan32 = ct.bdia_plan(bsr, device=dev)
        for vdt, xdt in kinds:
            sl = slab_auto_plan(plan32.astype(vdt))
            x = torch.from_numpy(xh).to(dev).to(xdt)
            s64 = dataclasses.replace(sl, slabs=sl.slabs.double())
            exact = bdia_spmm_slab_reference(s64, x.double())
            y = bdia_spmm_slab(sl, x, out_dtype=f32)
            torch.cuda.synchronize()
            e_k = _relerr(y, exact)
            e_t = _relerr(bdia_spmm_slab_reference(sl, x, out_dtype=f32), exact)
            if not e_k <= 4 * e_t:
                raise AssertionError(f"{case} slab {vdt}/{xdt}: kernel error {e_k:.2e} above "
                                     f"4x the FP32 twin's {e_t:.2e}")
            rows.append(f"{case} {_short(vdt)}/{_short(xdt)} {e_k:.2e} vs twin {e_t:.2e} "
                        f"({e_k / e_t:.2f}x)")
    print(f"[{phase}] slab error class vs f64 (kernel vs plain FP32 twin, k {K_WIDE}, f32 "
          f"out; gate 4x the twin's error on every case): " + "; ".join(rows), flush=True)


HALF_KS = (1, 12, 32, 65, 128)  # BSR SpMM's k at small size (12, 65: off the 16-byte vectors)


def _half_combos():
    """(values, operand) torch types of the half path of B7 and B16-B18:
    each H or f32, at least one H, for H in bf16 and f16."""
    import torch

    f32 = torch.float32
    return [(v, x) for h in (torch.bfloat16, torch.float16) for v, x in ((h, h), (h, f32),
                                                                        (f32, h))]


def small_half(rng, dev) -> None:
    """[small-half]: the BSR SpMM (B7), POH SpMV and SpMM (B16-B17) and LELL
    (B18) kernels against their twins on the small plans of the f32 phases,
    for every type combination of their half path (values, operand: H/H,
    H/f32, f32/H for H in bf16 and f16).  f32 outputs within BF16_TOL
    normwise of the twin; half outputs (BSR's, the values' type; LELL's f16
    for f16 values and x) within one ulp of the twin's f32 sum."""
    import numpy as np
    import torch

    import cask_tpu_torch as ct
    from cask_tpu_torch.formats.convert import from_scipy
    from cask_tpu_torch.ops.bsr_spmm import BsrSpmmKernel
    from cask_tpu_torch.ops.kernels.bsr_kernels import bsr_spmm, bsr_spmm_reference
    from cask_tpu_torch.ops.kernels.lell_kernels import (lell_lane_sums,
                                                         lell_lane_sums_reference, lell_spmv)
    from cask_tpu_torch.ops.kernels.poh_kernels import (poh_spmm, poh_spmm_reference,
                                                        poh_spmv, poh_spmv_reference)

    f32 = torch.float32
    combos = _half_combos()
    worst = {}  # kernel -> (worst f32-out normwise error, worst half-out ulps)
    n_checks = 0

    def note(kernel, what, y, twin32):
        nonlocal n_checks
        e, u = worst.get(kernel, (0.0, 0.0))
        if y.dtype == f32:
            err = _relerr_or_zero(y, twin32)
            _check(what, err, BF16_TOL)
            e = max(e, err)
        else:
            u = max(u, _check_half_out(what, y, twin32))
        worst[kernel] = (e, u)
        n_checks += 1

    def operand(shape, dt):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev).to(dt)

    for name, (s64, kw) in _poh_cases().items():
        plan32 = ct.poh_plan(from_scipy(s64.astype(np.float32)), device=dev, **kw)
        plans = {f32: (plan32, ct.transposed(plan32))}
        for vdt, xdt in combos:
            if vdt not in plans:
                p = ct.poh_plan(from_scipy(s64.astype(np.float32)).to(dev).astype(vdt), **kw)
                plans[vdt] = (p, ct.transposed(p))
            p, pt = plans[vdt]
            tag = f"{name} {_short(vdt)}/{_short(xdt)}"
            x = operand(p.shape[1], xdt)
            note("poh_spmv", f"{tag} poh_spmv", poh_spmv(p, x), poh_spmv_reference(p, x))
            xt = operand(pt.shape[1], xdt)
            note("poh_spmv", f"{tag} transposed poh_spmv", ct.spmv(pt, xt),
                 poh_spmv_reference(pt, xt))
            for k in (1, 32, 150):
                X = operand((p.shape[1], k), xdt)
                note("poh_spmm", f"{tag} poh_spmm k={k}", poh_spmm(p, X),
                     poh_spmm_reference(p, X))
    for name, s64 in _lell_cases().items():
        s = s64.astype(np.float32)
        tiers = _lell_tiers(from_scipy(s), dev)
        hyb = ct.lell_plan_hyb(from_scipy(s), device=dev)
        tiers += [("hyb grouped", hyb.main, hyb.main.groups), ("hyb hub", hyb.hub, 1)]
        for vdt, xdt in combos:
            x = operand(s.shape[1], xdt)
            for what, tier, g in tiers:
                vals = tier.vals.to(vdt)
                y = lell_lane_sums(vals, tier.idx, x, g)
                twin32 = lell_lane_sums_reference(vals.float(), tier.idx, x.float(), g)
                if y.dtype != lell_lane_sums_reference(vals, tier.idx, x, g).dtype:
                    raise AssertionError(f"{name} {what}: kernel out {y.dtype} is not the "
                                         f"twin's")
                note("lell_spmv", f"{name} {what} {_short(vdt)}/{_short(xdt)} lell_spmv", y,
                     twin32)
                if what == "hyb hub":
                    continue
                # the whole product, f32-summed and rounded once
                main = dataclasses.replace(tier, vals=vals, rem_data=tier.rem_data.to(vdt))
                hub = None
                if what == "hyb grouped":
                    hub = dataclasses.replace(hyb.hub, vals=hyb.hub.vals.to(vdt))
                y = lell_spmv(main, hub, x)
                note("lell_spmv", f"{name} {what} {_short(vdt)}/{_short(xdt)} spmv", y,
                     _widened_lell(main, hub, x))
    for name, b64 in _slab_cases().items():
        p32 = BsrSpmmKernel.plan(b64.astype(np.float32), max(HALF_KS), device=dev)
        for vdt, xdt in combos:
            p = dataclasses.replace(p32, vals=p32.vals.to(vdt))
            for k in HALF_KS:
                X = operand((b64.shape[1], k), xdt)
                y = bsr_spmm(p, X)
                if y.dtype != vdt:
                    raise AssertionError(f"{name} bsr_spmm: out {y.dtype}, not the values' "
                                         f"{vdt}")
                note("bsr_spmm", f"{name} {_short(vdt)}/{_short(xdt)} bsr_spmm k={k}", y,
                     bsr_spmm_reference(dataclasses.replace(p, vals=p.vals.float()),
                                        X.float()))
    torch.cuda.synchronize()
    print(f"[small-half] {n_checks} products (type combinations values/operand "
          f"{', '.join(f'{_short(v)}/{_short(x)}' for v, x in combos)}; "
          f"{len(_poh_cases())} POH plans x spmv, transposed spmv, spmm k in 1/32/150; "
          f"{len(_lell_cases())} LELL matrices x groups 1-128, the edge tiers and both hyb "
          f"tiers, lane sums and spmv; "
          f"{len(_slab_cases())} BSR plans x k in {'/'.join(map(str, HALF_KS))}): kernel vs "
          f"twin worst " + ", ".join(f"{k} {e:.2e} (f32 out) / {u:.2f} ulp (half out)"
                                     for k, (e, u) in worst.items())
          + f"; tol {BF16_TOL:.0e}, half out 1 ulp of the twin's f32 sum", flush=True)


def _build_native():
    """Build the port's copy of the native core with g++ (started beside the
    nvcc builds): (library path, seconds, whether this run built it)."""
    from cask_tpu_torch.native import binding
    from cask_tpu_torch.native import build as native_build

    fresh = not native_build.library_path().exists()
    t0 = time.perf_counter()
    path = native_build.lib_path()
    secs = time.perf_counter() - t0
    if path is None or not binding.available():
        raise AssertionError("the native core did not build (g++ on native/src/preprocess.cpp)")
    return path, secs, fresh


def _csr_of(s):
    """A canonical scipy CSR as the port's host CSR, without a re-sort."""
    import numpy as np

    from cask_tpu_torch.formats.matrix import CSR

    s = s.tocsr()
    s.sum_duplicates()  # canonical: sorted indices, no duplicates
    return CSR(data=s.data, indices=s.indices.astype(np.int32),
               indptr=s.indptr.astype(np.int32), shape=s.shape)


def _sync_seconds(fn):
    """(result, host seconds) of ``fn()`` up to a device synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _jacobi_sweeps_f64(s64, b, lower, sweeps):
    """The Jacobi-Richardson sweeps of a triangle in scipy f64 on the host."""
    import numpy as np
    import scipy.sparse as sp

    d = s64.diagonal()
    strict = (sp.tril(s64, k=-1) if lower else sp.triu(s64, k=1)).tocsr()
    scale = (1.0 / d) if b.ndim == 1 else (1.0 / d)[:, None]
    x = b * scale
    for _ in range(sweeps):
        x = (b - strict @ x) * scale
    return np.asarray(x)


def _all_launches() -> int:
    return sum(fn.launches for fn in _counters().values())


def trisolve_phase(dev, st_sp, rng):
    """[trisolve]: the level-scheduled and the Jacobi solve on the lower and
    upper triangles of the 4M-row stencil, on a vector and an (n, K) block.
    Returns the timing rows of the Jacobi sweeps' kernels and the lower
    triangle's plans."""
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    import torch

    import cask_tpu_torch as ct
    from cask_tpu_torch.ops.kernels.dia_kernels import (dia_spmm, dia_spmm_reference,
                                                        dia_spmv, dia_spmv_reference)
    from cask_tpu_torch.ops.trisolve import jacobi_trisolve_plan, trisolve_plan

    n = st_sp.shape[0]
    rows = []
    b = rng.standard_normal(n)
    B = rng.standard_normal((n, K)).astype(np.float32)
    for side, lower in (("lower", True), ("upper", False)):
        s64 = (sp.tril(st_sp) if lower else sp.triu(st_sp)).tocsr().astype(np.float64)
        a64 = _csr_of(s64)
        plan, t_plan = _sync_seconds(lambda: trisolve_plan(a64, lower=lower, device=dev))
        b_dev = torch.from_numpy(b).to(dev)
        _reset()
        ct.trisolve(a64, b_dev, lower=lower, plan=plan)  # warm
        x, t_lev = _sync_seconds(lambda: ct.trisolve(a64, b_dev, lower=lower, plan=plan))
        if _all_launches():
            raise AssertionError("the level sweep launched a kernel of the port")
        x_sp = spla.spsolve_triangular(s64, b, lower=lower)
        err_lev = _relerr(x, torch.from_numpy(x_sp))
        _check(f"4M {side} trisolve levels f64 vs scipy", err_lev, F64_TOL)
        Xb = ct.trisolve(_csr_of(s64.astype(np.float32)), torch.from_numpy(B).to(dev),
                         lower=lower, plan=plan)
        torch.cuda.synchronize()
        X_sp = spla.spsolve_triangular(s64, B[:, :SCIPY_COLS].astype(np.float64), lower=lower)
        err_blk = _relerr(Xb[:, :SCIPY_COLS], torch.from_numpy(X_sp))
        _check(f"4M {side} trisolve levels f32 (n, {K}) vs scipy f64", err_blk, F32_TOL)
        # Jacobi, f32: five sweeps, each one DIA kernel launch (B8; B12-B15 on the block)
        a32 = _csr_of(s64.astype(np.float32))
        jplan, t_jplan = _sync_seconds(lambda: jacobi_trisolve_plan(a32, lower=lower,
                                                                    device=dev))
        if not isinstance(jplan.strict, ct.DiaMatrix) or jplan.strict.rem_data.numel():
            raise AssertionError(f"the {side} triangle's strict part is not a pure DIA plan")
        b32 = b_dev.float()
        _reset()
        xj, t_jac = _sync_seconds(lambda: ct.trisolve(a32, b32, lower=lower,
                                                      method="jacobi", plan=jplan))
        launches_v = _launched("dia_spmv", f"trisolve({side}, method='jacobi')")
        xj_twin = _jacobi_twin(jplan, b32, dia_spmv_reference)
        err_jt = _relerr(xj, xj_twin)
        _check(f"4M {side} jacobi kernel vs twin", err_jt, F32_TOL)
        x_ref = _jacobi_sweeps_f64(s64, b32.cpu().double().numpy(), lower, JACOBI_SWEEPS)
        err_js = _relerr(xj, torch.from_numpy(x_ref))
        _check(f"4M {side} jacobi vs scipy f64 sweeps", err_js, F32_TOL)
        B_dev = torch.from_numpy(B).to(dev)
        _reset()
        Xj, t_jblk = _sync_seconds(lambda: jplan.solve(B_dev, sweeps=JACOBI_SWEEPS))
        launches_m = _launched("dia_spmm", f"trisolve({side}, (n, {K}), method='jacobi')")
        if (launches_v, launches_m) != (JACOBI_SWEEPS, JACOBI_SWEEPS):
            raise AssertionError(f"{side} jacobi: dia_spmv {launches_v}, dia_spmm {launches_m} "
                                 f"launches, not {JACOBI_SWEEPS} each")
        err_bt = _relerr(Xj, _jacobi_twin(jplan, B_dev, dia_spmm_reference))
        _check(f"4M {side} jacobi (n, {K}) kernel vs twin", err_bt, F32_TOL)
        X_ref = _jacobi_sweeps_f64(s64, B[:, :SCIPY_COLS].astype(np.float64), lower,
                                   JACOBI_SWEEPS)
        _check(f"4M {side} jacobi (n, {K}) vs scipy f64 sweeps",
               _relerr(Xj[:, :SCIPY_COLS], torch.from_numpy(X_ref)), F32_TOL)
        print(f"[trisolve] {side} triangle of stencil_2d({GRID_SPMV}): {n} rows, "
              f"{s64.nnz} entries, {plan.nlevels} levels of at most {plan.max_rows} rows "
              f"({plan.max_ents} entries); plan {t_plan:.1f} s; levels solve f64 {t_lev:.3f} s "
              f"(host clock, a warm call), vs scipy f64 {err_lev:.2e} (tol {F64_TOL:.0e}); "
              f"(n, {K}) f32 vs scipy f64 {err_blk:.2e} on {SCIPY_COLS} columns; jacobi f32, "
              f"{JACOBI_SWEEPS} sweeps (strict part: DIA plan, offsets "
              f"{jplan.strict.offsets}; plan {t_jplan:.1f} s): {t_jac * 1e3:.2f} ms (host "
              f"clock, with its first launch), dia_spmv launches {launches_v}, vs twin "
              f"{err_jt:.2e}, vs scipy f64 sweeps {err_js:.2e} (tol {F32_TOL:.0e}), vs the "
              f"exact solve {_relerr(xj, torch.from_numpy(x_sp)):.2e}; (n, {K}): "
              f"{t_jblk * 1e3:.2f} ms, dia_spmm launches {launches_m}, vs twin {err_bt:.2e}",
              flush=True)
        if lower:
            strict_sp = sp.tril(s64, k=-1).tocsr().astype(np.float32)
            d = jplan.strict
            m_rows = d.shape[0]
            rows += [
                (f"dia_spmv f32 [trisolve(L, b, method='jacobi'): one of {JACOBI_SWEEPS} "
                 f"sweeps, stencil_2d({GRID_SPMV})]", "dia_spmv", f"{DIA_PY}:176 (B8)",
                 lambda d=d, x=b32: dia_spmv(d, x), lambda d=d, x=b32: dia_spmv_reference(d, x),
                 strict_sp, b32, (d.vals.numel() + 2 * m_rows) * 4, 2 * d.vals.numel(),
                 launches_v, float((xj - xj_twin).abs().max()), torch.float32),
                (f"dia_spmm f32 [trisolve(L, B, method='jacobi'), B (n, {K}): one of "
                 f"{JACOBI_SWEEPS} sweeps]", "dia_spmm",
                 f"{DIA_PY}:1148 (B14, k <= 64), :789 (B12)",
                 lambda d=d, X=B_dev: dia_spmm(d, X),
                 lambda d=d, X=B_dev: dia_spmm_reference(d, X), strict_sp, B_dev,
                 (d.vals.numel() + 2 * m_rows * K) * 4, 2 * d.vals.numel() * K, launches_m,
                 float((Xj - _jacobi_twin(jplan, B_dev, dia_spmm_reference)).abs().max()),
                 torch.float32)]
        del plan, Xb, Xj, B_dev
    return rows


def _jacobi_twin(jplan, b, twin):
    """The plan's sweeps with the DIA kernel's plain twin in its place."""
    scale = jplan.dinv if b.ndim == 1 else jplan.dinv[:, None]
    x = b * scale
    for _ in range(JACOBI_SWEEPS):
        x = (b - twin(jplan.strict, x)) * scale
    return x


def ilu_cg_phase(dev, s_sp, card):
    """[ilu-cg]: cg(S, b) on S = I + stencil_2d(GRID_SPMV) with ILU(0) (the
    exact level apply and five Jacobi sweeps a triangle), IC(0), SSOR and no
    preconditioner as M, in f64 and f32.  Returns the host factors and
    timing rows."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    import cask_tpu_torch as ct
    from cask_tpu_torch.ops.kernels.dia_kernels import dia_spmv, dia_spmv_reference

    s64 = s_sp.astype(np.float64)
    b_host = np.random.default_rng(SEED + 1).standard_normal(s_sp.shape[0])
    out = {"rows": [], "extra": []}
    iters = {}
    for dt, np_dt in ((torch.float64, np.float64), (torch.float32, np.float32)):
        ty = _short(dt)
        S = _csr_of(s64.astype(np_dt))
        op = ct.solver_operator(S)
        f, t_ilu = _sync_seconds(lambda: ct.ilu0(S, use_native=True))
        f.jacobi_applier(JACOBI_SWEEPS)  # the Jacobi plans, built once
        ic, t_ic = _sync_seconds(lambda: ct.solvers.ic0(S))
        ss, t_ss = _sync_seconds(lambda: ct.solvers.ssor(S, 1.0))
        print(f"[ilu-cg] {ty}: S = I + stencil_2d({GRID_SPMV}), {S.shape[0]} rows, nnz {S.nnz}: "
              f"ilu0(S, use_native=True) {t_ilu:.1f} s (host: the native core, then the two "
              f"level plans: L {f._lower_plan.nlevels} levels of at most "
              f"{f._lower_plan.max_rows} rows, U {f._upper_plan.nlevels}); ic0 {t_ic:.1f} s, "
              f"ssor {t_ss:.1f} s", flush=True)
        b = torch.from_numpy(b_host.astype(np_dt)).to(dev)
        precs = (("ilu0 levels", f.apply, 0), ("ilu0 jacobi(5)",
                                               f.jacobi_applier(JACOBI_SWEEPS),
                                               2 * JACOBI_SWEEPS),
                 ("ic0 levels", ic.apply, 0), ("ssor(1.0) levels", ss, 0), ("none", None, 0))
        for name, M, per_apply in precs:
            _reset()
            res, t_cg = _sync_seconds(lambda: ct.solvers.cg(op, b, tol=1e-6, maxiter=500, M=M))
            launches = _launched("dia_spmv", f"cg with {name}")
            want = (res.iterations + 1) * (1 + per_apply)
            if launches != want:
                raise AssertionError(f"{ty} cg with {name}: dia_spmv launched {launches} times, "
                                     f"want {want} (the operator once an iteration, "
                                     f"{per_apply} a preconditioner apply)")
            if not res.converged:
                raise AssertionError(f"{ty} cg with {name} did not converge: {res.iterations} "
                                     f"iterations, residual {res.residual_norm:.3e}")
            x64 = res.x.cpu().double().numpy()
            bb = b.cpu().double().numpy()
            true_rel = float(np.linalg.norm(bb - s64 @ x64) / np.linalg.norm(bb))
            if not true_rel <= 1e-5:
                raise AssertionError(f"{ty} cg with {name}: true relative residual "
                                     f"{true_rel:.3e} > 1e-5")
            iters[(ty, name)] = res.iterations
            share = ""
            if M is not None:  # the apply's share of the solve: one apply, timed alone
                _, t_m = _sync_seconds(lambda: M(b))
                share = (f", one apply {t_m * 1e3:.1f} ms, applies "
                         f"{min(t_m * (res.iterations + 1) / t_cg, 1.0):.2f} of the solve")
            print(f"[ilu-cg] {ty} cg(S, b, M={name}), tol 1e-6: {res.iterations} iterations, "
                  f"{t_cg * 1e3:.1f} ms = {t_cg / max(res.iterations, 1) * 1e3:.2f} ms per "
                  f"iteration (host clock){share}; dia_spmv launches {launches}; true "
                  f"relative residual {true_rel:.2e} (f64 host, tol 1e-5)", flush=True)
            if ty == "f32" and name == "ilu0 levels":
                out["rows"].append(
                    ("dia_spmv f32 [solver_operator in cg(S, b, M=ilu0(S).apply)]", "dia_spmv",
                     f"{DIA_PY}:336 (B9), :511 (B10), :650 (B11)",
                     lambda d=op.dia, v=b: dia_spmv(d, v),
                     lambda d=op.dia, v=b: dia_spmv_reference(d, v), s_sp, b,
                     (op.dia.vals.numel() + 2 * op.dia.shape[0]) * 4,
                     2 * op.dia.vals.numel(), launches,
                     float((op(b) - op.dia._spmv_reference(b)).abs().max()), torch.float32))
            if ty == "f32" and name == "ilu0 jacobi(5)":
                lp, _ = f._jacobi_plans()
                strict_sp = sp.tril(ct.to_scipy(f.lu), k=-1).tocsr()
                out["rows"].append(
                    (f"dia_spmv f32 [cg(S, b, M=ilu0(S).jacobi_applier({JACOBI_SWEEPS})): "
                     f"a sweep of L]", "dia_spmv", f"{DIA_PY}:176 (B8)",
                     lambda d=lp.strict, v=b: dia_spmv(d, v),
                     lambda d=lp.strict, v=b: dia_spmv_reference(d, v), strict_sp, b,
                     (lp.strict.vals.numel() + 2 * lp.strict.shape[0]) * 4,
                     2 * lp.strict.vals.numel(), launches - (res.iterations + 1),
                     float((dia_spmv(lp.strict, b) - dia_spmv_reference(lp.strict, b))
                           .abs().max()), torch.float32))
        if ty == "f32":
            lib = _lib_ilu_apply(f, dev, b)
            out["extra"] += [
                ("trisolve levels f32 [ilu0(S).apply(r): L then U, "
                 f"{f._lower_plan.nlevels} + {f._upper_plan.nlevels} levels]",
                 lambda f=f, v=b: f.apply(v), lib),
                (f"trisolve jacobi f32 [ilu0(S).apply(r, method='jacobi'), {JACOBI_SWEEPS} "
                 f"sweeps a triangle: {2 * JACOBI_SWEEPS} dia_spmv launches]",
                 lambda f=f, v=b: f.apply(v, method="jacobi", sweeps=JACOBI_SWEEPS), None)]
            out["f32"] = f
        else:
            out["f64"], out["S64"] = f, S
        del ic, ss
    for name in ("ilu0 levels", "ilu0 jacobi(5)", "ic0 levels", "ssor(1.0) levels", "none"):
        if abs(iters[("f32", name)] - iters[("f64", name)]) > 2:
            raise AssertionError(f"cg with {name}: {iters[('f32', name)]} iterations in f32 "
                                 f"against {iters[('f64', name)]} in f64")
    print(f"[ilu-cg] iterations f64 / f32: " + ", ".join(
        f"{name} {iters[('f64', name)]} / {iters[('f32', name)]}"
        for name in ("ilu0 levels", "ilu0 jacobi(5)", "ic0 levels", "ssor(1.0) levels",
                     "none")) + " (f32 within 2 of f64); card " + card, flush=True)
    return out


def _lib_ilu_apply(f, dev, r):
    """The exact ILU(0) apply through two cuSPARSE triangular solves
    (``torch.triangular_solve`` on the sparse L and U), or the refusal: the
    yardstick beside the level sweep.  (label, callable or None)."""
    import torch

    from cask_tpu_torch.formats.convert import to_scipy

    low, up = f.split()
    L, U = (_sparse_csr(to_scipy(m), dev, torch.float32) for m in (low, up))

    def two_solves(r):
        y = torch.triangular_solve(r[:, None], L, upper=False, unitriangular=True).solution
        return torch.triangular_solve(y, U, upper=True).solution[:, 0]

    try:
        err = _relerr(two_solves(r), f.apply(r))
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        return (f"two torch.triangular_solve on sparse CSR refused: "
                f"{str(e).splitlines()[0][:160]}", None)
    return (f"two torch.triangular_solve on sparse CSR (cuSPARSE), {err:.1e} from the level "
            f"sweep", lambda: two_solves(r))


def ilu_device_phase(dev, S64, f64):
    """[ilu-device]: Chow–Patel ILU(0) at full size against the host factors."""
    import numpy as np
    import torch

    from cask_tpu_torch.ops.ilu import ILU0DeviceFactors, ilu0_device_plan

    plan, t_plan = _sync_seconds(lambda: ilu0_device_plan(S64))
    vals, t_fac = _sync_seconds(lambda: plan.factorize(sweeps=8))
    res = float(plan.residual(vals))
    host = torch.from_numpy(f64.lu.data)
    dist = _relerr(vals, host)
    if not (res <= 1e-4 and dist <= 1e-4):
        raise AssertionError(f"Chow–Patel, 8 sweeps: residual {res:.2e}, distance to the host "
                             f"factors {dist:.2e} (tol 1e-4 each)")
    r = torch.from_numpy(np.random.default_rng(SEED + 2).standard_normal(S64.shape[0])).to(dev)
    z = ILU0DeviceFactors(plan=plan, vals=vals).apply(r)
    z_host = f64.apply(r)
    err = _relerr(z, z_host)
    _check("Chow–Patel apply vs the host factors' apply", err, 1e-3)
    print(f"[ilu-device] ilu0_device(S, sweeps=8) at full size ({S64.shape[0]} rows: the pair "
          f"enumeration is vectorized, its arrays equal the reference's in "
          f"tests/test_torch_trisolve.py): plan {t_plan:.1f} s (host, {plan.pair_out.numel()} "
          f"pairs), 8 sweeps {t_fac * 1e3:.1f} ms (host clock); residual {res:.2e}, distance "
          f"to the host factors {dist:.2e} (tol 1e-4 each); apply vs the host factors' "
          f"{err:.2e} (tol 1e-3)", flush=True)
    del plan, vals


def _rel_sparse(c, ref) -> float:
    """Normwise relative distance of a port CSR (device or host) to a scipy
    matrix, in f64 on the host."""
    import numpy as np
    import scipy.sparse as sp

    from cask_tpu_torch.formats.convert import to_scipy

    d = to_scipy(c).astype(np.float64) - ref
    return float(sp.linalg.norm(d) / sp.linalg.norm(ref))


def spgemm_phase(dev, rng, card):
    """[spgemm]: A·A of the 1M-row stencil and A·B with a random B through
    ``spgemm`` (auto: the plan path), A·A of a power law on the plan path and
    through auto (the native core); each product's POH numeric (A bound, one
    ``poh_spmv`` launch) against the gather numeric; sp_add and
    shift_identity; f32 and f64 against scipy f64.  Returns the timing
    rows."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    import cask_tpu_torch as ct
    from cask_tpu_torch.formats.generate import power_law, random_uniform, stencil_2d
    from cask_tpu_torch.ops.kernels.poh_kernels import poh_spmv, poh_spmv_reference
    from cask_tpu_torch.ops.spgemm import _NATIVE_THRESHOLD, expansion_size, spgemm_plan

    st = stencil_2d(GRID_SPGEMM)
    n = st.shape[0]
    rand_b = random_uniform(n, density=SPGEMM_B_DENSITY, seed=1)
    pl = power_law(PL_SMALL_N, avg_degree=8, seed=3)
    cases = (("A·A, A = stencil_2d", st, st, "plan"), ("A·B, B = random_uniform", st, rand_b,
                                                       "plan"),
             ("A·A, A = power_law", pl, pl, "native"))
    rows, extra = [], []
    for what, a64, b64, auto_route in cases:
        e = expansion_size(a64, b64)
        if (e > _NATIVE_THRESHOLD) != (auto_route == "native"):
            raise AssertionError(f"{what}: expansion {e} against the threshold "
                                 f"{_NATIVE_THRESHOLD} does not give the {auto_route} route")
        ref = (ct.to_scipy(a64) @ ct.to_scipy(b64)).tocsr()
        # the symbolic phase depends on the patterns only: one plan for both types
        plan, t_plan = _sync_seconds(lambda: spgemm_plan(a64, b64))
        for np_dt, tol in ((np.float32, F32_TOL), (np.float64, F64_TOL)):
            ty = _short(torch.float32 if np_dt == np.float32 else torch.float64)
            a, b = a64.astype(np_dt), b64.astype(np_dt)
            c_auto, t_auto = _sync_seconds(lambda: ct.spgemm(a, b))
            # the plan path leaves C on the card, the native core gives a host CSR
            route = "plan" if isinstance(c_auto.data, torch.Tensor) else "native"
            if route != auto_route or (route == "plan" and c_auto.data.device.type != dev.type):
                raise AssertionError(f"{what} {ty}: spgemm(a, b) took the {route} route, "
                                     f"not the {auto_route} route onto {dev}")
            a_d, b_d = torch.from_numpy(a.data).to(dev), torch.from_numpy(b.data).to(dev)
            c, t_num = _sync_seconds(lambda: plan.numeric(a_d, b_d))
            err_num = _rel_sparse(c, ref)
            _check(f"{what} {ty} gather numeric vs scipy", err_num, tol)
            # the plan route's C is the numeric's on the same structure (on the
            # card, summed in another order); the native core's is a host CSR
            err_auto = (_relerr(c_auto.data, c.data) if route == "plan"
                        else _rel_sparse(c_auto, ref))
            _check(f"{what} {ty} spgemm auto vs {'the numeric' if route == 'plan' else 'scipy'}",
                   err_auto, tol)
            del c_auto
            bound, t_bind = _sync_seconds(lambda: plan.bind_poh(a.data, nnz_b=b.nnz))
            _reset()
            cp, t_poh = _sync_seconds(lambda: bound(b_d))
            launches = _launched("poh_spmv", f"{what} {ty} PohNumeric")
            if launches != 1:
                raise AssertionError(f"{what} {ty} PohNumeric launched poh_spmv {launches} "
                                     f"times, not 1")
            err_poh = _relerr(cp.data, c.data)
            _check(f"{what} {ty} POH numeric vs gather numeric", err_poh, tol)
            line = (f"[spgemm] {what} {ty}: expansion {plan.expansion}, C {plan.shape} nnz "
                    f"{plan.nnz}; spgemm(a, b) {t_auto:.2f} s (route {auto_route}), vs "
                    f"{'the numeric' if route == 'plan' else 'scipy f64'} {err_auto:.2e}; "
                    f"plan {t_plan:.2f} s (host, once for both types), "
                    f"numeric {t_num * 1e3:.1f} ms, vs scipy {err_num:.2e}; bind_poh "
                    f"{t_bind:.2f} s ({bound._poh.ntiles} tiles), POH numeric "
                    f"{t_poh * 1e3:.1f} ms (launches {launches}), vs the gather numeric "
                    f"{err_poh:.2e} (tol {tol:.0e})")
            if auto_route == "native":
                c_nat, t_nat = _sync_seconds(lambda: ct.spgemm(a, b, backend="native"))
                if not isinstance(c_nat.data, np.ndarray):
                    raise AssertionError("backend='native' did not give a host CSR")
                line += f"; backend='native' {t_nat:.2f} s (host)"
            print(line + f"; card {card}", flush=True)
            if ty == "f32" and what.startswith("A·A, A = stencil"):
                m_sp = sp.csr_matrix((a.data[plan.src_a], plan.src_b,
                                      np.concatenate([[0], np.cumsum(np.bincount(
                                          plan.out_id, minlength=plan.nnz))])),
                                     shape=(plan.nnz, b.nnz))
                p = bound._poh
                rows.append((f"poh_spmv f32 [PohNumeric: A·A of stencil_2d({GRID_SPGEMM}), A "
                             f"bound]", "poh_spmv", f"{POH_PY}:388 (B16)",
                             lambda p=p, v=b_d: poh_spmv(p, v),
                             lambda p=p, v=b_d: poh_spmv_reference(p, v), m_sp, b_d,
                             _pack_bytes(p.vals, 8) + p.ntiles * 4 + (b.nnz + plan.nnz) * 4,
                             2 * plan.expansion, launches,
                             float((cp.data - poh_spmv_reference(p, b_d)).abs().max()),
                             torch.float32))
                A_lib = _sparse_csr(ct.to_scipy(a), dev, torch.float32)
                extra.append((f"spgemm gather numeric f32 [plan.numeric: A·A of "
                              f"stencil_2d({GRID_SPGEMM}), {plan.expansion} products]",
                              lambda plan=plan, x=a_d, y=b_d: plan.numeric(x, y),
                              _lib_spgemm(A_lib, c)))
            del bound, c, cp
        del plan
    # sp_add and shift_identity on the stencil
    for np_dt, tol in ((np.float32, F32_TOL), (np.float64, F64_TOL)):
        a = st.astype(np_dt)
        s_ref = ct.to_scipy(st)
        c_add, t_add = _sync_seconds(lambda: ct.sp_add(a, a, alpha=2.0, beta=-0.5))
        err_add = _rel_sparse(c_add, 1.5 * s_ref)
        _check(f"sp_add {np_dt.__name__} vs scipy", err_add, tol)
        c_sh, t_sh = _sync_seconds(lambda: ct.shift_identity(a, -2.5))
        err_sh = _rel_sparse(c_sh, s_ref - 2.5 * sp.identity(n, format="csr"))
        _check(f"shift_identity {np_dt.__name__} vs scipy", err_sh, tol)
        if c_add.data.device.type != dev.type or c_sh.data.device.type != dev.type:
            raise AssertionError(f"sp_add / shift_identity did not put C on {dev}")
        print(f"[spgemm] {np_dt.__name__}: sp_add(A, A, 2, -0.5) {t_add:.2f} s (plan + numeric), "
              f"vs scipy f64 {err_add:.2e}; shift_identity(A, -2.5) {t_sh:.2f} s, vs scipy "
              f"{err_sh:.2e} (tol {tol:.0e})", flush=True)
    return rows, extra


def _lib_spgemm(A, c):
    """``A @ A`` of a torch sparse CSR on the card (cuSPARSE SpGEMM), the
    yardstick beside the gather numeric, or the refusal: (label, callable
    or None)."""
    import torch

    try:
        C = A @ A
        torch.cuda.synchronize()
        err = abs(float(C.values().double().sum()) - float(c.data.double().sum()))
    except (RuntimeError, NotImplementedError) as e:
        return (f"torch.sparse_csr_tensor @ torch.sparse_csr_tensor refused: "
                f"{str(e).splitlines()[0][:160]}", None)
    return (f"torch.sparse_csr_tensor @ torch.sparse_csr_tensor (cuSPARSE SpGEMM; sum of C "
            f"{err:.1e} from the numeric's)", lambda: A @ A)


L2_BYTES = 50 * 2**20  # the H100's L2: a working set under it is read from cache when warm
# ---------------------------------------------------------------------------
# the rest of the solver half: [krylov], [ir], [amg], [eig], [lstsq]
# ---------------------------------------------------------------------------

SOLVE_TOL = 1e-6  # each solve's stopping tolerance; its true residual is held to 1e-5
LSQ_M, LSQ_N, LSQ_DENSITY = 2_097_152, 1_048_576, 4e-6  # [lstsq]: 8.8 M entries
EIG_K = 8  # [eig]: lobpcg's block at full size


def _true_rel(s64, x, b64) -> float:
    """‖b − S·x‖/‖b‖ in f64 on the host."""
    import numpy as np

    return float(np.linalg.norm(b64 - s64 @ x.detach().cpu().double().numpy())
                 / np.linalg.norm(b64))


class _LaunchesByPlan:
    """Within its block, the DIA and POH SpMV kernels' launches per plan:
    each call of a plan's SpMV (``DiaMatrix.spmv``, ``PohMatrix.spmv``)
    adds what it advanced the kernel wrapper's own count by to that plan's
    entry.  ``of(plan)`` reads one plan's launches."""

    def __init__(self):
        self._by_id = {}  # id(plan) -> [plan, launches]

    def of(self, plan) -> int:
        return self._by_id.get(id(plan), [plan, 0])[1]

    def plans(self):
        return [p for p, _ in self._by_id.values()]

    def __enter__(self):
        import cask_tpu_torch.ops.dia as dia_mod
        import cask_tpu_torch.ops.poh as poh_mod

        self._saved = [(dia_mod, "dia_spmv", dia_mod.dia_spmv),
                       (poh_mod, "poh_spmv", poh_mod.poh_spmv)]
        for mod, name, fn in self._saved:
            setattr(mod, name, self._counted(fn, _counters()[name]))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)

    def _counted(self, fn, counter):
        def run(plan, *args, **kw):
            before = counter.launches
            out = fn(plan, *args, **kw)
            self._by_id.setdefault(id(plan), [plan, 0])[1] += counter.launches - before
            return out
        return run


def _counted_then_warm(solve, by_plan: _LaunchesByPlan | None = None):
    """Run ``solve`` with every launch count at 0 and read the counts (and,
    given ``by_plan``, each plan's own, in that run only); then once more,
    warm, on the host clock.  (result, counts, warm seconds)."""
    import contextlib

    import torch

    _reset()
    with by_plan if by_plan is not None else contextlib.nullcontext():
        res = solve()
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in _counters().items()}
    _, t_warm = _sync_seconds(solve)
    return res, counts, t_warm


def _only(counts: dict, kernel: str, want, what: str) -> int:
    """The launches of ``kernel``, which must be ``want`` (``None``: any but
    0), with no other kernel launched: every product of the solve went
    through it."""
    got = counts[kernel]
    others = {k: v for k, v in counts.items() if k != kernel and v}
    if (got != want if want is not None else not got) or others:
        raise AssertionError(f"{what}: {kernel} launched {got} times (want "
                             f"{'some' if want is None else want}), others {others}")
    return got


def _laplacian_eigs(nx: int, shift: float = 0.0):
    """Every eigenvalue of ``shift·I + stencil_2d(nx)``, ascending (closed form)."""
    import numpy as np

    c = 2.0 - 2.0 * np.cos(np.pi * np.arange(1, nx + 1) / (nx + 1))
    return np.sort((shift + c[:, None] + c[None, :]).ravel())


def _converged(what: str, res, stopped) -> None:
    """Raise unless ``stopped(res)``: the solve stopped on its own test.  The
    caller also holds the true residual in f64."""
    if not stopped(res):
        raise AssertionError(f"{what} did not converge: {res.iterations} iterations, "
                             f"residual {res.residual_norm:.3e}")


def _loop_stopped(maxiter: int):
    """``pipelined_cg``'s stop rule: its ``converged`` is the true residual's
    test at ``tol``, and in f32 its recurrence residual drifts from b − A·x
    (the reference's does the same: 3.6e-6 relative at tol 1e-6 on a small
    S), so the loop's own stop before ``maxiter`` counts, with the true
    residual held to 1e-5 beside it."""
    return lambda r: r.converged or r.iterations < maxiter


def krylov_phase(dev, card, s_sp, dop, bs, cg_iters, fem_op, fem_b, fem_sp):
    """[krylov]: pipelined CG, BiCGStab, MINRES, GMRES(32) and Chebyshev
    (bounds from ``lanczos_extremal``) over ``solver_operator(S)``, S = I +
    stencil_2d(GRID_SPMV), tol 1e-6; pipelined CG and MINRES also over the
    FEM system's ``BdiaOperator``.  Returns the B9 timing row."""
    import numpy as np
    import torch

    import cask_tpu_torch as ct
    from cask_tpu_torch.ops.kernels.dia_kernels import dia_spmv, dia_spmv_reference

    sv = ct.solvers
    n = s_sp.shape[0]
    s64 = s_sp.astype(np.float64)
    b64 = bs.cpu().double().numpy()
    lam = _laplacian_eigs(GRID_SPMV, 1.0)
    _reset()
    (lmin, lmax), t_lz = _sync_seconds(lambda: sv.lanczos_extremal(dop, n, iters=30))
    n_lz = _launched("dia_spmv", "lanczos_extremal over solver_operator")
    _reset()
    est, t_pw = _sync_seconds(lambda: sv.estimate_lmax(dop, n, iters=20))
    n_pw = _launched("dia_spmv", "estimate_lmax over solver_operator")
    for what, got in (("lanczos_extremal", lmax), ("estimate_lmax", est)):
        if not abs(got / 1.05 - lam[-1]) <= 0.05 * lam[-1]:
            raise AssertionError(f"{what}: lmax {got:.4f} (÷1.05 {got / 1.05:.4f}) is not "
                                 f"within 5 % of the closed form's {lam[-1]:.4f}")
    print(f"[krylov] S = I + stencil_2d({GRID_SPMV}), {n} rows: lanczos_extremal(iters=30) "
          f"({lmin:.4f}, {lmax:.4f}) in {t_lz * 1e3:.1f} ms, {n_lz} dia_spmv launches; "
          f"estimate_lmax(iters=20) {est:.4f} in {t_pw * 1e3:.1f} ms, {n_pw} launches; closed "
          f"form ({lam[0]:.6f}, {lam[-1]:.6f}) (the estimates nudged x0.95 and x1.05)",
          flush=True)
    maxiter_gmres = 50

    def gmres_products(k):  # a test of ‖M(b − Ax)‖ before each cycle, restart + 1 a cycle
        return (k + 1 if k < maxiter_gmres else k) + 33 * k + 1

    converged = lambda r: r.converged  # noqa: E731
    cases = (
        ("pipelined_cg", lambda: sv.pipelined_cg(dop, bs, tol=SOLVE_TOL, maxiter=500),
         lambda k: k + 3, "2 before the loop, 1 an iteration, 1 after", _loop_stopped(500)),
        ("bicgstab", lambda: sv.bicgstab(dop, bs, tol=SOLVE_TOL, maxiter=500),
         lambda k: 2 * k + 1, "1 before the loop, 2 an iteration", converged),
        ("minres", lambda: sv.minres(dop, bs, tol=SOLVE_TOL, maxiter=500),
         lambda k: k + 2, "1 before the loop, 1 an iteration, 1 after", converged),
        ("gmres(restart=32)", lambda: sv.gmres(dop, bs, tol=SOLVE_TOL, restart=32,
                                               maxiter=maxiter_gmres),
         gmres_products, "1 a convergence test, 33 a cycle, 1 after", converged),
        ("chebyshev(lanczos bounds)", lambda: sv.chebyshev(dop, bs, lmin=lmin, lmax=lmax,
                                                            tol=SOLVE_TOL, maxiter=2000),
         lambda k: k + 1, "1 before the loop, 1 an iteration", converged),
    )
    total = 0
    for name, solve, products, rule, stopped in cases:
        res, counts, t_warm = _counted_then_warm(solve)
        _converged(f"[krylov] {name}", res, stopped)
        launches = _only(counts, "dia_spmv", products(res.iterations), f"[krylov] {name}")
        total += launches
        rel = _true_rel(s64, res.x, b64)
        if not rel <= 1e-5:
            raise AssertionError(f"[krylov] {name}: true relative residual {rel:.3e} > 1e-5")
        print(f"[krylov] {name}(S, b), tol {SOLVE_TOL:.0e}: {res.iterations} iterations (cg "
              f"{cg_iters}, [dia-cg]), converged {res.converged}, warm solve "
              f"{t_warm * 1e3:.2f} ms = {t_warm / max(res.iterations, 1) * 1e3:.3f} ms an "
              f"iteration (host clock); dia_spmv launches {launches} ({rule}); true relative "
              f"residual {rel:.2e} (f64 host, tol 1e-5); card {card}", flush=True)
    fem64 = fem_sp.astype(np.float64)
    fb64 = fem_b.cpu().double().numpy()
    for name, solve, products, stopped in (
            ("pipelined_cg", lambda: sv.pipelined_cg(fem_op, fem_b, tol=SOLVE_TOL, maxiter=500),
             lambda k: k + 3, _loop_stopped(500)),
            ("minres", lambda: sv.minres(fem_op, fem_b, tol=SOLVE_TOL, maxiter=500),
             lambda k: k + 2, converged)):
        res, counts, t_warm = _counted_then_warm(solve)
        _converged(f"[krylov] {name} over the FEM BdiaOperator", res, stopped)
        launches = _only(counts, "bdia_spmv", products(res.iterations),
                         f"[krylov] {name} over the FEM BdiaOperator")
        rel = _true_rel(fem64, res.x, fb64)
        if not rel <= 1e-5:
            raise AssertionError(f"[krylov] {name} (FEM): true relative residual {rel:.3e}")
        print(f"[krylov] {name}(BdiaOperator, b) on the FEM SPD system ([cg]), {fem_sp.shape[0]} "
              f"rows: {res.iterations} iterations, converged {res.converged}, warm solve "
              f"{t_warm * 1e3:.2f} ms = "
              f"{t_warm / max(res.iterations, 1) * 1e3:.3f} ms an iteration; bdia_spmv "
              f"launches {launches}; true relative residual {rel:.2e} (f64 host, tol 1e-5)",
              flush=True)
    return [("dia_spmv f32 [solver_operator in pipelined_cg, bicgstab, minres, gmres(32), "
             "chebyshev]", "dia_spmv", f"{DIA_PY}:336 (B9), :511 (B10), :650 (B11)",
             lambda d=dop.dia, v=bs: dia_spmv(d, v), lambda d=dop.dia, v=bs: dia_spmv_reference(d, v),
             s_sp, bs, (dop.dia.vals.numel() + 2 * n) * 4, 2 * dop.dia.vals.numel(), total,
             float((dop(bs) - dop.dia._spmv_reference(bs)).abs().max()), torch.float32)]


def ir_phase(dev, card, s_sp) -> None:
    """[ir]: ``ir_solve`` on the f64 DIA plan of S (inner ``cg`` on its f32
    copy, both through the DIA SpMV kernel) to 1e-12, beside an f64 ``cg``."""
    import numpy as np
    import torch

    import cask_tpu_torch as ct

    sv = ct.solvers
    s64 = s_sp.astype(np.float64)
    plan, t_plan = _sync_seconds(lambda: ct.dia_plan(_csr_of(s64), device=dev))
    b64 = np.random.default_rng(SEED + 2).standard_normal(s64.shape[0])
    b = torch.from_numpy(b64).to(dev)
    out = {}
    for name, solve in (("ir_solve(S f64, work f32, inner cg)",
                         lambda: sv.ir_solve(plan, b, tol=1e-12)),
                        ("cg(S f64)", lambda: sv.cg(plan, b, tol=1e-12, maxiter=1000))):
        res, counts, t_warm = _counted_then_warm(solve)
        rel = _true_rel(s64, res.x, b64)
        if not (res.converged and rel <= 1e-12 and res.x.dtype == torch.float64):
            raise AssertionError(f"[ir] {name}: converged {res.converged}, true relative "
                                 f"residual {rel:.3e} (tol 1e-12), x {res.x.dtype}")
        launches = _only(counts, "dia_spmv", None, f"[ir] {name}")
        out[name] = (res.iterations, t_warm, launches, rel)
    (k_ir, t_ir, l_ir, r_ir), (k_cg, t_cg, l_cg, r_cg) = out.values()
    print(f"[ir] S = I + stencil_2d({GRID_SPMV}) as an f64 DIA plan ({t_plan:.1f} s host): "
          f"ir_solve to 1e-12, {k_ir} outer steps (f32 inner cg to 1e-5, at most 300 "
          f"iterations), warm {t_ir * 1e3:.1f} ms, dia_spmv launches {l_ir} (f64 and f32 "
          f"plans), true relative residual {r_ir:.2e}; f64 cg to 1e-12: {k_cg} iterations, "
          f"warm {t_cg * 1e3:.1f} ms, launches {l_cg}, true relative residual {r_cg:.2e} "
          f"(f64 host, tol 1e-12); card {card}", flush=True)


def amg_phase(dev, card, mm_host, mm_sp):
    """[amg]: ``smoothed_aggregation_amg(stencil_2d(GRID_SPMM))`` (f32 apply):
    its host set-up by step, levels and routes, one V-cycle by CUDA events
    with its DIA and POH launches, held against a scipy f64 V-cycle over
    level matrices rebuilt here, then CG with five preconditioners.
    Returns the B8 and B16 timing rows."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    import cask_tpu_torch as ct
    import cask_tpu_torch.solvers.amg as amg_mod
    from cask_tpu_torch.ops.dia import DiaMatrix
    from cask_tpu_torch.ops.kernels.dia_kernels import dia_spmv, dia_spmv_reference
    from cask_tpu_torch.ops.kernels.poh_kernels import poh_spmv, poh_spmv_reference
    from cask_tpu_torch.ops.poh import PohMatrix
    from cask_tpu_torch.tune.timing import time_cuda

    sv = ct.solvers
    n = mm_sp.shape[0]
    # the set-up's steps timed where the module runs them
    spent = {"strength": 0.0, "aggregation": 0.0, "plans": 0.0}
    steps = {"_strength_graph": "strength", "_aggregate": "aggregation", "dia_plan": "plans",
             "poh_plan": "plans"}
    saved = {name: getattr(amg_mod, name) for name in steps}

    def timed(key, fn):
        def run(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                spent[key] += time.perf_counter() - t0
        return run

    for name, key in steps.items():
        setattr(amg_mod, name, timed(key, saved[name]))
    try:
        amg, t_setup = _sync_seconds(lambda: sv.smoothed_aggregation_amg(
            mm_host, dtype=torch.float32, device=dev))
    finally:
        for name, fn in saved.items():
            setattr(amg_mod, name, fn)

    def route(op) -> str:
        if isinstance(op, torch.Tensor):
            return "dense"
        if isinstance(op, DiaMatrix):
            return "DIA"
        if isinstance(op, PohMatrix):
            return "POH"
        if isinstance(op, amg_mod._FactoredApply):
            return f"factored ({route(op.tent)} tentative packs)"
        return type(op).__name__

    routes = "; ".join(f"level {i} ({lv.a.shape[0]} rows): A {route(lv.a)}, P and R "
                       f"{route(lv.p)}" for i, lv in enumerate(amg.levels))
    print(f"[amg] smoothed_aggregation_amg(stencil_2d({GRID_SPMM}), dtype=f32): set-up "
          f"{t_setup:.2f} s (host clock): strength {spent['strength']:.2f} s, aggregation "
          f"(native core) {spent['aggregation']:.2f} s, plans {spent['plans']:.2f} s, triple "
          f"products and the rest {t_setup - sum(spent.values()):.2f} s; level sizes "
          f"{amg.level_sizes}; {routes}; coarse: a dense {amg.coarse_inv.shape[0]}-row inverse",
          flush=True)

    # the same hierarchy in scipy f64, rebuilt with the port's strength graph
    # and aggregation and the reference's triple products
    t0 = time.perf_counter()
    a_sp = mm_sp.astype(np.float64).tocsr()
    ref_levels = []
    t_tri = 0.0
    while a_sp.shape[0] > 256 and len(ref_levels) < 12:
        agg = amg_mod._aggregate(amg_mod._strength_graph(a_sp, 0.08))
        nl, n_agg = a_sp.shape[0], int(agg.max()) + 1
        if n_agg >= nl:
            break
        t1 = time.perf_counter()
        tent = sp.csr_matrix((np.ones(nl), (np.arange(nl), agg)), shape=(nl, n_agg))
        dinv = 1.0 / a_sp.diagonal()
        da = sp.diags(dinv) @ a_sp
        rho = float(abs(da).sum(axis=1).max())
        prol = (tent - (4.0 / 3.0 / rho) * (da @ tent)).tocsr()
        a_c = (prol.T @ a_sp @ prol).tocsr()
        t_tri += time.perf_counter() - t1
        ref_levels.append((a_sp, prol, dinv, tent))
        a_sp = a_c
    coarse = np.linalg.inv(a_sp.toarray())
    sizes = [lv[0].shape[0] for lv in ref_levels] + [coarse.shape[0]]
    if sizes != amg.level_sizes:
        raise AssertionError(f"[amg] rebuilt level sizes {sizes} != {amg.level_sizes}")

    def vcycle(b, lvl=0, w=2.0 / 3.0):
        if lvl == len(ref_levels):
            return coarse @ b
        a_l, p_l, dinv_l, _ = ref_levels[lvl]
        x = w * dinv_l * b
        x = x + p_l @ vcycle(p_l.T @ (b - a_l @ x), lvl + 1)
        return x + w * dinv_l * (b - a_l @ x)

    r = torch.from_numpy(np.random.default_rng(SEED + 3).standard_normal(n)
                         .astype(np.float32)).to(dev)
    want = vcycle(r.cpu().double().numpy())
    t_ref = time.perf_counter() - t0
    _reset()
    y = amg(r)
    torch.cuda.synchronize()
    n_dia = _launched("dia_spmv", "the AMG V-cycle")
    n_poh = _launched("poh_spmv", "the AMG V-cycle")
    err = _relerr(y, torch.from_numpy(want))
    _check("[amg] V-cycle vs scipy f64", err, 1e-5)
    t_cycle = time_cuda(lambda: amg(r), warmup=3, runs=10, reps=3)
    print(f"[amg] one V-cycle {t_cycle.ms * 1e3:.1f} us (CUDA events, median of 10 samples of "
          f"3), dia_spmv launches {n_dia}, poh_spmv {n_poh}; vs a scipy f64 V-cycle over the "
          f"rebuilt levels {err:.2e} (tol 1e-5; rebuild {t_ref:.1f} s, its triple products "
          f"{t_tri:.1f} s); card {card}", flush=True)

    op = ct.solver_operator(mm_host, device=dev)
    b = torch.from_numpy(np.random.default_rng(SEED + 4).standard_normal(n)
                         .astype(np.float32)).to(dev)
    s64, b64 = mm_sp.astype(np.float64), b.cpu().double().numpy()
    jac = sv.jacobi(mm_host, device=dev)
    bj, t_bj = _sync_seconds(lambda: sv.block_jacobi(mm_host, 64, device=dev))
    # Chebyshev's bounds: those of the Jacobi-preconditioned operator it steps
    (clo, chi), t_cl = _sync_seconds(lambda: sv.lanczos_extremal(lambda v: jac(op(v)), n,
                                                                  iters=30, device=dev))
    cheb = sv.chebyshev_precond(op, lmin=clo, lmax=chi, degree=8, M=jac)
    print(f"[amg] cg(solver_operator(A), b) preconditioners: block_jacobi(64) host set-up "
          f"{t_bj:.2f} s; chebyshev_precond(degree 8, M=jacobi) over lanczos_extremal of "
          f"D⁻¹A: ({clo:.3e}, {chi:.4f}) in {t_cl * 1e3:.0f} ms", flush=True)
    # The f32 solves' true residuals: κ(A) is about 4e5 here, and f32 CG's
    # recurrence residual parts from b − A·x by about eps·‖A‖·‖x‖/‖b‖ (2.4e-4
    # for plain CG on the card, 2.2e-5 for AMG-PCG), so f32 is held to 1e-3 and
    # the same AMG-PCG solve in f64 to 1e-9.
    fine = amg.levels[0]
    tent = fine.p.tent
    by_plan = _LaunchesByPlan()  # the f32 AMG-PCG solve's launches on each plan
    s_op64, b_d64 = ct.solver_operator(_csr_of(s64), device=dev), torch.from_numpy(b64).to(dev)
    amg64, t_setup64 = _sync_seconds(lambda: sv.smoothed_aggregation_amg(mm_host, device=dev))
    for name, A, rhs, tol, M, maxiter, per_apply, bound in (
            ("none", op, b, SOLVE_TOL, None, 10000, 0, 1e-3),
            ("jacobi", op, b, SOLVE_TOL, jac, 10000, 0, 1e-3),
            ("block_jacobi(64)", op, b, SOLVE_TOL, bj, 10000, 0, 1e-3),
            ("chebyshev_precond(8)", op, b, SOLVE_TOL, cheb, 3000, 8, 1e-3),
            ("amg V-cycle", op, b, SOLVE_TOL, amg, 200, None, 1e-3),
            ("amg V-cycle, f64 (A, b, cycle)", s_op64, b_d64, 1e-10, amg64, 200, None, 1e-9)):
        res, counts, t_warm = _counted_then_warm(
            lambda: sv.cg(A, rhs, tol=tol, maxiter=maxiter, M=M),
            by_plan if M is amg else None)
        rel = _true_rel(s64, res.x, b64)
        print(f"[amg] cg(A, b, M={name}), tol {tol:.0e}: {res.iterations} iterations, "
              f"converged {res.converged}, warm solve {t_warm * 1e3:.1f} ms = "
              f"{t_warm / max(res.iterations, 1) * 1e3:.3f} ms an iteration (host clock); "
              f"launches dia_spmv {counts['dia_spmv']}, poh_spmv {counts['poh_spmv']}; true "
              f"relative residual {rel:.2e} (f64 host, tol {bound:.0e}); card {card}", flush=True)
        if not (res.converged and rel <= bound):
            raise AssertionError(f"[amg] cg with {name}: converged {res.converged} in "
                                 f"{res.iterations}, true relative residual {rel:.3e}")
        if per_apply is not None:
            _only(counts, "dia_spmv", (res.iterations + 1) * (1 + per_apply), f"[amg] {name}")
        elif not (counts["dia_spmv"] and counts["poh_spmv"]):  # the V-cycle's own launches
            raise AssertionError(f"[amg] AMG-PCG launched dia_spmv {counts['dia_spmv']} and "
                                 f"poh_spmv {counts['poh_spmv']} times")
    per_level = "; ".join(
        f"level {i}: A {by_plan.of(lv.a)}, T {by_plan.of(lv.p.tent)}, Tᵀ "
        f"{by_plan.of(lv.r.tent_t)}" if isinstance(lv.p, amg_mod._FactoredApply) else
        f"level {i}: A {by_plan.of(lv.a)}, P {by_plan.of(lv.p)}, R {by_plan.of(lv.r)}"
        for i, lv in enumerate(amg.levels))
    print(f"[amg] the f64 hierarchy's set-up {t_setup64:.2f} s; the f32 AMG-PCG solve's "
          f"launches on each plan (DIA or POH SpMV, counted at the plan's SpMV): {per_level}; "
          f"the CG operator's own (solver_operator, B9) {by_plan.of(getattr(op, 'dia', op))}; "
          f"T's POH pack {_fill(tent.vals):.3f} full, {_pack_bytes(tent.vals, 8) / 1e6:.1f} MB "
          f"padded against the product's {_spmv_bytes(n, n, tent.shape[1]) / 1e6:.1f} MB",
          flush=True)
    if not (by_plan.of(fine.a) and by_plan.of(tent)):
        raise AssertionError(f"[amg] AMG-PCG launched nothing on the fine level's A or T: "
                             f"{per_level}")
    xc = torch.from_numpy(np.random.default_rng(SEED + 5).standard_normal(tent.shape[1])
                          .astype(np.float32)).to(dev)
    tent_sp = ref_levels[0][3].astype(np.float32)
    return [(f"dia_spmv f32 [AMG fine level A ({n} rows) in AMG-PCG: smoothing, residual, "
             f"factored P and R]", "dia_spmv",
             f"{DIA_PY}:176 (B8)", lambda d=fine.a, v=r: dia_spmv(d, v),
             lambda d=fine.a, v=r: dia_spmv_reference(d, v), mm_sp, r,
             (fine.a.vals.numel() + 2 * n) * 4, 2 * fine.a.vals.numel(), by_plan.of(fine.a),
             float((dia_spmv(fine.a, r) - dia_spmv_reference(fine.a, r)).abs().max()),
             torch.float32),
            (f"poh_spmv f32 [AMG tentative pack T ({n} x {tent.shape[1]}, one-hot) in "
             "AMG-PCG]", "poh_spmv", f"{POH_PY}:388 (B16)",
             lambda p=tent, v=xc: poh_spmv(p, v), lambda p=tent, v=xc: poh_spmv_reference(p, v),
             tent_sp, xc, _spmv_bytes(n, n, tent.shape[1]), 2 * n, by_plan.of(tent),
             float((poh_spmv(tent, xc) - poh_spmv_reference(tent, xc)).abs().max()),
             torch.float32)]


def eig_phase(dev, card, mm, mm_sp, mplan):
    """[eig]: the eigenvalues example's case to convergence, then 10 and 20
    iterations of ``lobpcg`` on stencil_2d(GRID_SPMM) at k = EIG_K from one
    start block.  Returns the B12/B14 timing row."""
    import numpy as np
    import torch

    import cask_tpu_torch as ct
    from cask_tpu_torch.ops.kernels.dia_kernels import dia_spmm, dia_spmm_reference

    sv = ct.solvers
    a = ct.generate.stencil_2d(100)  # f64, as the example
    ad = a.to(dev)
    lam = _laplacian_eigs(100)
    x0 = np.random.default_rng(0).standard_normal((a.shape[0], 4))
    ic, t_ic = _sync_seconds(lambda: sv.ic0(a, device=dev))
    for name, largest, M in (("smallest 4, M=ic0(a).apply", False, ic.apply),
                             ("largest 4", True, None)):
        _reset()
        res, t = _sync_seconds(lambda: sv.lobpcg(ad, x0, largest=largest, tol=1e-6,
                                                  maxiter=500, M=M))
        want = lam[-4:] if largest else lam[:4]
        err = float(np.max(np.abs(res.theta.cpu().numpy() - want) / want))
        launches = _launched("dia_spmm", f"lobpcg ({name})")
        if not (res.converged and err <= 1e-6 and launches == res.iterations + 2):
            raise AssertionError(f"[eig] lobpcg {name}: converged {res.converged}, Ritz values "
                                 f"{err:.2e} from the closed form (tol 1e-6), dia_spmm "
                                 f"{launches} launches for {res.iterations} iterations")
        print(f"[eig] lobpcg(stencil_2d(100) f64, {name}), tol 1e-6: {res.iterations} "
              f"iterations, {t:.2f} s (host clock; ic0 set-up {t_ic:.2f} s); Ritz values "
              f"{np.array2string(res.theta.cpu().numpy(), precision=8)}, {err:.1e} from the "
              f"closed form (tol 1e-6); dia_spmm launches {launches}", flush=True)

    n = mm.shape[0]
    lam = _laplacian_eigs(GRID_SPMM)[:EIG_K]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    X0 = torch.randn((n, EIG_K), generator=gen, device=dev, dtype=torch.float32)
    runs = {}
    for it in (10, 20):
        _reset()
        res, t = _sync_seconds(lambda: sv.lobpcg(mm, X0, tol=1e-6, maxiter=it))
        launches = _launched("dia_spmm", f"lobpcg(maxiter={it})")
        if res.iterations != it or launches != it + 2:
            raise AssertionError(f"[eig] lobpcg(maxiter={it}): {res.iterations} iterations, "
                                 f"dia_spmm {launches} launches (want {it + 2})")
        runs[it] = (res.theta.cpu().double().numpy(), t, launches)
    (th10, t10, _), (th20, t20, l20) = runs[10], runs[20]
    if not (np.all(th20 <= th10 * (1 + 1e-6)) and np.all(th20 >= lam * (1 - 1e-6))):
        raise AssertionError(f"[eig] Ritz values at 20 iterations {th20} against 10 {th10} "
                             f"and the closed form {lam}")
    print(f"[eig] lobpcg(stencil_2d({GRID_SPMM}) f32, k={EIG_K}) from one start block: 10 "
          f"iterations {t10 * 1e3:.1f} ms, 20 iterations {t20 * 1e3:.1f} ms, so "
          f"{(t20 - t10) / 10 * 1e3:.2f} ms an iteration (host clock); dia_spmm launches "
          f"{l20} at 20; Ritz values at 20 {np.array2string(th20, precision=6)} no larger "
          f"than at 10 and no smaller than the closed form's smallest {EIG_K} "
          f"{np.array2string(lam, precision=6)} (Courant-Fischer); card {card}", flush=True)
    return [(f"dia_spmm f32 [spmm(csr, X) in lobpcg, k={EIG_K}]", "dia_spmm",
             f"{DIA_PY}:1148 (B14, k <= 64), :789 (B12)",
             lambda d=mplan, v=X0: dia_spmm(d, v), lambda d=mplan, v=X0: dia_spmm_reference(d, v),
             mm_sp, X0, (mplan.vals.numel() + 2 * n * EIG_K) * 4,
             2 * mplan.vals.numel() * EIG_K, l20,
             float((dia_spmm(mplan, X0) - dia_spmm_reference(mplan, X0)).abs().max()),
             torch.float32)]


def lstsq_phase(dev, card):
    """[lstsq]: ``cgls`` on random_uniform(LSQ_M, LSQ_N) planned as a POH, A and
    its transposed plan both through the POH SpMV kernel.  Returns the B16
    timing rows of A and Aᵀ."""
    import numpy as np
    import torch

    import cask_tpu_torch as ct
    from cask_tpu_torch.formats.generate import random_uniform
    from cask_tpu_torch.ops.kernels.poh_kernels import poh_spmv, poh_spmv_reference

    sv = ct.solvers
    t0 = time.perf_counter()
    a = random_uniform(LSQ_M, LSQ_N, density=LSQ_DENSITY, seed=SEED, dtype=np.float32)
    s = ct.to_scipy(a)
    s64 = s.astype(np.float64)
    rng = np.random.default_rng(SEED + 1)
    b64 = s64 @ rng.standard_normal(LSQ_N) + 1e-3 * rng.standard_normal(LSQ_M)
    t_gen = time.perf_counter() - t0
    plan, t_plan = _sync_seconds(lambda: ct.poh_plan(a, device=dev))
    b = torch.from_numpy(b64.astype(np.float32)).to(dev)
    _reset()
    with _LaunchesByPlan() as by_plan:  # A's and the transposed plan's launches apart
        res, t_first = _sync_seconds(lambda: sv.cgls(plan, b, tol=SOLVE_TOL, maxiter=5000))
    counts = {k: fn.launches for k, fn in _counters().items()}
    launches = _only(counts, "poh_spmv", 2 * res.iterations + 3, "[lstsq] cgls(poh plan)")
    n_a = by_plan.of(plan)
    n_at = sum(by_plan.of(p) for p in by_plan.plans() if p is not plan)
    if n_a + n_at != launches or not (n_a and n_at):
        raise AssertionError(f"[lstsq] cgls: poh_spmv launches {launches}, of which A's "
                             f"{n_a} and the transposed plan's {n_at}")
    atb = np.linalg.norm(s64.T @ b64)
    rel = float(np.linalg.norm(s64.T @ (b64 - s64 @ res.x.cpu().double().numpy())) / atb)
    if not (res.converged and rel <= 1e-5):
        raise AssertionError(f"[lstsq] cgls: converged {res.converged} in {res.iterations}, "
                             f"‖Aᵀ(b − Ax)‖/‖Aᵀb‖ {rel:.3e} (tol 1e-5)")
    at, t_t = _sync_seconds(lambda: ct.transposed(plan))
    _, t_warm = _sync_seconds(lambda: sv.cgls(lambda v: ct.spmv(plan, v), b,
                                              at=lambda v: ct.spmv(at, v), tol=SOLVE_TOL,
                                              maxiter=5000))
    print(f"[lstsq] cgls(poh_plan(random_uniform({LSQ_M}, {LSQ_N}, density={LSQ_DENSITY})), b), "
          f"nnz {a.nnz}, tol {SOLVE_TOL:.0e}: {res.iterations} iterations; host: generation "
          f"{t_gen:.1f} s, poh_plan {t_plan:.1f} s, transposed(plan) {t_t:.1f} s; first solve "
          f"{t_first:.2f} s (transposed(plan) built in it), warm solve over the held plans "
          f"{t_warm * 1e3:.1f} ms = {t_warm / max(res.iterations, 1) * 1e3:.3f} ms an "
          f"iteration (host clock); poh_spmv launches {launches} (2 an iteration, 3 more): A "
          f"{n_a}, transposed(A) {n_at}; the packs {_fill(plan.vals):.3f} and "
          f"{_fill(at.vals):.3f} full, {_pack_bytes(plan.vals, 8) / 1e6:.1f} and "
          f"{_pack_bytes(at.vals, 8) / 1e6:.1f} MB padded against the product's "
          f"{_spmv_bytes(a.nnz, LSQ_M, LSQ_N) / 1e6:.1f} and "
          f"{_spmv_bytes(a.nnz, LSQ_N, LSQ_M) / 1e6:.1f} MB; "
          f"‖Aᵀ(b − Ax)‖/‖Aᵀb‖ {rel:.2e} (f64 host, tol 1e-5); card {card}", flush=True)
    x = torch.from_numpy(rng.standard_normal(LSQ_N).astype(np.float32)).to(dev)
    rows = []
    for name, p, v, lib, n_p in (("A", plan, x, s, n_a),
                                 ("transposed(A)", at, b, s.T.tocsr(), n_at)):
        rows.append((f"poh_spmv f32 [{name} in cgls, {p.shape[0]} x {p.shape[1]}]", "poh_spmv",
                     f"{POH_PY}:388 (B16)", lambda p=p, v=v: poh_spmv(p, v),
                     lambda p=p, v=v: poh_spmv_reference(p, v), lib, v,
                     _spmv_bytes(a.nnz, *p.shape), 2 * a.nnz, n_p,
                     float((poh_spmv(p, v) - poh_spmv_reference(p, v)).abs().max()),
                     torch.float32))
    return rows


HBM_BW = 3.35e12  # bytes/s: the H100 SXM5's published HBM bandwidth, the roofline's denominator
HOST_SLOW_S = 30.0  # a host step of the tuner above this many seconds is flagged


def _family(name: str, k):
    """The launch counters that a kernel variant's callable advances (none for
    a gather variant)."""
    base = name[4:] if name.startswith("rcm:") else name
    if "_xla" in base:
        return ()
    if base == "dia_pallas":
        return ("dia_spmv",) if k is None else ("dia_spmm",)
    if base.startswith("poh_mm"):
        return ("poh_spmm",)
    if base.startswith("poh"):
        return ("poh_spmv",)
    if base.startswith("bsr_pallas"):  # at k > 64 the wide-k chain, or the ELL kernel
        if k is None:
            return ("bdia_spmv",)
        return ("bsr_spmm",) if k <= 64 else ("bsr_spmm", "bdia_spmm_slab",
                                              "bdia_spmm_slab_padded", "bdia_spmm_ring",
                                              "dia_spmm")
    raise AssertionError(f"no kernel family for the variant {name}")


def _plain(m, k, x):
    """The plain PyTorch product of a tuned plan (its kernel's twin)."""
    from cask_tpu_torch.formats.matrix import BSR, CSR
    from cask_tpu_torch.ops.bdia import BdiaMatrix, bdia_scalar_dia
    from cask_tpu_torch.ops.bsr_spmm import BsrSpmmKernel
    from cask_tpu_torch.ops.dia import DiaMatrix
    from cask_tpu_torch.ops.kernels.bsr_kernels import bsr_spmm_reference
    from cask_tpu_torch.ops.kernels.poh_kernels import poh_spmm_reference, poh_spmv_reference
    from cask_tpu_torch.ops.poh import PohMatrix
    from cask_tpu_torch.ops.spmm import spmm
    from cask_tpu_torch.ops.spmv import spmv

    if isinstance(m, BdiaMatrix):  # at k > 64 the scalar-DIA plan's plain product
        return m._spmv_reference(x) if k is None else bdia_scalar_dia(m)._spmm_reference(x)
    if isinstance(m, DiaMatrix):
        return m._spmv_reference(x) if k is None else m._spmm_reference(x)
    if isinstance(m, PohMatrix):
        return poh_spmv_reference(m, x) if k is None else poh_spmm_reference(m, x)
    if isinstance(m, BsrSpmmKernel):
        return bsr_spmm_reference(m, x)
    if isinstance(m, (CSR, BSR)):  # a gather variant is plain PyTorch itself
        return spmv(m, x, method="xla") if k is None else spmm(m, x, method="xla")
    raise AssertionError(f"no plain twin for {type(m)}")


def _tuned_twin(t, k, x):
    """The twin of a tuned callable on ``x``, in the reordered space and
    back for an ``rcm:`` winner."""
    import numpy as np
    import torch

    if t.perm is None:
        return _plain(t.matrix, k, x)
    perm = torch.as_tensor(t.perm.astype(np.int64), device=x.device)
    return _plain(t.matrix, k, x[perm])[torch.argsort(perm)]


def _tune_case(phase, label, a, s32, k, dev, tmp, rng, *, kernel_winner=False):
    """One ``tune`` of the host CSR ``a`` at ``k``: a fresh cache, force=True,
    every enumerated variant timed (time_budget = their count), the launch
    counts set to 0 just before each variant is timed and read just after.
    Checks that each enumerated variant was timed (or took the reading of
    the variant whose callable it builds) or refused by its gate, that each
    timed kernel variant launched its own kernel and each gather variant
    none, and the tuned callable against its twin and scipy f64 (``s32``,
    the matrix in scipy), and prints the winner's roofline share by
    ``spmv_traffic`` beside cuSPARSE's time for the same product.  Returns
    (TunedSpmv, cache, cache entry, x)."""
    import importlib

    import numpy as np
    import torch

    from cask_tpu_torch.bench.roofline import spmv_traffic
    from cask_tpu_torch.formats.signature import signature
    from cask_tpu_torch.ops.bsr_spmm import BsrSpmmKernel
    from cask_tpu_torch.tune import TunerCache, tune
    from cask_tpu_torch.tune.calibrate import poh_equiv_bytes
    from cask_tpu_torch.tune.timing import time_cuda
    from cask_tpu_torch.tune.tuner import Variant, enumerate_variants

    tuner_mod = importlib.import_module("cask_tpu_torch.tune.tuner")  # ct.tune is the function
    what = f"{label}, k {k}" if k else f"{label}, SpMV"
    cache = TunerCache(path=f"{tmp}/{phase}-{label}-k{k or 0}.json")
    t0 = time.perf_counter()
    variants = sorted(enumerate_variants(a, signature(a), k, calib=poh_equiv_bytes(cache, dev)),
                      key=lambda v: v.est_bytes)
    t_enum = time.perf_counter() - t0
    print(f"[{phase}] {what}: {len(variants)} variants, model bytes (signature and "
          f"enumeration {t_enum:.1f} s, host): "
          + ", ".join(f"{v.name} {v.est_bytes / 1e6:.1f} MB" for v in variants), flush=True)
    # each variant's launches while it is timed: the counts at 0 just before
    # each reading, added up just after, by the variant that built the callable
    built, per_var = {}, {}
    build_full, measure = Variant.build_full, tuner_mod.measure

    def tracked_build(self, *args, **kw):
        dev_v, fn, info = build_full(self, *args, **kw)
        built[id(fn)] = self.name
        return dev_v, fn, info

    def counted_measure(fn, x0, **kw):
        _reset()
        meas = measure(fn, x0, **kw)
        got = per_var.setdefault(built[id(fn)], {})
        for name, f in _counters().items():
            got[name] = got.get(name, 0) + f.launches
        return meas

    Variant.build_full, tuner_mod.measure = tracked_build, counted_measure
    try:
        t0 = time.perf_counter()
        t = tune(a, k=k, cache=cache, force=True, time_budget=len(variants), device=dev)
        torch.cuda.synchronize()
        t_tune = time.perf_counter() - t0
    finally:
        Variant.build_full, tuner_mod.measure = build_full, measure
    entry = cache.get(t.signature_key)
    timings = entry["timings"]
    missing = [v.name for v in variants if v.name not in timings]
    if missing:
        raise AssertionError(f"{what}: variants neither timed nor refused: {missing}")
    for v in variants:
        rec = timings[v.name]
        if "refused" in rec:
            print(f"[{phase}]   {v.name}: refused by its gate ({rec['refused']})", flush=True)
            continue
        if rec.get("non_finite"):
            raise AssertionError(f"{what}: {v.name} gave a non-finite product")
        timed_as = rec.get("same_as", v.name)
        got = per_var.get(timed_as, {})
        fam = _family(v.name, k)
        if fam and not any(got.get(f) for f in fam):
            raise AssertionError(f"{what}: {v.name} was timed but launched none of {fam} "
                                 f"({got})")
        if not fam and any(got.values()):
            raise AssertionError(f"{what}: the gather variant {v.name} launched {got}")
        ran = ", ".join(f"{n} {c}" for n, c in got.items() if c) or "no kernel"
        same = f" (the callable of {timed_as}: its reading)" if timed_as != v.name else ""
        print(f"[{phase}]   {v.name}: {rec['seconds_per_op'] * 1e6:.1f} us (CUDA events)"
              f"{same}, floor {rec['floor_seconds'] * 1e6:.1f} us, reliable {rec['reliable']}, "
              f"plausible {rec['plausible']}; launches while timed: {ran}; model "
              f"{v.est_bytes / 1e6:.1f} MB"
              + (" (under the 50 MB L2)" if v.est_bytes < L2_BYTES else ""), flush=True)
    if kernel_winner and not _family(t.variant, k):
        raise AssertionError(f"{what}: the winner {t.variant} is no kernel variant")
    shape = (a.shape[1], k) if k else (a.shape[1],)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    y = t(x)
    err_twin = _relerr(y, _tuned_twin(t, k, x))
    _check(f"{what}: tuned {t.variant} vs its twin", err_twin, F32_TOL)
    cols = (slice(None),) if k is None else (slice(None), slice(0, SCIPY_COLS))
    ref = s32.astype(np.float64) @ x[cols].cpu().double().numpy()
    err_sp = _relerr(y[cols], torch.from_numpy(ref))
    _check(f"{what}: tuned {t.variant} vs scipy f64", err_sp, F32_TOL)
    # the winner's share of the card's bandwidth by the bench's traffic model
    # (the BSR SpMM kernel's plan by its CSR's), beside cuSPARSE's product
    traffic = spmv_traffic(a if isinstance(t.matrix, BsrSpmmKernel) else t.matrix, t.variant,
                           k or 1)
    frac = traffic.record(t.seconds_per_op, bandwidth=HBM_BW)["roofline_frac"]
    S = _sparse_csr(s32, dev, torch.float32)
    lib_us = time_cuda(lambda: S @ x).ms * 1e3
    del S
    print(f"[{phase}] {what}: winner {t.variant} at {t.seconds_per_op * 1e6:.1f} us, "
          f"roofline_frac {frac:.3f} of 3.35 TB/s ({traffic.bytes_per_op / 1e6:.1f} MB by "
          f"spmv_traffic), cuSPARSE (torch.sparse_csr_tensor @) {lib_us:.1f} us; tune "
          f"{t_tune:.1f} s (host); vs twin {err_twin:.2e}, vs scipy f64 {err_sp:.2e} "
          f"(tol {F32_TOL:.0e})", flush=True)
    return t, cache, entry, x


def _host_steps(phase, label, a) -> None:
    """The tuner's host steps at SpMV on a full-size matrix, each timed as
    the tuner runs it: the signature, the BDIA estimate for each block size
    whose fill passes, the DIA estimate, and RCM where there is no DIA
    split."""
    from cask_tpu_torch.formats.reorder import reorder_rcm
    from cask_tpu_torch.formats.signature import signature
    from cask_tpu_torch.ops.bdia import estimate_bdia_traffic
    from cask_tpu_torch.ops.dia import estimate_dia_traffic

    out = []

    def timed(name, fn):
        t0 = time.perf_counter()
        r = fn()
        sec = time.perf_counter() - t0
        out.append(f"{name} {sec:.2f} s" + (" (over 30 s)" if sec > HOST_SLOW_S else ""))
        return r

    sig = timed("signature", lambda: signature(a))
    for b, fill in zip(sig.BLOCK_PROBE, sig.block_fill):
        if fill >= 30:
            timed(f"estimate_bdia_traffic b={b}", lambda b=b: estimate_bdia_traffic(a, b))
    if timed("estimate_dia_traffic", lambda: estimate_dia_traffic(a)) is None:
        timed("reorder_rcm + estimate_dia_traffic",
              lambda: estimate_dia_traffic(reorder_rcm(a)[0]))
    print(f"[{phase}] host steps on {label} ({a.shape[0]} rows, nnz {a.nnz}, block fill "
          f"{sig.block_fill} % at b = {sig.BLOCK_PROBE}): " + ", ".join(out), flush=True)


def tune_phase(dev, card, rng, a, x, a_host, a_sp, st_host, st_sp, mm_host, mm_sp, pl_host,
               pl_sp, tmp):
    """[tune]: ``tune`` at full width on the FEM matrix (SpMV, the headline,
    then k = 32 and 128), the 4M-row stencil, the 1M power law, the 1M
    stencil at k = 32, and the 1M stencil and a 1M band under a random
    symmetric permutation (the RCM variants); the FEM SpMV again on the same
    cache (a hit: nothing timed, nothing launched).  Returns the timing row of the
    FEM SpMV's tuned winner."""
    import numpy as np
    import scipy.sparse as sp
    import torch

    import importlib

    import cask_tpu_torch as ct
    from cask_tpu_torch.bench.roofline import spmv_traffic
    from cask_tpu_torch.formats.convert import bsr_to_csr, from_scipy, to_scipy
    from cask_tpu_torch.formats.generate import banded
    from cask_tpu_torch.ops.dia import estimate_dia_traffic
    from cask_tpu_torch.tune import tune
    from cask_tpu_torch.tune.timing import time_cuda
    from cask_tpu_torch.tune.tuner import Variant

    tuner_mod = importlib.import_module("cask_tpu_torch.tune.tuner")  # ct.tune is the function
    fem = bsr_to_csr(a_host)
    for label, m in (("fem_blocks(512, dof=4)", fem), (f"stencil_2d({GRID_SPMV})", st_host),
                     (f"power_law({PL_N}, avg_degree={PL_DEGREE})", pl_host)):
        _host_steps("tune", label, m)
    t, cache, entry, _ = _tune_case("tune", "fem_blocks(512, dof=4)", fem, a_sp, None, dev, tmp,
                                    rng, kernel_winner=True)
    # the headline: the tuned BSR SpMV against B1 through spmv(bsr, x) and cuSPARSE
    traffic = spmv_traffic(t.matrix, t.variant)
    frac = traffic.record(t.seconds_per_op, bandwidth=HBM_BW)["roofline_frac"]
    S = _sparse_csr(a_sp, dev, torch.float32)
    us = {what: time_cuda(fn).ms * 1e3 for what, fn in (
        ("tuned", lambda: t(x)), ("B1", lambda: ct.spmv(a, x)), ("cusparse", lambda: S @ x))}
    print(f"[tune] headline: tuned {t.variant} on fem_blocks(512, dof=4) f32 "
          f"{t.seconds_per_op * 1e6:.1f} us in tune ({us['tuned']:.1f} us timed again), "
          f"{traffic.bytes_per_op / 1e6:.1f} MB by spmv_traffic -> roofline_frac {frac:.3f} of "
          f"3.35 TB/s; spmv(bsr, x) (B1) {us['B1']:.1f} us, cuSPARSE (torch.sparse_csr_tensor @) "
          f"{us['cusparse']:.1f} us; card {card} (CUDA events)", flush=True)
    fam = _family(t.variant, None)
    source, replaces = {"bdia_spmv": ("bdia_spmv", f"{BDIA_PY}:290 (B1)"),
                        "dia_spmv": ("dia_spmv", f"{DIA_PY}:176 (B8)"),
                        "poh_spmv": ("poh_spmv", f"{POH_PY}:388 (B16)")}[fam[0]]
    _reset()  # the tuned product alone: one launch of its kernel
    y = t(x)
    n_tuned = _launched(fam[0], f"tuned {t.variant}")
    if n_tuned != 1 or _all_launches() != 1:
        raise AssertionError(f"tuned {t.variant}(x): {fam[0]} launched {n_tuned} times, "
                             f"{_all_launches()} launches in all; want 1")
    abs_err = float((y - _tuned_twin(t, None, x)).abs().max())
    row = (f"{source} f32 [tune(fem_blocks(512, dof=4))(x): {t.variant}]", source, replaces,
           lambda: t(x), lambda: _tuned_twin(t, None, x), a_sp, x, traffic.bytes_per_op,
           traffic.flops_per_op, n_tuned, abs_err, torch.float32)
    # a second tune on the same cache: a hit
    timed = []
    measure = tuner_mod.measure
    tuner_mod.measure = lambda *args, **kw: timed.append(1) or measure(*args, **kw)
    try:
        _reset()
        t0 = time.perf_counter()
        hit = tune(fem, cache=cache, device=dev)
        torch.cuda.synchronize()
        t_hit = time.perf_counter() - t0
    finally:
        tuner_mod.measure = measure
    if hit.variant != t.variant or timed or _all_launches():
        raise AssertionError(f"cache hit: variant {hit.variant} (tuned {t.variant}), "
                             f"{len(timed)} timed, {_all_launches()} launches")
    print(f"[tune] cache hit: tune(fem) again on the same cache -> {hit.variant}, nothing "
          f"timed, no launch; {t_hit:.1f} s (host: the signature and the plan build)",
          flush=True)
    del hit
    for k in (K, K_WIDE):
        _tune_case("tune", "fem_blocks(512, dof=4)", fem, a_sp, k, dev, tmp, rng)
    _tune_case("tune", f"stencil_2d({GRID_SPMV})", st_host, st_sp, None, dev, tmp, rng)
    _tune_case("tune", f"power_law({PL_N}, avg_degree={PL_DEGREE})", pl_host, pl_sp, None, dev,
               tmp, rng)
    _tune_case("tune", f"stencil_2d({GRID_SPMM})", mm_host, mm_sp, K, dev, tmp, rng)
    # a random symmetric permutation of the 1M stencil and of a 1M band: no
    # DIA split either way, so the tuner reorders by RCM.  RCM narrows the
    # stencil's band to its side but spreads its entries over changing
    # offsets (its level sets run along the grid's anti-diagonals), so no DIA
    # split comes back and no rcm: variant is enumerated, in the JAX package
    # as here; the band's diagonals come back whole.
    for label, s64 in ((f"stencil_2d({GRID_SPMM}) permuted", mm_sp),
                       (f"banded({BAND_N}, {BAND_W}) permuted",
                        to_scipy(banded(BAND_N, BAND_W, seed=SEED, dtype=np.float32)))):
        p = np.random.default_rng(SEED).permutation(s64.shape[0])
        perm_sp = s64[p][:, p].tocsr()
        perm_sp.sort_indices()
        pa = from_scipy(sp.csr_matrix(perm_sp))
        reordered = ct.reorder_rcm(pa)[0]
        est_r = estimate_dia_traffic(reordered)
        print(f"[tune] {label}: bandwidth {ct.bandwidth(pa)}, {ct.bandwidth(reordered)} after "
              f"RCM; DIA split after RCM {'none' if est_r is None else f'{est_r:.0f} entries'}",
              flush=True)
        tp, _, entry_p, xq = _tune_case("tune", label, pa, perm_sp, None, dev, tmp, rng)
        if (est_r is not None) != ("rcm:dia_pallas" in entry_p["timings"]):
            raise AssertionError(f"{label}: rcm:dia_pallas enumerated against the DIA split")
    if tp.perm is None:  # the reordered-space API on the rcm kernel variant all the same
        dev_r, fn_r, info = Variant("rcm:dia_pallas", 0.0).build_full(pa, None, dev)
        tp = tuner_mod.TunedSpmv("rcm:dia_pallas", dev_r, fn_r, "-", perm=info["perm"],
                                 _inner_fn=info["inner_fn"])
    fn, perm = tp.reordered()
    pt = torch.as_tensor(perm.astype(np.int64), device=dev)
    err = _relerr(fn(xq[pt]), tp(xq)[pt])
    _check("permuted band: reordered() vs the tuned product, reordered", err, F32_TOL)
    print(f"[tune] permuted band: {tp.variant}.reordered() gives the tuned product in the "
          f"reordered space ({err:.1e})", flush=True)
    return row


def tune_medium_phase(dev, rng, tmp) -> None:
    """[tune-medium]: ``tune`` on ``suite("medium")`` in f32 (BASELINE config
    2, about 100k rows each): the winner and each variant's reading, floor
    and plausibility; the operands fit the H100's 50 MB L2.  Prints an L2
    rate: a copy_ of 16 MB."""
    import numpy as np
    import torch

    from cask_tpu_torch.formats.convert import to_scipy
    from cask_tpu_torch.formats.generate import suite
    from cask_tpu_torch.tune.timing import time_cuda

    src = torch.empty(4 * 2**20, dtype=torch.float32, device=dev)
    dst = torch.empty_like(src)
    ms = time_cuda(lambda: dst.copy_(src)).ms
    print(f"[tune-medium] L2: copy_ of a 16 MB f32 tensor {ms * 1e3:.2f} us -> "
          f"{2 * src.numel() * 4 / (ms * 1e-3) / 1e12:.2f} TB/s read + written (CUDA events)",
          flush=True)
    del src, dst
    for name, a in suite("medium").items():
        a32 = a.astype(np.float32)
        t, _, entry, _ = _tune_case("tune-medium", name, a32, to_scipy(a32), None, dev, tmp, rng)
        flags = {n: r.get("plausible", "refused") for n, r in entry["timings"].items()}
        print(f"[tune-medium] {name}: winner {t.variant}; plausible {flags}", flush=True)


def calibrate_phase(dev, tmp) -> None:
    """[calibrate]: ``calibrate_poh(force=True)`` on the card at its default
    probe; the equivalent bytes per slot, the probe's pack bytes, and the
    measured :8192/:2048 ratio beside the model's (C8192/C2048)^alpha."""
    from cask_tpu_torch.tune import TunerCache
    from cask_tpu_torch.tune.calibrate import POH_ALPHA, _key, calibrate_poh, poh_auto_window

    cache = TunerCache(path=f"{tmp}/calibrate.json")
    t0 = time.perf_counter()
    eb = calibrate_poh(cache, force=True, device=dev)
    t_cal = time.perf_counter() - t0
    rec = cache.get(_key(dev))
    n, nnz = rec["n"], rec["nnz"]
    c2, c8 = (poh_auto_window(n, n, nnz, ts) for ts in (2048, 8192))
    print(f"[calibrate] {_key(dev)}: power_law({n}, avg_degree={rec['avg_degree']}, seed=0) f32, "
          f"nnz {nnz}, k {rec['k']}; packs "
          + ", ".join(f"T={ts} {b / 1e6:.1f} MB" for ts, b in rec["pack_bytes"].items())
          + f"; equivalent bytes per slot {rec['equiv_bytes']}; {t_cal:.1f} s (host)",
          flush=True)
    print(f"[calibrate] poh:8192 / poh:2048 measured {eb['poh:8192'] / eb['poh:2048']:.3f}; "
          f"model (C8192/C2048)^alpha = ({c8}/{c2})^{POH_ALPHA} = "
          f"{(c8 / c2) ** POH_ALPHA:.3f}", flush=True)


def bench_harness_phase(dev, a_host) -> None:
    """[bench-harness]: ``bench_matrix`` on the FEM matrix and
    ``bench_suite("small")``: JSON lines, each with its roofline share of
    the card's bandwidth (or a gate's refusal), none with an error or a
    non-finite product."""
    import io

    from cask_tpu_torch.bench import bench_matrix, bench_suite
    from cask_tpu_torch.formats.convert import bsr_to_csr

    buf = io.StringIO()
    recs = bench_matrix("fem_dof4_512x512", bsr_to_csr(a_host), out=buf, device=dev)
    recs += bench_suite("small", out=buf, device=dev)
    for line in buf.getvalue().splitlines():
        print(f"[bench-harness] {line}", flush=True)
    bad = [r for r in recs if "error" in r or r.get("non_finite")
           or ("roofline_frac" not in r and "refused" not in r)]
    if bad:
        raise AssertionError(f"bench records with an error, a non-finite product or no "
                             f"roofline share: {bad}")


# -- 19p-19q. the multi-device half ---------------------------------------------

DIST_FEM_NX = 1600  # [dist]: fem_bdia_partition(1600, dof=4): 10,240,000 rows, 0.8 GB of values
DIST_STENCIL = 3200  # [dist]: stencil_dia_partition(3200): 10,240,000 rows
DIST_K = 128  # [dist]: the slab SpMM's k, where the byte cap admits it
DIST_ILU_GRID = 1024  # shard_ilu0-PCG on I + stencil_2d(1024)
DIST_RANKS = 4  # [dist-ranks]: four gloo ranks on the one card
DIST_RANKS_FEM_NX = 1024  # fem_bdia_partition(1024, dof=4, nshards=4): 4,194,304 rows
DIST_RANKS_STENCIL = 2048  # stencil_dia_partition(2048, nshards=4): 4,194,304 rows
DIST_RANKS_K = 16  # [dist-ranks]: the slab SpMM's k (the shards' Y come back to this process)


def _ilu_system(grid: int):
    """I + stencil_2d(grid) as a host CSR (f32) and as scipy."""
    import numpy as np
    import scipy.sparse as sp

    from cask_tpu_torch.formats.convert import from_scipy, to_scipy
    from cask_tpu_torch.formats.generate import stencil_2d

    st = to_scipy(stencil_2d(grid, dtype=np.float32))
    s = (sp.identity(st.shape[0], dtype=np.float32, format="csr") + st).tocsr()
    return from_scipy(s), s


def _pl_block(n: int, k: int):
    """The power law's SpMM operand of ``[dist-ranks]``, made from its seed
    in each rank and in this process alike (not shipped to the ranks)."""
    import numpy as np

    return np.random.default_rng(SEED + 17).standard_normal((n, k)).astype(np.float32)


def _dist_product(what, op, x, kernel, want, plain, single, card):
    """One distributed product with every launch count at 0: ``kernel``
    launched ``want`` times and no other kernel, y within the f32 gate of the
    plain shard formulation and of the single-device product; then both timed
    with CUDA events."""
    import torch

    from cask_tpu_torch.tune.timing import time_cuda

    _reset()
    y = op(x)
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in _counters().items()}
    launches = _only(counts, kernel, want, f"[dist] {what}")
    y_plain, y_single = plain(x), single(x)
    max_abs = float((y - y_plain).abs().max())
    err_plain, err_single = _relerr(y, y_plain), _relerr(y, y_single)
    _check(f"[dist] {what} vs the plain shard formulation", err_plain, F32_TOL)
    _check(f"[dist] {what} vs the single-device product", err_single, F32_TOL)
    xs = op.padded(x)
    t_dist = time_cuda(lambda: op.padded_op(xs), runs=10, reps=5)
    t_single = time_cuda(lambda: single(x), runs=10, reps=5)
    t_plain = time_cuda(lambda: plain(x), warmup=1, runs=3, reps=1)
    print(f"[dist] {what}: {kernel} launches {launches} (one rank; {want} a call); vs plain "
          f"{err_plain:.2e} (max abs {max_abs:.2e}), vs single-device {err_single:.2e} (tol "
          f"{F32_TOL:.0e}); "
          f"padded_op {t_dist.ms * 1e3:.1f} us, single-device {t_single.ms * 1e3:.1f} us: the "
          f"wrapper's cost {(t_dist.ms - t_single.ms) * 1e3:.1f} us; the plain formulation "
          f"{t_plain.ms * 1e3:.1f} us; card {card}; median of 10 samples of 5 calls, the plain "
          f"3 of 1 (CUDA events)", flush=True)


def _dist_library(what, to_csr, plan, x, card) -> None:
    """The library call beside a ``[dist]`` kernel: cuSPARSE
    (``torch.sparse_csr_tensor @``) on the CSR of the single-device plan,
    built on the card from the plan's arrays, held to the kernel's product
    and timed."""
    import torch

    import cask_tpu_torch as ct
    from cask_tpu_torch.tune.timing import time_cuda

    lib, t_csr = _sync_seconds(lambda: to_csr(plan))
    nnz = lib._nnz()
    err = _relerr(lib @ x, ct.spmv(plan, x))
    _check(f"[dist] {what}: the library call vs the kernel", err, F32_TOL)
    t_lib = time_cuda(lambda: lib @ x, runs=10, reps=5)
    print(f"[dist] {what}: library (torch.sparse_csr_tensor @, cuSPARSE, TF32 off) on the CSR "
          f"of the single-device plan (built on the card from its arrays in {t_csr:.1f} s): "
          f"{nnz} entries, {nnz / plan.shape[0]:.2f} a row (the pack holds "
          f"{plan.vals.numel()} slots), {t_lib.ms * 1e3:.1f} us, vs the kernel {err:.2e}; card "
          f"{card} (CUDA events, median of 10 samples of 5 calls)", flush=True)
    del lib
    torch.cuda.empty_cache()


def dist_phase(dev, card, pl_host, pplan, fem_op, fem_b, fem_sp, spd_bsr, cg_iters):
    """[dist]: one rank over NCCL, in process, at BASELINE config 5's 10,240,000
    rows: ``DistSpmv`` with the BDIA ``"fused"`` (B1) and ``"pallas"`` (B2)
    interiors and the DIA ``"pallas"`` interior (B9), the slab SpMM (B6) where
    its byte cap admits it, POH SpMV and SpMM (B16, B17) on the 1M power law,
    COO and the 1×1 grid; ``cg`` and ``pipelined_cg`` over the FEM SPD
    system's partition; ``shard_ilu0``-PCG.  Returns the PCG's iterations."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import cask_tpu_torch as ct
    import cask_tpu_torch.parallel as tpar
    from cask_tpu_torch.parallel.dist import _bdia_shard_matrix
    from cask_tpu_torch.tune.timing import time_cuda

    sv = ct.solvers
    rng = np.random.default_rng(SEED + 15)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", store=dist.HashStore(),
                            rank=0, world_size=1)
    try:
        mesh = tpar.row_mesh(device=dev)
        print(f"[dist] {mesh}: one rank, in process", flush=True)
        t0 = time.perf_counter()
        fem = tpar.fem_bdia_partition(DIST_FEM_NX, dof=4, nshards=1)
        t_fem = time.perf_counter() - t0
        n = fem.shape[0]
        x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
        fused = tpar.DistSpmv(fem, mesh, interior="fused")
        plain = tpar.DistSpmv(fem, mesh, interior="plain")
        single = _bdia_shard_matrix(fem, fused._shard.local.vals)  # the same values, once
        print(f"[dist] fem_bdia_partition({DIST_FEM_NX}, dof=4, nshards=1): {n} rows, vals "
              f"{fem.vals.nbytes / 1e9:.2f} GB, host build {t_fem:.1f} s; resolved interiors "
              f"auto -> {tpar.resolve_interiors(fem, dev)}", flush=True)
        for what, op in (("BDIA fused interior (B1)", fused),
                         ("BDIA pallas interior (B2)",
                          tpar.DistSpmv(fem, mesh, interior="pallas"))):
            _dist_product(what, op, x, "bdia_spmv", 1, plain,
                                           lambda v: ct.spmv(single, v), card)
        del plain
        _dist_library("BDIA fused and pallas interiors (B1, B2)", _bdia_csr, single, x, card)
        g, nbytes = tpar.slab_choice(fem)
        if g is None:
            try:
                tpar.DistSpmv(fem, mesh, mm_interior="slab")
            except ValueError as e:
                print(f"[dist] mm_interior='slab' at k={DIST_K} on {n} rows refused, as the "
                      f"cap says: {e}", flush=True)
            else:
                raise AssertionError("[dist] the slab was not refused above its byte cap")
        else:
            X = torch.randn((n, DIST_K), device=dev, dtype=torch.float32)
            slab = tpar.DistSpmv(fem, mesh, mm_interior="slab")
            _dist_product(
                f"slab SpMM interior (B6), k={DIST_K}, g={g}, {nbytes} bytes", slab, X,
                "bdia_spmm_slab", 1, tpar.DistSpmv(fem, mesh, mm_interior="plain"),
                lambda v: ct.spmm(single, v, method="slab"), card)
            del X, slab
        del fused, single, fem, x

        sten = tpar.stencil_dia_partition(DIST_STENCIL, nshards=1, align=8192)
        xs_ = torch.from_numpy(rng.standard_normal(sten.shape[0]).astype(np.float32)).to(dev)
        dop = tpar.DistSpmv(sten, mesh, interior="pallas")
        # one rank's shard is the whole matrix, its rows padded to the 8192 alignment
        dsingle = dataclasses.replace(dop._shard.local, shape=sten.shape)
        _dist_product(
            f"DIA pallas interior (B9), stencil_dia_partition({DIST_STENCIL}), "
            f"{sten.shape[0]} rows", dop, xs_, "dia_spmv", 1,
            tpar.DistSpmv(sten, mesh, interior="plain"), lambda v: ct.spmv(dsingle, v), card)
        _dist_library("DIA pallas interior (B9)", _dia_csr, dsingle, xs_, card)
        del dop, dsingle, sten, xs_

        t0 = time.perf_counter()
        poh = tpar.partition_poh(pl_host, 1)
        t_poh = time.perf_counter() - t0
        pop = tpar.DistSpmv(poh, mesh)
        int_m, ext_m = pop._shard  # on one rank the interior pack is the whole matrix
        if (int_m.ntiles, int_m.col_window, int_m.slot_rows) != (
                pplan.ntiles, pplan.col_window, pplan.slot_rows):
            raise AssertionError("[dist] partition_poh's defaults did not give one shard "
                                 "poh_plan's pack")
        pl_dev = pl_host.to(dev)
        xp = torch.from_numpy(rng.standard_normal(PL_N).astype(np.float32)).to(dev)
        Xp = torch.randn((PL_N, K), device=dev, dtype=torch.float32)
        print(f"[dist] partition_poh(power_law({PL_N}), 1) (the port's defaults: poh_plan's "
              f"{pplan.slot_rows * 128}-slot tile and its {poh.col_window}-column window, "
              f"not the reference's 4096 slots and 1024 columns): {int_m.ntiles} interior and "
              f"{ext_m.ntiles} exterior tiles, host pack {t_poh:.1f} s; poh_plan's own pack "
              f"{pplan.ntiles} tiles", flush=True)
        # plain: the gather formulation of the same matrix (the POH twin's
        # gathers would take tens of GB at k = 32)
        for what, v, kernel, plain, single, other in (
                ("POH SpMV (B16)", xp, "poh_spmv", lambda v: ct.spmv(pl_dev, v, method="xla"),
                 lambda v: ct.spmv(int_m, v), lambda v: ct.spmv(pplan, v)),
                (f"POH SpMM (B17), k={K}", Xp, "poh_spmm",
                 lambda v: ct.spmm(pl_dev, v, method="xla"), lambda v: ct.spmm(int_m, v),
                 lambda v: ct.spmm(pplan, v))):
            _dist_product(f"{what}: the interior and the exterior pack", pop, v, kernel, 2,
                          plain, single, card)
            err = _relerr(pop(v), other(v))
            _check(f"[dist] {what} vs poh_plan's own pack", err, F32_TOL)
            vs = pop.padded(v)
            parts = {"the shard's interior pack": lambda: single(v),
                     "its exterior pack (empty on one rank)": lambda: ext_m.spmv(v)
                     if v.ndim == 1 else ext_m.spmm(v),
                     "the all-gather (NCCL, one rank)": lambda: mesh.all_gather(vs).wait(),
                     "poh_plan's own pack": lambda: other(v)}
            times = {k: time_cuda(f, runs=10, reps=5).ms for k, f in parts.items()}
            print(f"[dist] {what} apart: " + ", ".join(f"{k} {t * 1e3:.1f} us"
                                                        for k, t in times.items())
                  + f"; vs poh_plan's pack {err:.2e}; card {card} (CUDA events)", flush=True)
        del pop, int_m, ext_m, poh, Xp
        # the f64 gather: two f32 gathers with atomic sums disagree by a few
        # 1e-6 on the power law's hub rows, run to run
        y64 = ct.spmv(pl_host.astype(np.float64).to(dev), xp.double(), method="xla")
        for what, op in (("COO partition", tpar.DistSpmv(tpar.partition_coo(pl_host, 1), mesh)),
                         ("Dist2DSpmv 1x1", tpar.Dist2DSpmv(tpar.partition_2d(pl_host, 1, 1),
                                                            tpar.mesh_2d(1, 1, device=dev)))):
            _reset()
            y = op(xp)
            torch.cuda.synchronize()
            if _all_launches():
                raise AssertionError(f"[dist] {what} launched a kernel: the reference's is "
                                     f"plain")
            err = _relerr(y, y64)
            _check(f"[dist] {what} vs the single-device gather product (f64)", err, F32_TOL)
            print(f"[dist] {what} of the power law (plain, as the reference's): vs "
                  f"single-device (f64 gather) {err:.2e} (tol {F32_TOL:.0e})", flush=True)
        del pl_dev, xp, y64

        t0 = time.perf_counter()
        sop = tpar.DistSpmv(tpar.partition_bdia(spd_bsr, 1), mesh)
        t_spd = time.perf_counter() - t0
        b_ = sop.padded(fem_b)
        for name, solve, single_iters in (
                ("cg", lambda o: sv.cg(o, b_, tol=1e-6, maxiter=200), cg_iters),
                ("pipelined_cg", lambda o: sv.pipelined_cg(o, b_, tol=SOLVE_TOL, maxiter=500),
                 None)):
            _reset()
            res, t_solve = _sync_seconds(lambda: solve(sop.padded_op))
            n_l = _launched("bdia_spmv", f"[dist] {name}")
            if single_iters is None:
                single_iters = solve(fem_op).iterations
            if abs(res.iterations - single_iters) > 1:
                raise AssertionError(f"[dist] {name}: {res.iterations} iterations, the "
                                     f"single-device solve {single_iters}")
            rel = _true_rel(fem_sp.astype(np.float64), res.x, fem_b.cpu().double().numpy())
            if not rel <= 1e-5:
                raise AssertionError(f"[dist] {name}: true relative residual {rel:.3e} > 1e-5")
            print(f"[dist] {name} over DistSpmv(partition_bdia(FEM SPD system, 1)) "
                  f"({fem_sp.shape[0]} rows, partition {t_spd:.1f} s): {res.iterations} "
                  f"iterations (single-device {single_iters}), {n_l} bdia_spmv launches, "
                  f"{t_solve * 1e3:.1f} ms (host clock); true relative residual {rel:.2e} "
                  f"(f64 host, tol 1e-5)", flush=True)
        del sop, b_

        s1, s1_sp = _ilu_system(DIST_ILU_GRID)
        iop = tpar.DistSpmv(tpar.partition_dia(s1, 1, align=8192), mesh, interior="pallas")
        bi = iop.padded(rng.standard_normal(s1.shape[0]).astype(np.float32))
        t0 = time.perf_counter()
        M = sv.shard_ilu0(s1, iop)
        t_fac = time.perf_counter() - t0
        plain_cg = sv.cg(iop.padded_op, bi, tol=1e-6, maxiter=500)
        pre, t_pcg = _sync_seconds(lambda: sv.cg(iop.padded_op, bi, tol=1e-6, maxiter=500, M=M))
        if not (plain_cg.converged and pre.converged
                and pre.iterations < plain_cg.iterations):
            raise AssertionError(f"[dist] shard_ilu0-PCG {pre.iterations} iterations "
                                 f"({pre.converged}) against plain CG {plain_cg.iterations}")
        n1 = s1.shape[0]
        rel = _true_rel(s1_sp.astype(np.float64), pre.x[:n1], bi[:n1].cpu().double().numpy())
        print(f"[dist] shard_ilu0-PCG on I + stencil_2d({DIST_ILU_GRID}), one block: "
              f"{pre.iterations} iterations against plain CG {plain_cg.iterations}; factor and "
              f"plans {t_fac:.1f} s (host), solve {t_pcg * 1e3:.0f} ms; true relative residual "
              f"{rel:.2e}", flush=True)
    finally:
        dist.destroy_process_group()
    return pre.iterations


def _dist_rank(shared: dict) -> dict:
    """[dist-ranks]' rank program: this rank's rows of each product through
    its kernel and through the plain shard formulation, its kernels'
    launches, its solves and its times (one of four gloo ranks on the one
    card, the exchanges staged through the host).  The partitions come
    built from the parent."""
    import numpy as np
    import torch

    import cask_tpu_torch.parallel as tpar
    from cask_tpu_torch.solvers import cg, pipelined_cg, shard_ilu0
    from cask_tpu_torch.tune.timing import time_cuda

    mesh = tpar.row_mesh(device=shared["device"])
    on_card = mesh.device.type == "cuda"
    out = {"mesh": repr(mesh), "products": {}, "times": {}}
    fem, sten, k = shared["fem"], shared["sten"], shared["k"]
    X16 = np.random.default_rng(21).standard_normal((fem.shape[0], k)).astype(np.float32)

    def ms(fn):  # CUDA events on the card, the host clock in a rehearsal on the CPU
        if on_card:
            return time_cuda(fn, runs=3, reps=3).ms
        t1 = time.perf_counter()
        for _ in range(3):
            fn()
        return (time.perf_counter() - t1) / 3 * 1e3
    # (name, plan, the kernel's options, the plain formulation's (None: POH
    # has one interior), operand, kernel)
    cases = (("bdia fused (B1)", fem, {"interior": "fused"}, {"interior": "plain"},
              shared["x_fem"], "bdia_spmv"),
             (f"slab SpMM (B6), k={k}", fem, {"mm_interior": "slab"}, {"mm_interior": "plain"},
              X16, "bdia_spmm_slab"),
             ("dia pallas (B9)", sten, {"interior": "pallas"}, {"interior": "plain"},
              shared["x_sten"], "dia_spmv"),
             ("dia pallas + remainder (B9)", shared["dia_rem"], {"interior": "pallas"},
              {"interior": "plain"}, shared["x_rem"], "dia_spmv"),
             ("poh SpMV (B16)", shared["poh"], {}, None, shared["x_pl"], "poh_spmv"),
             (f"poh SpMM (B17), k={shared['k_pl']}", shared["poh"], {}, None,
              _pl_block(shared["poh"].shape[0], shared["k_pl"]), "poh_spmm"))
    for name, plan, kw, plain_kw, x, kernel in cases:
        op = tpar.DistSpmv(plan, mesh, **kw)
        xs = op.padded(x)
        _reset()
        y = op.padded_op(xs)
        if on_card:
            torch.cuda.synchronize()
        counts = {c: fn.launches for c, fn in _counters().items() if fn.launches}
        got = {"y": y.cpu().numpy(), "counts": counts, "kernel": kernel,
               "interiors": (op.interior, op.mm_interior)}
        del op, y
        if plain_kw is not None:
            got["y_plain"] = tpar.DistSpmv(plan, mesh, **plain_kw).padded_op(xs).cpu().numpy()
        out["products"][name] = got
    del X16
    op2 = tpar.Dist2DSpmv(shared["pl2d"], tpar.mesh_2d(2, mesh.size // 2, device=mesh.device))
    y2d = op2(shared["x_pl"]).cpu().numpy()  # every rank takes part in the collectives
    out["y2d"] = y2d if mesh.rank == 0 else None

    sop = tpar.DistSpmv(shared["spd"], mesh)
    b = sop.padded(shared["b_spd"])
    for name, solve in (("cg", lambda: cg(sop.padded_op, b, tol=1e-6, maxiter=200)),
                        ("pipelined_cg",
                         lambda: pipelined_cg(sop.padded_op, b, tol=SOLVE_TOL, maxiter=500))):
        res = solve()
        out[name] = {"iterations": res.iterations, "x": res.x.cpu().numpy(),
                     "converged": res.converged}
    iop = tpar.DistSpmv(shared["ilu_plan"], mesh, interior="pallas")
    M = shard_ilu0(shared["ilu_a"], iop)
    bi = iop.padded(shared["b_ilu"])
    out["ilu_cg"] = cg(iop.padded_op, bi, tol=1e-6, maxiter=500, M=M).iterations

    # per-rank times: the exchange overlapped with the interior and serialized
    # before it, and the exchange alone
    for name, plan, x in (("bdia", fem, shared["x_fem"]), ("dia", sten, shared["x_sten"])):
        ops = {ov: tpar.DistSpmv(plan, mesh, overlap=ov,
                                 interior="fused" if name == "bdia" else "pallas")
               for ov in (True, False)}
        xs = ops[True].padded(x)
        lo, hi = ((plan.halo_lo_b * 4, plan.halo_hi_b * 4) if name == "bdia"
                  else (plan.halo_lo, plan.halo_hi))
        out["times"][name] = {"overlapped": ms(lambda: ops[True].padded_op(xs)),
                              "serialized": ms(lambda: ops[False].padded_op(xs)),
                              "exchange": ms(lambda: mesh.ring_halo(xs, lo, hi).wait())}
    return out


def _rank_launches(what: str, counts: dict, kernel: str) -> None:
    """A rank's launches in one distributed product: ``kernel`` once per pack
    (the POH kernels twice: the interior and the exterior pack) and no other
    kernel."""
    want = {kernel: 2 if kernel.startswith("poh") else 1}
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, want {want}")


def _whole_bdia(plan, dev):
    """The whole matrix of a formulaic ``fem_bdia_partition`` on one device:
    its shards' block rows laid end to end and retiled, as
    ``fem_bdia_partition(..., nshards=1)`` would pack them (each shard's
    values hold every term of its rows, the halo's too)."""
    import numpy as np
    import torch

    from cask_tpu_torch.ops.bdia import BdiaMatrix, _pick_ts
    from cask_tpu_torch.parallel.dist import _empty_rem

    P, br, T, npairs, ts, lane = plan.vals.shape
    nbr = plan.shape[0] // br
    rows = plan.vals.transpose(1, 3, 0, 2, 4, 5).reshape(br, npairs, P, T * ts * lane)
    rows = rows[..., :plan.nbloc].reshape(br, npairs, P * plan.nbloc)[..., :nbr]
    ts1 = _pick_ts(nbr)
    t1 = -(-nbr // (ts1 * lane))
    v = np.zeros((br, npairs, t1 * ts1 * lane), dtype=plan.vals.dtype)
    v[..., :nbr] = rows
    v = v.reshape(br, npairs, t1, ts1, lane).transpose(0, 2, 1, 3, 4)
    vals = torch.from_numpy(np.ascontiguousarray(v)).to(dev)
    return BdiaMatrix(vals=vals, **_empty_rem(vals), block_offsets=plan.block_offsets,
                      shape=plan.shape, blocksize=plan.blocksize, ts=ts1)


def _whole_dia(plan, dev):
    """The whole matrix of a ``DiaPartition`` with no remainder on one
    device: its shards' rows of every diagonal laid end to end."""
    import torch

    from cask_tpu_torch.ops.dia import DiaMatrix

    P, nd, mloc = plan.vals.shape
    vals = torch.from_numpy(plan.vals.transpose(1, 0, 2).reshape(nd, P * mloc)).to(dev)
    zi = torch.zeros(0, dtype=torch.int32, device=dev)
    return DiaMatrix(vals=vals, rem_data=vals.new_zeros(0), rem_row=zi, rem_col=zi,
                     vals_t=None, offsets=plan.offsets, shape=plan.shape)


def _shard_slab_row(dev, fem, rank0: dict) -> list:
    """B6 on one ``[dist-ranks]`` shard in this process: rank 0's slab plan
    (its local matrix, sheared as ``DistSpmv(mm_interior="slab")`` shears
    it) at k = 16, against its plain twin; its ``[timing]`` row, with rank
    0's launches and the library call on the CSR of the shard's local
    matrix (the interior: columns within the shard)."""
    import numpy as np
    import torch

    import cask_tpu_torch.parallel as tpar
    from cask_tpu_torch.ops.bdia_slab import bdia_slab_plan
    from cask_tpu_torch.ops.kernels.bdia_slab_kernels import (bdia_spmm_slab,
                                                              bdia_spmm_slab_reference)
    from cask_tpu_torch.parallel.dist import _bdia_shard_matrix

    local = _bdia_shard_matrix(fem, torch.from_numpy(np.ascontiguousarray(fem.vals[0])).to(dev))
    g, _ = tpar.slab_choice(fem)
    slabs = bdia_slab_plan(local, g)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 20)
    k = DIST_RANKS_K
    X = torch.randn((fem.mloc, k), generator=gen, device=dev)
    y, y_twin = bdia_spmm_slab(slabs, X), bdia_spmm_slab_reference(slabs, X)
    err = _relerr(y, y_twin)
    _check("[dist-ranks] one shard's slab SpMM kernel vs twin", err, F32_TOL)
    launches = rank0["counts"]["bdia_spmm_slab"]
    print(f"[dist-ranks] rank 0's slab plan in this process ({fem.mloc} rows, g = {g}, k = {k}): "
          f"kernel vs twin {err:.2e} (tol {F32_TOL:.0e}); rank 0 launched it {launches} time(s) "
          f"a product; timed in [timing]", flush=True)
    nv = local.vals.numel()
    return [(f"bdia_spmm_slab f32 [one [dist-ranks] shard's slab plan, {fem.mloc} rows, k={k}]",
             "bdia_slab_spmm", f"{SLAB_PY}:518 (B6)", lambda: bdia_spmm_slab(slabs, X),
             lambda: bdia_spmm_slab_reference(slabs, X), _bdia_csr(local), X,
             nv * 4 + 2 * fem.mloc * k * 4, 2 * nv * k, launches,
             float((y - y_twin).abs().max()), torch.float32)]


def dist_ranks_phase(dev, card, pl_host, pplan, fem_op, fem_b, fem_sp, spd_bsr, cg_iters,
                     ilu_one_block: int):
    """[dist-ranks]: four gloo ranks spawned on the one card through
    ``launch`` (NCCL refuses two ranks on one GPU, so the exchanged slices go
    through the host), each partition built once here and shipped: each
    rank's rows of y against its plain shard formulation and the
    single-device product, with the real kernels as interiors; distributed
    CG against the single-device iterations; ``shard_ilu0``-PCG with four
    blocks against one.  The times are four processes sharing one card, not
    scaling numbers."""
    import numpy as np
    import torch

    import cask_tpu_torch as ct
    import cask_tpu_torch.parallel as tpar
    from cask_tpu_torch.formats.convert import from_scipy, to_scipy
    from cask_tpu_torch.formats.generate import random_uniform, stencil_2d
    from cask_tpu_torch.ops.bdia_slab import slab_auto_plan

    P = DIST_RANKS
    rng = np.random.default_rng(SEED + 16)
    t0 = time.perf_counter()
    fem = tpar.fem_bdia_partition(DIST_RANKS_FEM_NX, dof=4, nshards=P)
    sten = tpar.stencil_dia_partition(DIST_RANKS_STENCIL, nshards=P, align=8192)
    st_sp = to_scipy(stencil_2d(DIST_RANKS_STENCIL // 2, dtype=np.float32))
    rem_sp = (st_sp + to_scipy(random_uniform(st_sp.shape[0], density=1e-6, seed=5,
                                              dtype=np.float32))).tocsr()
    ilu_a, _ = _ilu_system(DIST_ILU_GRID)
    shared = {
        "device": str(dev), "fem": fem, "sten": sten, "k": DIST_RANKS_K,
        "x_fem": rng.standard_normal(fem.shape[0]).astype(np.float32),
        "x_sten": rng.standard_normal(sten.shape[0]).astype(np.float32),
        "dia_rem": tpar.partition_dia(from_scipy(rem_sp), P, align=8192),
        "x_rem": rng.standard_normal(rem_sp.shape[0]).astype(np.float32),
        "poh": tpar.partition_poh(pl_host, P),
        "pl2d": tpar.partition_2d(pl_host, 2, P // 2),
        "x_pl": rng.standard_normal(PL_N).astype(np.float32), "k_pl": K,
        "spd": tpar.partition_bdia(spd_bsr, P),
        "b_spd": fem_b.cpu().numpy(),
        "ilu_plan": tpar.partition_dia(ilu_a, P, align=8192), "ilu_a": ilu_a,
        "b_ilu": rng.standard_normal(ilu_a.shape[0]).astype(np.float32)}
    t_host = time.perf_counter() - t0
    if shared["dia_rem"].remainder is None:
        raise AssertionError("[dist-ranks] the scattered entries did not spill to a remainder")
    t0 = time.perf_counter()
    ranks = tpar.launch(_dist_rank, P, shared, backend="gloo", timeout=900.0)
    t_ranks = time.perf_counter() - t0
    print(f"[dist-ranks] {P} ranks on the one card over gloo ({ranks[0]['mesh']}): the "
          f"exchanged slices go through the host; partitions and inputs built once here "
          f"{t_host:.1f} s (host), spawn to exit {t_ranks:.1f} s", flush=True)

    # the single-device products, on the card in this process: the kernel on
    # the whole matrix and, for POH, the plain gather in f64 as well
    t0 = time.perf_counter()
    fem_m = _whole_bdia(fem, dev)
    fem_slab = slab_auto_plan(fem_m)  # spmm(fem_m, X) at k <= 64 would take scalar DIA
    if fem_slab is None:
        raise AssertionError("[dist-ranks] the whole FEM matrix has no slab plan")
    sten_m = _whole_dia(sten, dev)
    X16 = torch.from_numpy(np.random.default_rng(21).standard_normal(
        (fem.shape[0], DIST_RANKS_K)).astype(np.float32)).to(dev)
    pl64 = pl_host.astype(np.float64).to(dev)
    rem_dev = from_scipy(rem_sp).to(dev)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    xp, Xp = t(shared["x_pl"]), t(_pl_block(PL_N, K))
    singles = {  # name -> (the single-device kernel product, a plain single-device product)
        "bdia fused (B1)": (lambda: ct.spmv(fem_m, t(shared["x_fem"])), None),
        f"slab SpMM (B6), k={DIST_RANKS_K}": (lambda: ct.spmm(fem_slab, X16), None),
        "dia pallas (B9)": (lambda: ct.spmv(sten_m, t(shared["x_sten"])), None),
        "dia pallas + remainder (B9)": (
            lambda: ct.spmv(rem_dev, t(shared["x_rem"]), method="xla"), None),
        "poh SpMV (B16)": (lambda: ct.spmv(pplan, xp),
                           lambda: ct.spmv(pl64, xp.double(), method="xla")),
        f"poh SpMM (B17), k={K}": (lambda: ct.spmm(pplan, Xp),
                                   lambda: ct.spmm(pl64, Xp.double(), method="xla")),
    }
    for name, (single, single_plain) in singles.items():
        refs = {"the single-device product": single().cpu()}
        if single_plain is not None:
            refs["the single-device plain gather (f64)"] = single_plain().cpu()
        got = [r["products"][name] for r in ranks]
        kernel = got[0]["kernel"]
        worst = {}
        for r, g in enumerate(got):
            _rank_launches(f"[dist-ranks] {name} rank {r}", g["counts"], kernel)
            y = torch.from_numpy(g["y"])
            if "y_plain" in g:  # the rank's own rows through the plain shard formulation
                err = _relerr_or_zero(y, torch.from_numpy(g["y_plain"]))
                _check(f"[dist-ranks] {name} rank {r} vs its plain shard formulation", err,
                       F32_TOL)
                worst["its plain shard formulation"] = max(
                    worst.get("its plain shard formulation", 0.0), err)
            mloc = y.shape[0]
            lo, hi = r * mloc, min((r + 1) * mloc, refs["the single-device product"].shape[0])
            if hi <= lo:  # a shard of padding only
                continue
            for what, ref in refs.items():
                err = _relerr(y[: hi - lo], ref[lo:hi])
                _check(f"[dist-ranks] {name} rank {r} rows vs {what}", err, F32_TOL)
                worst[what] = max(worst.get(what, 0.0), err)
        print(f"[dist-ranks] {name}: every rank's rows, worst against "
              + ", ".join(f"{what} {e:.2e}" for what, e in worst.items())
              + f" (tol {F32_TOL:.0e}); interiors {got[0]['interiors']}; launches a rank "
              f"{got[0]['counts']}", flush=True)
    del fem_m, fem_slab, sten_m, X16, Xp
    b6_rows = _shard_slab_row(dev, fem, ranks[0]["products"][f"slab SpMM (B6), k={DIST_RANKS_K}"])
    err2d = _relerr(torch.from_numpy(ranks[0]["y2d"]), singles["poh SpMV (B16)"][1]())
    _check("[dist-ranks] Dist2DSpmv 2x2 vs single-device (f64 gather)", err2d, F32_TOL)
    print(f"[dist-ranks] Dist2DSpmv 2x{P // 2} of the power law (the grid-row sums): vs "
          f"single-device (f64 gather) {err2d:.2e}", flush=True)
    for name, single_iters in (("cg", cg_iters), ("pipelined_cg", None)):
        its = {r[name]["iterations"] for r in ranks}
        if len(its) != 1:
            raise AssertionError(f"[dist-ranks] {name}: ranks disagree on iterations {its}")
        it = its.pop()
        if single_iters is None:
            single_iters = ct.solvers.pipelined_cg(fem_op, fem_b, tol=SOLVE_TOL,
                                                   maxiter=500).iterations
        if abs(it - single_iters) > 1:
            raise AssertionError(f"[dist-ranks] {name}: {it} iterations, single-device "
                                 f"{single_iters}")
        x = np.concatenate([r[name]["x"] for r in ranks])[: fem_sp.shape[0]]
        rel = float(np.linalg.norm(fem_b.cpu().double().numpy()
                                   - fem_sp.astype(np.float64) @ x.astype(np.float64))
                    / np.linalg.norm(fem_b.cpu().double().numpy()))
        if not rel <= 1e-5:
            raise AssertionError(f"[dist-ranks] {name}: true relative residual {rel:.3e}")
        print(f"[dist-ranks] {name} over {P} shards of the FEM SPD system: {it} iterations "
              f"(single-device {single_iters}); true relative residual {rel:.2e}", flush=True)
    ilu4 = {r["ilu_cg"] for r in ranks}
    if len(ilu4) != 1 or ilu4.pop() < ilu_one_block:
        raise AssertionError(f"[dist-ranks] shard_ilu0-PCG with {P} blocks: "
                             f"{[r['ilu_cg'] for r in ranks]} iterations, one block "
                             f"{ilu_one_block}")
    print(f"[dist-ranks] shard_ilu0-PCG on I + stencil_2d({DIST_ILU_GRID}) with {P} blocks: "
          f"{ranks[0]['ilu_cg']} iterations, one block {ilu_one_block} (more blocks drop more "
          f"coupling); the checks here {time.perf_counter() - t0:.1f} s (host)", flush=True)
    for name in ("bdia", "dia"):
        for r, res in enumerate(ranks):
            tm = res["times"][name]
            print(f"[dist-ranks] {name} rank {r}: overlapped {tm['overlapped'] * 1e3:.1f} us, "
                  f"serialized {tm['serialized'] * 1e3:.1f} us, the exchange alone "
                  f"{tm['exchange'] * 1e3:.1f} us = {tm['exchange'] / tm['serialized']:.3f} "
                  f"of serialized; four processes sharing one card over gloo, staged through "
                  f"the host: not scaling numbers; card {card} (CUDA events, median of 3 "
                  f"samples of 3 calls)", flush=True)
    return b6_rows


SYNTH_PANELS = 250  # [device-gen]: poh_synth_device(n_panels=250): 1,024,000 rows, 15,000 tiles
BENCH_SOLVE_K = 200  # [bench-solve]: the counted solve's iterations
PROFILE_ITERS = 20  # [profile]: the traced CG's iterations
KRYLOV_MS = {"cg": 0.273, "pipelined_cg": 0.421}  # on I + the stencil (PERF.md §5.14), ms


def _bdia_csr(a):
    """The matrix of a BDIA plan as a torch sparse CSR on the plan's device,
    built there from its arrays (the entries ≠ 0 whose column lies in the
    matrix; row-major, columns ascending): the library call's operand."""
    import torch

    br, bc = a.blocksize
    m, n = a.shape
    v = a.vals.permute(1, 3, 4, 0, 2).reshape(-1, a.npairs)[:m]  # (rows, pairs)
    dev = v.device
    c = torch.tensor([c for c, _ in a.pairs], device=dev)
    d = torch.tensor([d for _, d in a.pairs], device=dev)
    bcol = torch.arange(-(-m // br), device=dev)[:, None] + d  # (block rows, pairs)
    inside = ((bcol >= 0) & (bcol * bc + c < n)).repeat_interleave(br, dim=0)[:m]
    nz = ((v != 0) & inside).nonzero()
    rows, j = nz[:, 0], nz[:, 1]
    cols = (rows // br + d[j]) * bc + c[j]
    return _csr_tensor(rows, cols, v[rows, j], (m, n))


def _dia_csr(a):
    """The matrix of a DIA plan without a remainder as a torch sparse CSR on
    its device, as :func:`_bdia_csr`."""
    import torch

    m, n = a.shape
    v = a.vals.T[:m]
    off = a.offsets_dev.long()
    r = torch.arange(m, device=v.device)
    nz = ((v != 0) & (r[:, None] + off[None, :] >= 0) & (r[:, None] + off[None, :] < n)).nonzero()
    rows, d = nz[:, 0], nz[:, 1]
    return _csr_tensor(rows, rows + off[d], v[rows, d], (m, n))


def _poh_csr(p):
    """The matrix of a POH pack as a torch sparse CSR on its device, its
    live slots' duplicates summed."""
    import torch

    nt = p.ntiles
    rows = (p.panel.long()[:, None] * p.row_panel + p.rloc.reshape(nt, -1).long()).reshape(-1)
    cols = (p.wlo.long()[:, None] * p.col_window + p.cloc.reshape(nt, -1).long()).reshape(-1)
    v = p.vals.reshape(-1)
    live = v != 0
    coo = torch.sparse_coo_tensor(torch.stack([rows[live], cols[live]]), v[live],
                                  size=p.shape).coalesce()
    return coo.to_sparse_csr()


def _csr_tensor(rows, cols, vals, shape):
    """A torch sparse CSR (int32 indices) of row-sorted entries."""
    import torch

    crow = torch.zeros(shape[0] + 1, dtype=torch.int64, device=rows.device)
    crow[1:] = torch.bincount(rows, minlength=shape[0]).cumsum(0)
    return torch.sparse_csr_tensor(crow.int(), cols.int(), vals, size=shape)


def device_gen_phase(dev, card, fem_plan, fem_host_s, sten_plan, sten_host_s):
    """[device-gen]: the bench's operands built on the card
    (``fem_bdia_device(512, dof=4)``, ``stencil2d_dia_device(2048)``,
    ``banded_dia_device(1_048_576, 4)``), each held against its host plan
    (the stencil bit for bit; the FEM and band packs' offsets, ``ts``,
    shapes and nonzero pattern), each ``spmv`` one launch of its kernel
    within the f32 gate of its twin; then ``poh_synth_device(n_panels=250)``
    checked by ``check_poh``, its ``spmv`` one ``poh_spmv`` launch.
    Returns the synthetic pack's ``[timing]`` row."""
    import numpy as np
    import torch

    import cask_tpu_torch as ct
    from cask_tpu_torch.formats.device_gen import (banded_dia_device, fem_bdia_device,
                                                   stencil2d_dia_device)
    from cask_tpu_torch.formats.generate import banded
    from cask_tpu_torch.ops.kernels.poh_kernels import poh_spmv, poh_spmv_reference
    from cask_tpu_torch.ops.poh import poh_synth_device
    from cask_tpu_torch.utils.debug import check_poh

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 18)
    fem, t_fem = _sync_seconds(lambda: fem_bdia_device(NX, dof=DOF, seed=SEED, device=dev))
    sten, t_sten = _sync_seconds(lambda: stencil2d_dia_device(GRID_SPMV, device=dev))
    band, t_band = _sync_seconds(lambda: banded_dia_device(BAND_N, BAND_W, seed=SEED, device=dev))
    t0 = time.perf_counter()
    band_host = ct.dia_plan(banded(BAND_N, BAND_W, seed=SEED, dtype=np.float32), device=dev)
    torch.cuda.synchronize()
    band_host_s = time.perf_counter() - t0

    same = (sten.offsets == sten_plan.offsets and sten.shape == sten_plan.shape
            and torch.equal(sten.vals, sten_plan.vals) and sten_plan.rem_data.numel() == 0)
    if not same:
        raise AssertionError("[device-gen] stencil2d_dia_device is not bit-equal to its host plan")
    for what, m, host, meta in (
            ("fem_bdia_device", fem, fem_plan, lambda p: (p.block_offsets, p.ts, p.blocksize)),
            ("banded_dia_device", band, band_host, lambda p: p.offsets)):
        got, want = (meta(m), m.shape, tuple(m.vals.shape)), (meta(host), host.shape,
                                                              tuple(host.vals.shape))
        if got != want or host.rem_data.numel():
            raise AssertionError(f"[device-gen] {what}: {got} against the host plan's {want}, "
                                 f"remainder {host.rem_data.numel()}")
        differ = int(((m.vals != 0) != (host.vals != 0)).sum())
        if differ:
            raise AssertionError(f"[device-gen] {what}: {differ} entries' nonzero pattern "
                                 f"differs from the host plan's")
    for what, m, host_s, t_dev, kernel in (
            (f"fem_bdia_device({NX}, dof={DOF})", fem, fem_host_s, t_fem, "bdia_spmv"),
            (f"stencil2d_dia_device({GRID_SPMV})", sten, sten_host_s, t_sten, "dia_spmv"),
            (f"banded_dia_device({BAND_N}, {BAND_W})", band, band_host_s, t_band, "dia_spmv")):
        x = torch.randn(m.shape[1], generator=gen, device=dev)
        _reset()
        y = ct.spmv(m, x)
        torch.cuda.synchronize()
        counts = {k: fn.launches for k, fn in _counters().items()}
        n_l = _only(counts, kernel, 1, f"[device-gen] spmv({what})")
        err = _relerr(y, m._spmv_reference(x))
        _check(f"[device-gen] spmv({what}) kernel vs twin", err, F32_TOL)
        print(f"[device-gen] {what}: {m.shape[0]} rows, vals {tuple(m.vals.shape)} "
              f"({m.vals.numel() * 4 / 1e6:.1f} MB f32); built on the card in {t_dev:.3f} s "
              f"(CUDA-synced), the host plan {host_s:.1f} s (host generation and plan); "
              f"structure equal to the host plan's"
              f"{' (bit for bit)' if m is sten else ' (offsets, ts, shapes, nonzeros)'}; "
              f"spmv: {kernel} launches {n_l}, vs twin {err:.2e} (tol {F32_TOL:.0e})",
              flush=True)
    del fem, sten, band, band_host

    synth, t_synth = _sync_seconds(lambda: poh_synth_device(n_panels=SYNTH_PANELS, seed=SEED,
                                                      device=dev))
    t0 = time.perf_counter()
    check_poh(synth)
    t_check = time.perf_counter() - t0
    xs = torch.randn(synth.shape[1], generator=gen, device=dev)
    _reset()
    y = ct.spmv(synth, xs)
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in _counters().items()}
    n_l = _only(counts, "poh_spmv", 1, "[device-gen] spmv(poh_synth_device)")
    y_twin = poh_spmv_reference(synth, xs)
    err = _relerr(y, y_twin)
    _check("[device-gen] spmv(poh_synth_device) kernel vs twin", err, F32_TOL)
    max_abs = float((y - y_twin).abs().max())
    lib = _poh_csr(synth)
    live = int(torch.count_nonzero(synth.vals))
    pack = _pack_bytes(synth.vals, 8) + synth.ntiles * 4
    m, n = synth.shape
    print(f"[device-gen] poh_synth_device(n_panels={SYNTH_PANELS}): {m} rows, {synth.ntiles} "
          f"tiles of {synth.slot_rows * 128} slots, {pack / 1e6:.1f} MB of pack (above the "
          f"50 MB L2); built on the card in {t_synth:.3f} s (CUDA-synced); check_poh passed "
          f"({t_check:.1f} s, host); spmv: poh_spmv launches {n_l}, vs twin {err:.2e} (max abs "
          f"{max_abs:.2e}, tol {F32_TOL:.0e}); its CSR (duplicates summed) {lib._nnz()} "
          f"entries of {live} live slots", flush=True)
    return [(f"poh_spmv f32 [spmv(poh_synth_device(n_panels={SYNTH_PANELS}), x)]", "poh_spmv",
             f"{POH_PY}:388 (B16; the pack of {POH_PY}:262)",
             lambda: poh_spmv(synth, xs), lambda: poh_spmv_reference(synth, xs), lib, xs,
             live * 8 + (m + n) * 4, 2 * live, n_l, max_abs, torch.float32)]


def bench_solve_phase(dev, card) -> None:
    """[bench-solve]: ``bench_solve(side=2048)``'s records (``cg`` and
    ``pipelined_cg`` on the 4,194,304-row stencil built on the card, the
    k-ladder), beside ``[krylov]``'s ms an iteration on I + that stencil;
    then one counted solve of each at k = 200, whose ``dia_spmv`` launches
    must be its products (``cg`` k + 1, ``pipelined_cg`` k + 3)."""
    import io

    import torch

    from cask_tpu_torch.bench.harness import SOLVE_LADDER, bench_solve
    from cask_tpu_torch.formats.device_gen import stencil2d_dia_device
    from cask_tpu_torch.ops.dia import DiaOperator
    from cask_tpu_torch.solvers import cg, pipelined_cg

    buf = io.StringIO()
    recs, t_bench = _sync_seconds(lambda: bench_solve(side=GRID_SPMV, out=buf, device=dev))
    on_card = dev.type == "cuda"
    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    for line, rec in zip(buf.getvalue().splitlines(), recs):
        if rec["device"] != kind or rec["operator_mode"] != ("kernel" if on_card else "reference"):
            raise AssertionError(f"[bench-solve] record not from the card's kernel: {rec}")
        print(f"[bench-solve] {line}", flush=True)
    op = DiaOperator(stencil2d_dia_device(GRID_SPMV, device=dev))
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 19)
    bp = op.to_padded(torch.randn(op.dia.shape[0], generator=gen, device=dev))
    k = BENCH_SOLVE_K
    for rec, solver, want in (("cg", cg, k + 1), ("pipelined_cg", pipelined_cg, k + 3)):
        _reset()
        res = solver(op, bp, tol=0.0, maxiter=k)
        torch.cuda.synchronize()
        counts = {c: fn.launches for c, fn in _counters().items()}
        n_l = _only(counts, "dia_spmv", want, f"[bench-solve] {rec} at k={k}")
        if res.iterations != k:
            raise AssertionError(f"[bench-solve] {rec} stopped after {res.iterations} of {k}")
        us = next(r["us_per_iteration"] for r in recs if r["solver"] == rec)
        print(f"[bench-solve] {rec}: {us / 1e3:.3f} ms an iteration (the ladder "
              f"{SOLVE_LADDER}, host clock between syncs) beside [krylov]'s "
              f"{KRYLOV_MS[rec]} ms on I + the same stencil (PERF.md §5.14; a cross-check, not "
              f"a gate); a counted solve at k={k}: {n_l} dia_spmv launches = its products; "
              f"card {card}", flush=True)
    print(f"[bench-solve] bench_solve({GRID_SPMV}) {t_bench:.1f} s (host)", flush=True)


def _busy_us(events, lo: float, hi: float) -> float:
    """Microseconds of [lo, hi] covered by the union of the events' spans."""
    spans = sorted((max(e["ts"], lo), min(e["ts"] + e["dur"], hi)) for e in events)
    busy, end = 0.0, lo
    for a, b in spans:
        a = max(a, end)
        if b > a:
            busy += b - a
            end = b
    return busy


def profile_phase(dev, card, op, b) -> None:
    """[profile]: ``trace()`` around one warm ``cg`` of 20 iterations over
    ``[cg]``'s FEM BDIA operator (an ``annotate("cg")`` range); from the
    exported Chrome trace: its size, its ``bdia_spmv`` kernel events (equal
    to the launch counter), and the share of the range in which the card
    runs no kernel, copy or set."""
    import glob
    import json
    import os

    import torch

    from cask_tpu_torch.solvers import cg
    from cask_tpu_torch.utils.profiling import annotate, trace

    cg(op, b, tol=0.0, maxiter=PROFILE_ITERS)  # warm
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        with trace(d):
            op(b)  # the profiler's first kernel, outside the range
            torch.cuda.synchronize()
            _reset()
            with annotate("cg"):
                res = cg(op, b, tol=0.0, maxiter=PROFILE_ITERS)
                torch.cuda.synchronize()
            launches = _launched("bdia_spmv", "[profile] cg")
        files = glob.glob(os.path.join(d, "*.json"))
        if len(files) != 1:
            raise AssertionError(f"[profile] trace() wrote {files}")
        size = os.path.getsize(files[0])
        with open(files[0]) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    if launches != res.iterations + 1:
        raise AssertionError(f"[profile] cg made {res.iterations} iterations and {launches} "
                             f"bdia_spmv launches (want iterations + 1)")
    ranges = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == "cg"]
    if len(ranges) != 1:
        raise AssertionError(f"[profile] {len(ranges)} 'cg' ranges in the trace")
    lo, hi = ranges[0]["ts"], ranges[0]["ts"] + ranges[0]["dur"]
    # a kernel is the range's when its launch is (the device's clock in the
    # trace is aligned to the host's only to some µs)
    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") == "cuda_runtime" and lo <= e["ts"] <= hi
                and "correlation" in e.get("args", {})}
    kernels = [e for e in events if e.get("cat") == "kernel"
               and e.get("args", {}).get("correlation") in launched]
    ours = [e for e in kernels if "bdia_spmv" in e["name"]]
    if len(ours) != launches:
        raise AssertionError(f"[profile] the range launched {len(ours)} bdia_spmv kernels by "
                             f"the trace, {launches} by the launch counter")
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy = _busy_us(device, lo, hi)
    ours_us = sum(e["dur"] for e in ours)
    print(f"[profile] trace() of cg over BdiaOperator ({op.bdia.shape[0]} rows), "
          f"{res.iterations} iterations (tol 0, maxiter {PROFILE_ITERS}): Chrome trace {size} "
          f"bytes, {len(events)} events; "
          f"{len(ours)} bdia_spmv kernel events = the launch counter {launches}; "
          f"{len(kernels)} kernels in all; the 'cg' range {hi - lo:.0f} us, the card busy "
          f"{busy:.0f} us of it (bdia_spmv {ours_us:.0f} us): idle share "
          f"{1 - busy / (hi - lo):.3f} (host clock of the profiler; its own cost per launch "
          f"included); card {card}", flush=True)



def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check runs on a GPU",
              file=sys.stderr)
        return 1

    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import scipy.sparse as sp

    import cask_tpu_torch as ct
    from cask_tpu_torch.formats.convert import csr_to_bsr, from_scipy, to_scipy
    from cask_tpu_torch.formats.generate import _diag_shift, fem_blocks, stencil_2d
    from cask_tpu_torch.ops.bdia import bdia_scalar_dia
    from cask_tpu_torch.ops.kernels import build
    from cask_tpu_torch.ops.kernels.bdia_kernels import bdia_spmv, bdia_spmv_reference
    from cask_tpu_torch.ops.kernels.dia_kernels import (dia_spmm, dia_spmm_reference,
                                                        dia_spmv, dia_spmv_reference)
    from cask_tpu_torch.ops.spmv import default_plan_cache
    from cask_tpu_torch.ops.bdia import remainder_spmm
    from cask_tpu_torch.ops.bdia_slab import slab_auto_plan
    from cask_tpu_torch.ops.bsr_spmm import BsrSpmmKernel
    from cask_tpu_torch.ops.kernels.bdia_kernels import (bdia_spmm_ring,
                                                         bdia_spmm_ring_reference)
    from cask_tpu_torch.ops.kernels.bdia_slab_kernels import (bdia_spmm_slab,
                                                              bdia_spmm_slab_padded,
                                                              bdia_spmm_slab_reference)
    from cask_tpu_torch.ops.kernels.bsr_kernels import bsr_spmm, bsr_spmm_reference
    from cask_tpu_torch.ops.kernels.lell_kernels import lell_lane_sums, lell_lane_sums_reference
    from cask_tpu_torch.ops.kernels.poh_kernels import (poh_spmm, poh_spmm_reference, poh_spmv,
                                                        poh_spmv_reference)
    from cask_tpu_torch.formats.generate import power_law
    from cask_tpu_torch.solvers import jacobi
    from cask_tpu_torch.tune.timing import time_cuda
    from cask_tpu_torch.utils.platform import default_device, hbm_bandwidth

    t_start = time.perf_counter()
    t_lap = t_start
    dev = default_device()
    kind = torch.cuda.get_device_name(0)
    card = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {kind}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"TF32 off (matmul and cudnn); name and power limit:", flush=True)
    print(card, flush=True)

    t_lap = _lap("device", t_lap)
    # -- 2. build: one nvcc per source, all started together ---------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:  # g++ for the native core beside them
        native = pool.submit(_build_native)
        libs = build.build_all(KERNELS)
        native_path, t_native, native_fresh = native.result()
    t_build = time.perf_counter() - t0
    for name, lib in libs.items():
        entries = _ptxas(lib.with_suffix(".log").read_text())
        regs = "/".join(str(r) for _, r, _ in entries)
        print(f"[build] {name}.cu ({t_build:.1f} s for all {len(libs)}, built together); "
              f"ptxas: {len(entries)} kernels, registers {regs}, spill bytes "
              f"{sum(sp for _, _, sp in entries)}", flush=True)
        for what, pattern in (("windowed", WINDOWED), ("redesigned", REDESIGNED_SUMMED)):
            group = [(r, sp) for kernel, r, sp in entries if re.search(pattern, kernel)]
            if group:
                spilled = sum(sp for _, sp in group)
                print(f"[build]   {len(group)} {what} kernels: registers "
                      f"{min(r for r, _ in group)}-{max(r for r, _ in group)}, {spilled} spill "
                      f"bytes", flush=True)
                if spilled:
                    raise AssertionError(f"{name}.cu: the {what} kernels spill {spilled} bytes")
        for kernel, r, spilled in entries:
            short = re.search(REDESIGNED, kernel)
            if short is None:
                if spilled:
                    print(f"[build]   {kernel}: {r} registers, {spilled} spill bytes", flush=True)
                continue
            print(f"[build]   {short.group(0)}: {r} registers, {spilled} spill bytes", flush=True)
            if spilled:
                raise AssertionError(f"{short.group(0)} spills {spilled} bytes")

    print(f"[native] {native_path.rsplit('/', 1)[-1]}: g++ -O3 -march=native of the port's "
          f"native/src/preprocess.cpp, {'built' if native_fresh else 'found built'} in "
          f"{t_native:.1f} s (beside the nvcc builds); available", flush=True)

    t_lap = _lap("build", t_lap)
    # -- 3. BDIA kernel vs plain twin, small ---------------------------------
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
            err_sp = _relerr(y, torch.from_numpy(to_scipy(bsr).astype(np.float64)
                                                 @ x.cpu().double().numpy()))
            _check(f"{name} {dt.__name__} kernel vs scipy", err_sp, 10 * tol)
            worst[dt] = max(worst[dt], err)
    print(f"[small] {len(cases)} plans x f32/f64 (remainder: "
          f"{cases[-2][0]}, (4,2) blocks: {cases[-1][0]}): kernel vs twin worst "
          f"{worst[np.float32]:.2e} f32 (tol {F32_TOL:.0e}), {worst[np.float64]:.2e} f64 "
          f"(tol {F64_TOL:.0e})", flush=True)

    t_lap = _lap("small", t_lap)
    # -- 4. DIA kernels vs plain twins and scipy, small -----------------------
    worst = {np.float32: 0.0, np.float64: 0.0}
    n_checks = 0
    for name, s64 in _dia_cases().items():
        for dt in (np.float32, np.float64):
            s = s64.astype(dt)
            plan = ct.dia_plan(from_scipy(s), device=dev)
            if name.endswith("transposed"):
                plan, s = ct.transposed(plan), s.T.tocsr()
            tol = F32_TOL if dt == np.float32 else F64_TOL
            for k in (None, 1, 20, 32, 100, 128):
                shape = (s.shape[1],) if k is None else (s.shape[1], k)
                x = torch.from_numpy(rng.standard_normal(shape).astype(dt)).to(dev)
                y, y_twin = ((plan.spmv(x), plan._spmv_reference(x)) if k is None
                             else (plan.spmm(x), plan._spmm_reference(x)))
                torch.cuda.synchronize()
                what = f"{name} {dt.__name__} {'spmv' if k is None else f'spmm k={k}'}"
                err = _relerr(y, y_twin)
                _check(f"{what} kernel vs twin", err, tol)
                y_sp = s.astype(np.float64) @ x.cpu().double().numpy()
                _check(f"{what} kernel vs scipy", _relerr(y, torch.from_numpy(y_sp)), tol)
                worst[dt] = max(worst[dt], err)
                n_checks += 1
    print(f"[small-dia] {n_checks} products (8 plans x f32/f64 x spmv + spmm k in "
          f"1/20/32/100/128, remainder and tall transposed plan included): kernel vs twin "
          f"worst {worst[np.float32]:.2e} f32 (tol {F32_TOL:.0e}), {worst[np.float64]:.2e} "
          f"f64 (tol {F64_TOL:.0e}); vs scipy f64 within the same tolerances", flush=True)

    t_lap = _lap("small-dia", t_lap)
    # -- 5. wide-k kernels vs plain twins and scipy, small -------------------
    worst = {np.float32: 0.0, np.float64: 0.0}
    n_checks, widths = 0, []
    for name, b64 in _slab_cases().items():
        for dt in (np.float32, np.float64):
            bsr = b64.astype(dt)
            s_dt = to_scipy(bsr).astype(np.float64)
            wplan = ct.bdia_plan(bsr, device=dev)
            sl = slab_auto_plan(wplan)
            if sl is None:
                raise AssertionError(f"{name}: no slab plan")
            widths.append((sl.g, sl.width))
            tol = F32_TOL if dt == np.float32 else F64_TOL
            for k in (1, 65, 128):
                x = torch.from_numpy(rng.standard_normal((bsr.shape[1], k)).astype(dt)).to(dev)
                y_sp = torch.from_numpy(s_dt @ x.cpu().double().numpy())
                y_rem = remainder_spmm(wplan.rem_data, wplan.rem_row, wplan.rem_col,
                                       bsr.shape[0], x, x.dtype)
                bp = BsrSpmmKernel.plan(bsr, k, device=dev)
                xp = sl.to_padded(x)
                for what, y, twin, full in (
                        ("slab", bdia_spmm_slab(sl, x), bdia_spmm_slab_reference(sl, x), None),
                        ("slab padded", bdia_spmm_slab_padded(sl, xp),
                         bdia_spmm_slab_reference(sl, xp, padded=True), None),
                        ("ring", bdia_spmm_ring(wplan, x), bdia_spmm_ring_reference(wplan, x),
                         None),
                        ("bsr", bp(x), bsr_spmm_reference(bp, x), 0)):
                    torch.cuda.synchronize()
                    err = _relerr(y, twin)
                    _check(f"{name} {dt.__name__} k={k} {what} kernel vs twin", err, tol)
                    if full is None:  # the slab and ring kernels leave out the remainder
                        full = (sl.from_padded(y, k) if what == "slab padded" else y) + y_rem
                    else:
                        full = y
                    _check(f"{name} {dt.__name__} k={k} {what} vs scipy f64",
                           _relerr(full, y_sp), tol)
                    worst[dt] = max(worst[dt], err)
                    n_checks += 1
    print(f"[small-slab] {n_checks} products (8 plans x f32/f64 x k in 1/65/128 x slab, slab "
          f"padded, ring, bsr; (g, W) of the slab plans {sorted(set(widths))}): kernel vs twin "
          f"worst {worst[np.float32]:.2e} f32 (tol {F32_TOL:.0e}), {worst[np.float64]:.2e} f64 "
          f"(tol {F64_TOL:.0e}); vs scipy f64 within the same tolerances", flush=True)
    # the f32 slab kernel's 4xTF32 on values whose low mantissa bits one TF32
    # pass drops: it must stay within TF32_TOL of f64 where one pass does not
    low = fem_blocks(16, dof=4, dtype=np.float32, return_bsr=True)
    low = dataclasses.replace(low, data=_low_bits(np.asarray(low.data)))
    sl = slab_auto_plan(ct.bdia_plan(low, device=dev))
    x = torch.from_numpy(_low_bits(rng.standard_normal((low.shape[1], K_WIDE))
                                   .astype(np.float32))).to(dev)
    sl64 = dataclasses.replace(sl, slabs=sl.slabs.double())
    errs = []
    for padded, entry in ((False, bdia_spmm_slab), (True, bdia_spmm_slab_padded)):
        xin = sl.to_padded(x) if padded else x
        y = entry(sl, xin)
        torch.cuda.synchronize()
        exact = bdia_spmm_slab_reference(sl64, xin.double(), padded=padded)
        one = bdia_spmm_slab_reference(dataclasses.replace(sl, slabs=_tf32(sl.slabs)),
                                       _tf32(xin), padded=padded)
        what = f"TF32-sensitive slab{' padded' if padded else ''}"
        errs += [_relerr(y, bdia_spmm_slab_reference(sl, xin, padded=padded)),
                 _relerr(y, exact), _relerr(one, exact)]
        _check(f"{what} kernel vs twin", errs[-3], TF32_TOL)
        _check(f"{what} kernel vs f64", errs[-2], TF32_TOL)
        if not errs[-1] > 1e-5:
            raise AssertionError(f"{what}: one TF32 pass is within 1e-5 ({errs[-1]:.2e}); "
                                 f"the case does not test 4xTF32")
    err_sp = _relerr(bdia_spmm_slab(sl, x), torch.from_numpy(
        to_scipy(low).astype(np.float64) @ x.cpu().double().numpy()))
    _check("TF32-sensitive slab kernel vs scipy f64", err_sp, TF32_TOL)
    print(f"[small-slab] TF32-sensitive fem_blocks(16, dof=4) f32, k {K_WIDE}, low 12 mantissa "
          f"bits set in values and X: kernel (4xTF32) vs twin {errs[0]:.2e} / {errs[3]:.2e} "
          f"padded, vs f64 {errs[1]:.2e} / {errs[4]:.2e}, vs scipy f64 {err_sp:.2e} (tol "
          f"{TF32_TOL:.0e}); one TF32 pass (emulated) {errs[2]:.2e} vs f64", flush=True)
    del low, sl, sl64, x


    t_lap = _lap("small-slab", t_lap)
    # -- 6. POH kernels vs plain twins and scipy, small ------------------------
    worst = {np.float32: 0.0, np.float64: 0.0}
    worst_sp = {np.float32: 0.0, np.float64: 0.0}
    n_checks, tiles, cut = 0, 0, []
    for name, (s64, kw) in _poh_cases().items():
        for dt in (np.float32, np.float64):
            s = s64.astype(dt)
            pplan = ct.poh_plan(from_scipy(s), device=dev, **kw)
            pt = ct.transposed(pplan)
            tiles += pplan.ntiles
            if pplan.spmm_pieces.shape[0] > pplan.n_panels:
                cut.append(name)
            tol = F32_TOL if dt == np.float32 else F64_TOL
            for what, k in (("spmv", None), ("transposed", None), ("spmm", 1), ("spmm", 32),
                            ("spmm", 150)):
                q, sq = (pt, s.T) if what == "transposed" else (pplan, s)
                shape = (sq.shape[1],) if k is None else (sq.shape[1], k)
                x = torch.from_numpy(rng.standard_normal(shape).astype(dt)).to(dev)
                y, y_twin = ((ct.spmv(q, x), poh_spmv_reference(q, x)) if k is None
                             else (ct.spmm(q, x), poh_spmm_reference(q, x)))
                torch.cuda.synchronize()
                label = f"{name} {dt.__name__} {what}{'' if k is None else f' k={k}'}"
                err = _relerr_or_zero(y, y_twin)
                _check(f"{label} kernel vs twin", err, tol)
                y_sp = torch.from_numpy(sq.astype(np.float64) @ x.cpu().double().numpy())
                err_sp = _relerr_or_zero(y, y_sp)
                _check(f"{label} kernel vs scipy f64", err_sp, tol)
                worst[dt] = max(worst[dt], err)
                worst_sp[dt] = max(worst_sp[dt], err_sp)
                n_checks += 1
    if "hub row (a cut panel)" not in cut:
        raise AssertionError("the hub-row plan has no cut panel")
    print(f"[small-poh] {n_checks} products ({len(_poh_cases())} plans, {tiles} tiles in all, "
          f"x f32/f64 x spmv, transposed spmv, spmm k in 1/32/150; plans with a cut panel "
          f"{sorted(set(cut))}): kernel vs twin worst "
          f"{worst[np.float32]:.2e} f32, {worst[np.float64]:.2e} f64; vs scipy f64 worst "
          f"{worst_sp[np.float32]:.2e} f32 (tol {F32_TOL:.0e}), {worst_sp[np.float64]:.2e} "
          f"f64 (tol {F64_TOL:.0e})", flush=True)

    t_lap = _lap("small-poh", t_lap)
    # -- 7. LELL kernel vs plain twin and scipy, small -------------------------
    worst = {np.float32: 0.0, np.float64: 0.0}
    n_checks = 0
    for name, s64 in _lell_cases().items():
        for dt in (np.float32, np.float64):
            s = s64.astype(dt)
            tol = F32_TOL if dt == np.float32 else F64_TOL
            x = torch.from_numpy(rng.standard_normal(s.shape[1]).astype(dt)).to(dev)
            y_sp = torch.from_numpy(s.astype(np.float64) @ x.cpu().double().numpy())
            plans = [(what, lp) for what, lp, _ in _lell_tiers(from_scipy(s), dev)]
            plans.append(("hyb", ct.lell_plan_hyb(from_scipy(s), device=dev)))
            for what, lp in plans:
                tiers = [lp] if what != "hyb" else [lp.main, lp.hub]
                for tier in tiers:
                    g = getattr(tier, "groups", 1)
                    err = _relerr_or_zero(lell_lane_sums(tier.vals, tier.idx, x, g),
                                          lell_lane_sums_reference(tier.vals, tier.idx, x, g))
                    _check(f"{name} {dt.__name__} {what} kernel vs twin", err, tol)
                    worst[dt] = max(worst[dt], err)
                y = lp.spmv(x)
                torch.cuda.synchronize()
                err = _relerr_or_zero(y, lp._spmv_reference(x))
                _check(f"{name} {dt.__name__} {what} spmv vs twin", err, tol)
                worst[dt] = max(worst[dt], err)
                if what in ("two trailing padding layers", "61 slot rows"):
                    continue  # cut or padded by hand: the twin is the reference
                _check(f"{name} {dt.__name__} {what} spmv vs scipy f64", _relerr(y, y_sp), tol)
                n_checks += 1
    print(f"[small-lell] {n_checks} products ({len(_lell_cases())} matrices x f32/f64 x "
          f"lell_plan groups {'/'.join(map(str, LELL_GROUPS))}, one layer, trailing padding "
          f"layers, 61 slot rows and lell_plan_hyb; the 500x70000 one past the reference's "
          f"4096*B cap): lane sums and spmv vs twin worst {worst[np.float32]:.2e} f32, "
          f"{worst[np.float64]:.2e} f64; spmv vs scipy f64 within {F32_TOL:.0e} / "
          f"{F64_TOL:.0e}", flush=True)

    t_lap = _lap("small-lell", t_lap)
    # -- 7b. bf16 and f16 values of the block and banded kernels vs twins, small
    for h in (torch.bfloat16, torch.float16):
        small_block_half(rng, dev, h)
        t_lap = _lap(f"small-{_short(h)}", t_lap)
    # -- 7c. bf16 and f16 values of B7, B16-B18: every kernel vs its twin -------
    small_half(rng, dev)

    t_lap = _lap("small-half", t_lap)
    # -- 8. main path: spmv(bsr, x) at full size ------------------------------
    t0 = time.perf_counter()
    a_host = fem_blocks(NX, dof=DOF, dtype=np.float32, seed=SEED, return_bsr=True)
    t_gen = time.perf_counter() - t0
    a = a_host.to(dev)
    x = torch.from_numpy(rng.standard_normal(a.shape[1]).astype(np.float32)).to(dev)
    _reset()
    t0 = time.perf_counter()
    y = ct.spmv(a, x)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches_spmv = _launched("bdia_spmv", "spmv(bsr, x)")
    plan = default_plan_cache.get(a)
    y_twin = plan._spmv_reference(x)
    err_twin = _relerr(y, y_twin)
    _check("1M spmv kernel vs twin", err_twin, F32_TOL)
    abs_spmv = float((y - y_twin).abs().max())
    a_sp = to_scipy(a_host)
    y_sp = a_sp.astype(np.float64) @ x.cpu().double().numpy()
    err_sp = _relerr(y, torch.from_numpy(y_sp))
    _check("1M spmv kernel vs scipy f64", err_sp, F32_TOL)
    print(f"[spmv] {a.shape[0]} rows, nnz {a.nnz}, vals {tuple(plan.vals.shape)}, "
          f"offsets {plan.block_offsets}, ts {plan.ts}; host gen {t_gen:.1f} s, first call "
          f"(plan + launch) {t_first:.1f} s; launches {launches_spmv}; vs twin {err_twin:.2e} "
          f"(max abs {abs_spmv:.2e}), vs scipy f64 {err_sp:.2e} (tol {F32_TOL:.0e})", flush=True)
    fem_host_s = t_gen + t_first  # beside [device-gen]'s generation on the card

    t_lap = _lap("spmv", t_lap)
    # -- 9. CG over BdiaOperator on the SPD block system ------------------------
    t0 = time.perf_counter()
    s_csr = _diag_shift(from_scipy((a_sp + a_sp.T).tocsr()), 1.1)
    s_bsr = csr_to_bsr(s_csr, (DOF, DOF))
    op = ct.BdiaOperator(ct.bdia_plan(s_bsr, device=dev))
    b = torch.from_numpy(rng.standard_normal(s_bsr.shape[0]).astype(np.float32)).to(dev)
    t_sys = time.perf_counter() - t0
    _reset()
    t0 = time.perf_counter()
    res = ct.solvers.cg(op, b, tol=1e-6, maxiter=200)
    torch.cuda.synchronize()
    t_cg = time.perf_counter() - t0
    launches_cg = _launched("bdia_spmv", "cg over BdiaOperator")
    if not res.converged:
        raise AssertionError(f"cg did not converge: {res.iterations} iterations, "
                             f"residual {res.residual_norm:.3e}")
    s64 = to_scipy(s_csr).astype(np.float64)
    b64 = b.cpu().double().numpy()
    true_rel = float(np.linalg.norm(b64 - s64 @ res.x.cpu().double().numpy())
                     / np.linalg.norm(b64))
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
          f"{true_rel:.2e} (f64 host, tol 1e-5); system build {t_sys:.1f} s; "
          f"launches {launches_cg}", flush=True)
    cg32 = (res.iterations, t_warm / max(warm.iterations, 1) * 1e6)  # beside the bf16 run's
    y_op, y_op_twin = op(b), op.bdia._spmv_reference(b)  # counts were read above
    _check("1M operator kernel vs twin", _relerr(y_op, y_op_twin), F32_TOL)
    abs_op = float((y_op - y_op_twin).abs().max())
    sb_sp = to_scipy(s_csr)  # the operator's matrix, for the library call
    del res, warm

    t_lap = _lap("cg", t_lap)
    # -- 10. main path: block_cg over the same system's BDIA plan, s = 128 -------
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    B = torch.randn((s_bsr.shape[0], K_WIDE), generator=gen, device=dev, dtype=torch.float32)
    M = ct.solvers.jacobi(s_csr, device=dev)
    _reset()
    t0 = time.perf_counter()
    res = ct.solvers.block_cg(op.bdia, B, tol=1e-6, maxiter=100, M=M)
    torch.cuda.synchronize()
    t_bcg = time.perf_counter() - t0
    launches_bcg = _launched("bdia_spmm_slab", "block_cg over the BDIA plan")
    if launches_bcg != res.iterations + 1:
        raise AssertionError(f"block_cg launched the slab kernel {launches_bcg} times for "
                             f"{res.iterations} iterations (want iterations + 1)")
    if not res.converged:
        raise AssertionError(f"block_cg did not converge: {res.iterations} iterations, "
                             f"worst residual {res.residual_norm:.3e}")
    B64 = B.cpu().double().numpy()
    col_rel = (np.linalg.norm(B64 - s64 @ res.x.cpu().double().numpy(), axis=0)
               / np.linalg.norm(B64, axis=0))
    if not col_rel.max() <= 1e-6:
        raise AssertionError(f"block_cg worst true column residual {col_rel.max():.3e} > 1e-6")
    # two warm solves: the host clock of one varies from run to run
    t_warm = []
    for _ in range(2):
        t0 = time.perf_counter()
        warm = ct.solvers.block_cg(op.bdia, B, tol=1e-6, maxiter=100, M=M)
        torch.cuda.synchronize()
        t_warm.append((time.perf_counter() - t0) / max(warm.iterations, 1))
    print(f"[block-cg] {s_bsr.shape[0]} rows, s = {K_WIDE} right-hand sides (torch.Generator "
          f"on the card), jacobi, tol 1e-6: converged {res.converged} in {res.iterations} "
          f"iterations; first solve {t_bcg * 1e3:.1f} ms (slab plan built in it), two warm "
          f"solves {t_warm[0] * 1e3:.2f} and {t_warm[1] * 1e3:.2f} ms per iteration (host "
          f"clock, one host sync per iteration); slab launches {launches_bcg} "
          f"= {launches_bcg / (res.iterations + 1):.2f} per operator application "
          f"({res.iterations} iterations + the first residual); worst true column residual "
          f"{col_rel.max():.2e} (f64 host, tol 1e-6)", flush=True)
    del s64, res, warm, B, B64, M  # s_csr and s_bsr return at [cg-bf16]

    t_lap = _lap("block-cg", t_lap)
    # -- 11. main path: spmv(csr, x) on the 4M-row stencil ----------------------
    t0 = time.perf_counter()
    st_host = stencil_2d(GRID_SPMV, dtype=np.float32)
    st_sp = to_scipy(st_host)
    t_gen = time.perf_counter() - t0
    st = st_host.to(dev)
    xs = torch.from_numpy(rng.standard_normal(st.shape[1]).astype(np.float32)).to(dev)
    _reset()
    t0 = time.perf_counter()
    ys = ct.spmv(st, xs)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches_dspmv = _launched("dia_spmv", "spmv(csr, x)")
    dplan = default_plan_cache.get(st)
    ys_twin = dplan._spmv_reference(xs)
    err_twin = _relerr(ys, ys_twin)
    _check("4M dia spmv kernel vs twin", err_twin, F32_TOL)
    abs_dspmv = float((ys - ys_twin).abs().max())
    err_sp = _relerr(ys, torch.from_numpy(st_sp.astype(np.float64) @ xs.cpu().double().numpy()))
    _check("4M dia spmv kernel vs scipy f64", err_sp, F32_TOL)
    print(f"[dia-spmv] {st.shape[0]} rows, nnz {st.nnz}, vals {tuple(dplan.vals.shape)}, "
          f"offsets {dplan.offsets}, remainder {dplan.rem_data.shape[0]}; host gen "
          f"{t_gen:.1f} s, first call (plan + launch) {t_first:.1f} s; launches "
          f"{launches_dspmv}; vs twin {err_twin:.2e} (max abs {abs_dspmv:.2e}), vs scipy f64 "
          f"{err_sp:.2e} (tol {F32_TOL:.0e})", flush=True)
    sten_host_s = t_gen + t_first

    t_lap = _lap("dia-spmv", t_lap)
    # -- 12. main path: cg(solver_operator(S), b), S = I + stencil --------------
    t0 = time.perf_counter()
    s_sp = (sp.identity(st_sp.shape[0], dtype=np.float32, format="csr") + st_sp).tocsr()
    s_port = from_scipy(s_sp)  # the bf16 run casts the same matrix
    dop = ct.solver_operator(s_port)
    bs = torch.from_numpy(rng.standard_normal(s_sp.shape[0]).astype(np.float32)).to(dev)
    t_sys = time.perf_counter() - t0
    _reset()
    t0 = time.perf_counter()
    res = ct.solvers.cg(dop, dop.to_padded(bs), tol=1e-6, maxiter=500)
    torch.cuda.synchronize()
    t_cg = time.perf_counter() - t0
    launches_dcg = _launched("dia_spmv", "cg over solver_operator")
    if not res.converged:
        raise AssertionError(f"dia cg did not converge: {res.iterations} iterations, "
                             f"residual {res.residual_norm:.3e}")
    b64 = bs.cpu().double().numpy()
    x64 = dop.from_padded(res.x).cpu().double().numpy()
    true_rel = float(np.linalg.norm(b64 - s_sp.astype(np.float64) @ x64) / np.linalg.norm(b64))
    if not true_rel <= 1e-5:
        raise AssertionError(f"dia cg true relative residual {true_rel:.3e} > 1e-5")
    t0 = time.perf_counter()
    warm = ct.solvers.cg(dop, dop.to_padded(bs), tol=1e-6, maxiter=500)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    print(f"[dia-cg] mode {dop.mode}, {s_sp.shape[0]} rows, nnz {s_sp.nnz}, offsets "
          f"{dop.dia.offsets}: converged in {res.iterations} iterations, first solve "
          f"{t_cg * 1e3:.1f} ms, warm solve {t_warm * 1e3:.2f} ms = "
          f"{t_warm / max(warm.iterations, 1) * 1e6:.0f} us per iteration (host clock, one "
          f"host sync per iteration); true relative residual {true_rel:.2e} (f64 host, tol "
          f"1e-5); system build {t_sys:.1f} s; launches {launches_dcg}", flush=True)
    dcg32 = (res.iterations, t_warm / max(warm.iterations, 1) * 1e6)  # beside the bf16 run's
    yd_op, yd_twin = dop(bs), dop.dia._spmv_reference(bs)
    _check("4M operator kernel vs twin", _relerr(yd_op, yd_twin), F32_TOL)
    abs_dop = float((yd_op - yd_twin).abs().max())
    del res, warm, x64, b64

    t_lap = _lap("dia-cg", t_lap)
    # -- 13. main paths: spmm(csr, X) and spmm(bsr, X), k = 32 -----------------
    t0 = time.perf_counter()
    mm_host = stencil_2d(GRID_SPMM, dtype=np.float32)
    mm_sp = to_scipy(mm_host)
    mm = mm_host.to(dev)
    X = torch.from_numpy(rng.standard_normal((mm.shape[1], K)).astype(np.float32)).to(dev)
    t_gen = time.perf_counter() - t0
    _reset()
    t0 = time.perf_counter()
    Y = ct.spmm(mm, X)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches_mm_csr = _launched("dia_spmm", "spmm(csr, X)")
    mplan = default_plan_cache.get(mm)
    Y_twin = mplan._spmm_reference(X)
    err_twin = _relerr(Y, Y_twin)
    _check("1M spmm(csr) kernel vs twin", err_twin, F32_TOL)
    abs_mm_csr = float((Y - Y_twin).abs().max())
    err_sp = _relerr(Y, torch.from_numpy(mm_sp.astype(np.float64) @ X.cpu().double().numpy()))
    _check("1M spmm(csr) kernel vs scipy f64", err_sp, F32_TOL)
    print(f"[spmm] csr: {mm.shape[0]} rows, k {K}, offsets {mplan.offsets}; host gen "
          f"{t_gen:.1f} s, first call (plan + launch) {t_first:.1f} s; launches "
          f"{launches_mm_csr}; vs twin {err_twin:.2e} (max abs {abs_mm_csr:.2e}), vs scipy "
          f"f64 {err_sp:.2e} (tol {F32_TOL:.0e})", flush=True)
    Xb = torch.from_numpy(rng.standard_normal((a.shape[1], K)).astype(np.float32)).to(dev)
    _reset()
    t0 = time.perf_counter()
    Yb = ct.spmm(a, Xb)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches_mm_bsr = _launched("dia_spmm", "spmm(bsr, X)")
    splan = bdia_scalar_dia(default_plan_cache.get(a))
    Yb_twin = splan._spmm_reference(Xb)
    err_twin = _relerr(Yb, Yb_twin)
    _check("1M spmm(bsr) kernel vs twin", err_twin, F32_TOL)
    abs_mm_bsr = float((Yb - Yb_twin).abs().max())
    err_sp = _relerr(Yb, torch.from_numpy(a_sp.astype(np.float64) @ Xb.cpu().double().numpy()))
    _check("1M spmm(bsr) kernel vs scipy f64", err_sp, F32_TOL)
    print(f"[spmm] bsr: {a.shape[0]} rows, k {K}, scalar-DIA plan {splan.ndiags} diagonals "
          f"(offsets {splan.offsets}), {splan.vals.numel() * 4 / 1e6:.1f} MB of values (the "
          f"BDIA plan's {plan.vals.numel() * 4 / 1e6:.1f}), remainder {splan.rem_data.shape[0]}; first call (BDIA "
          f"plan cached, scalar-DIA plan + launch) {t_first:.1f} s; launches "
          f"{launches_mm_bsr}; vs twin {err_twin:.2e} (max abs {abs_mm_bsr:.2e}), vs scipy "
          f"f64 {err_sp:.2e} (tol {F32_TOL:.0e})", flush=True)
    del Y, Y_twin, Yb, Yb_twin
    # the same stencil at k = 128 (BASELINE config 3's wide k): B13 on its
    # 5-diagonal plan
    Xsw = torch.from_numpy(rng.standard_normal((mm.shape[1], K_WIDE)).astype(np.float32)).to(dev)
    _reset()
    Ysw = ct.spmm(mm, Xsw)
    torch.cuda.synchronize()
    launches_mm_csr_w = _launched("dia_spmm", f"spmm(csr, X), k={K_WIDE}")
    Ysw_twin = mplan._spmm_reference(Xsw)
    err_twin = _relerr(Ysw, Ysw_twin)
    _check(f"1M spmm(csr) k={K_WIDE} kernel vs twin", err_twin, F32_TOL)
    abs_mm_csr_w = float((Ysw - Ysw_twin).abs().max())
    err_sp = _relerr(Ysw[:, :SCIPY_COLS], torch.from_numpy(
        mm_sp.astype(np.float64) @ Xsw[:, :SCIPY_COLS].cpu().double().numpy()))
    _check(f"1M spmm(csr) k={K_WIDE} kernel vs scipy f64", err_sp, F32_TOL)
    print(f"[spmm] csr, k {K_WIDE}: launches {launches_mm_csr_w}; vs twin {err_twin:.2e} (max "
          f"abs {abs_mm_csr_w:.2e}), vs scipy f64 on {SCIPY_COLS} columns {err_sp:.2e} (tol "
          f"{F32_TOL:.0e})", flush=True)
    del Ysw, Ysw_twin

    t_lap = _lap("spmm", t_lap)
    # -- 14. main paths at k = 128: slab, ring, BSR and scalar-DIA SpMM ---------
    Xw = torch.randn((a.shape[1], K_WIDE), generator=gen, device=dev, dtype=torch.float32)
    Yw_sp = torch.from_numpy(a_sp.astype(np.float64) @ Xw[:, :SCIPY_COLS].cpu().double().numpy())

    def wide_check(what, y, twin):
        """kernel vs twin on every column, vs scipy f64 on the first SCIPY_COLS"""
        err = _relerr(y, twin)
        _check(f"1M {what} kernel vs twin", err, F32_TOL)
        err_sp = _relerr(y[:, :SCIPY_COLS], Yw_sp)
        _check(f"1M {what} vs scipy f64 ({SCIPY_COLS} columns)", err_sp, F32_TOL)
        return err, err_sp, float((y - twin).abs().max())

    _reset()
    t0 = time.perf_counter()
    Yw = ct.spmm(a, Xw)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches_slab = _launched("bdia_spmm_slab", f"spmm(bsr, X) at k={K_WIDE}")
    if launches_slab != 1:
        raise AssertionError(f"spmm(bsr, X) at k={K_WIDE} launched the slab kernel "
                             f"{launches_slab} times, not 1")
    if _counters()["dia_spmm"].launches:
        raise AssertionError(f"spmm(bsr, X) at k={K_WIDE} launched dia_spmm")
    sl = default_plan_cache.get(plan, "slab")
    err, err_sp, abs_slab = wide_check("spmm(bsr, X) slab", Yw, bdia_spmm_slab_reference(sl, Xw))
    print(f"[spmm-wide] slab: spmm(bsr, X), {a.shape[0]} rows, k {K_WIDE}: slab plan g {sl.g}, "
          f"W {sl.width}, {sl.slabs.numel() * sl.slabs.element_size() / 1e6:.1f} MB, far "
          f"offsets {sl.far_offsets}; first call (slab plan built + launch) {t_first:.2f} s; "
          f"launches slab {launches_slab}, dia_spmm 0; vs twin {err:.2e} (max abs "
          f"{abs_slab:.2e}), vs scipy f64 {err_sp:.2e} on {SCIPY_COLS} of {K_WIDE} columns "
          f"(tol {F32_TOL:.0e})", flush=True)
    del Yw
    # the f64 slab keeps the plain FMA kernel: right, and its time
    sl64 = dataclasses.replace(sl, slabs=sl.slabs.double())
    Xw64 = Xw.double()
    err64 = _relerr(bdia_spmm_slab(sl64, Xw64), bdia_spmm_slab_reference(sl64, Xw64))
    _check("1M f64 slab kernel vs twin", err64, F64_TOL)
    ms64 = time_cuda(lambda: bdia_spmm_slab(sl64, Xw64), warmup=2, runs=10, reps=3).ms
    print(f"[spmm-wide] slab f64 (FMA kernel), k {K_WIDE}: vs twin {err64:.2e} (tol "
          f"{F64_TOL:.0e}); kernel {ms64 * 1e3:.1f} us (CUDA events, median of 10 samples of 3 "
          f"calls); card {card}", flush=True)
    del sl64, Xw64
    _reset()
    Yr = ct.spmm(plan, Xw, method="pallas_bdia")
    torch.cuda.synchronize()
    launches_ring = _launched("bdia_spmm_ring", "spmm(plan, X, method='pallas_bdia')")
    err, err_sp, abs_ring = wide_check("ring", Yr, bdia_spmm_ring_reference(plan, Xw))
    print(f"[spmm-wide] ring: spmm(plan, X, method='pallas_bdia'): {plan.npairs} pairs; "
          f"launches {launches_ring}; vs twin {err:.2e} (max abs {abs_ring:.2e}), vs scipy f64 "
          f"{err_sp:.2e} on {SCIPY_COLS} columns", flush=True)
    del Yr
    _reset()
    t0 = time.perf_counter()
    Yb = ct.spmm(a, Xw, method="pallas_bsr")
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches_bsr = _launched("bsr_spmm", "spmm(bsr, X, method='pallas_bsr')")
    bplan = BsrSpmmKernel.plan(a, K_WIDE)
    err, err_sp, abs_bsr = wide_check("bsr", Yb, bsr_spmm_reference(bplan, Xw))
    print(f"[spmm-wide] bsr: spmm(bsr, X, method='pallas_bsr'): ELL vals "
          f"{tuple(bplan.vals.shape)}, G {bplan.G}, K {bplan.K}; first call (ELL plan + "
          f"launch) {t_first:.2f} s; launches {launches_bsr}; vs twin {err:.2e} (max abs "
          f"{abs_bsr:.2e}), vs scipy f64 {err_sp:.2e} on {SCIPY_COLS} columns", flush=True)
    del Yb
    _reset()
    Yd = ct.spmm(splan, Xw)
    torch.cuda.synchronize()
    launches_dia_w = _launched("dia_spmm", f"spmm(scalar-DIA plan, X) at k={K_WIDE}")
    err, err_sp, abs_dia_w = wide_check("scalar DIA", Yd, splan._spmm_reference(Xw))
    print(f"[spmm-wide] scalar DIA: spmm(scalar-DIA plan, X), {splan.ndiags} diagonals (the "
          f"route spmm(bsr, X) took at k > 64 before the slab); launches {launches_dia_w}; vs "
          f"twin {err:.2e} (max abs {abs_dia_w:.2e}), vs scipy f64 {err_sp:.2e} on "
          f"{SCIPY_COLS} columns", flush=True)
    del Yd


    t_lap = _lap("spmm-wide", t_lap)
    # -- 15. main path: spmv(poh_plan(A), x) on the 1M-row power law -----------
    t0 = time.perf_counter()
    pl_host = power_law(PL_N, avg_degree=PL_DEGREE, dtype=np.float32, seed=PL_SEED)
    t_gen = time.perf_counter() - t0
    pl_sp = to_scipy(pl_host)
    t0 = time.perf_counter()
    pplan = ct.poh_plan(pl_host, device=dev)
    torch.cuda.synchronize()
    t_plan = time.perf_counter() - t0
    per_panel = torch.diff(pplan.panel_ptr).cpu().numpy()
    xp = torch.from_numpy(rng.standard_normal(PL_N).astype(np.float32)).to(dev)
    _reset()
    yp = ct.spmv(pplan, xp)
    torch.cuda.synchronize()
    launches_poh = _launched("poh_spmv", "spmv(poh, x)")
    if launches_poh != 1:
        raise AssertionError(f"spmv(poh, x) launched poh_spmv {launches_poh} times, not 1")
    yp_twin = poh_spmv_reference(pplan, xp)
    err_twin = _relerr(yp, yp_twin)
    _check("1M poh spmv kernel vs twin", err_twin, F32_TOL)
    abs_poh = float((yp - yp_twin).abs().max())
    err_sp = _relerr(yp, torch.from_numpy(pl_sp.astype(np.float64) @ xp.cpu().double().numpy()))
    _check("1M poh spmv kernel vs scipy f64", err_sp, F32_TOL)
    print(f"[poh-spmv] power_law({PL_N}, avg_degree={PL_DEGREE}, seed={PL_SEED}) f32: nnz "
          f"{pl_host.nnz}, host gen {t_gen:.1f} s, poh_plan {t_plan:.1f} s; R {pplan.row_panel}, "
          f"C {pplan.col_window}, {pplan.n_panels} panels, {pplan.ntiles} tiles, "
          f"{pplan.vals.numel()} slots, fill {pplan.fill():.3f}, tiles per panel max "
          f"{per_panel.max()} mean {per_panel.mean():.1f}; launches {launches_poh}; vs twin "
          f"{err_twin:.2e} (max abs {abs_poh:.2e}), vs scipy f64 {err_sp:.2e} "
          f"(tol {F32_TOL:.0e})", flush=True)
    del yp, yp_twin

    t_lap = _lap("poh-spmv", t_lap)
    # -- 16. main path: spmm(poh, X) at k = 32 ---------------------------------
    Xp = torch.randn((PL_N, K), generator=gen, device=dev, dtype=torch.float32)
    _reset()
    Yp = ct.spmm(pplan, Xp)
    torch.cuda.synchronize()
    launches_pohmm = _launched("poh_spmm", f"spmm(poh, X) at k={K}")
    if launches_pohmm != 1:
        raise AssertionError(f"spmm(poh, X) launched poh_spmm {launches_pohmm} times, not 1")
    Yp_twin = poh_spmm_reference(pplan, Xp)
    err_twin = _relerr(Yp, Yp_twin)
    _check("1M poh spmm kernel vs twin", err_twin, F32_TOL)
    abs_pohmm = float((Yp - Yp_twin).abs().max())
    del Yp_twin
    err_sp = _relerr(Yp[:, :SCIPY_COLS], torch.from_numpy(
        pl_sp.astype(np.float64) @ Xp[:, :SCIPY_COLS].cpu().double().numpy()))
    _check("1M poh spmm kernel vs scipy f64", err_sp, F32_TOL)
    pieces = pplan.spmm_pieces.cpu().numpy()
    print(f"[poh-spmm] spmm(poh, X), k {K} (torch.Generator on the card): {pieces.shape[0]} "
          f"pieces ({int(pieces[:, 3].sum())} of them from {len(set(pieces[pieces[:, 3] == 1, 0]))} "
          f"cut panels, at most {int((pieces[:, 2] - pieces[:, 1]).max())} tiles) of "
          f"{pplan.n_panels} panels; launches {launches_pohmm}; vs twin {err_twin:.2e} (max abs {abs_pohmm:.2e}), vs scipy f64 "
          f"{err_sp:.2e} on {SCIPY_COLS} columns (tol {F32_TOL:.0e})", flush=True)
    del Yp

    t_lap = _lap("poh-spmm", t_lap)
    # -- 17. main path: lell_plan_hyb(A).spmv(x) -------------------------------
    t0 = time.perf_counter()
    hyb = ct.lell_plan_hyb(pl_host, device=dev)
    torch.cuda.synchronize()
    t_plan = time.perf_counter() - t0
    _reset()
    yl = hyb.spmv(xp)
    torch.cuda.synchronize()
    launches_lell = _launched("lell_spmv", "HybLell.spmv")
    if launches_lell != 2:
        raise AssertionError(f"HybLell.spmv launched the LELL kernels {launches_lell} times, "
                             f"not 2 (the grouped tier's rows, then the hub tier and the "
                             f"remainder)")
    yl_twin = hyb._spmv_reference(xp)
    err_twin = _relerr(yl, yl_twin)
    _check("1M HybLell.spmv kernel vs twin", err_twin, F32_TOL)
    abs_lell = float((yl - yl_twin).abs().max())
    err_sp = _relerr(yl, torch.from_numpy(pl_sp.astype(np.float64) @ xp.cpu().double().numpy()))
    _check("1M HybLell.spmv vs scipy f64", err_sp, F32_TOL)
    print(f"[lell] lell_plan_hyb {t_plan:.1f} s: grouped tier {tuple(hyb.main.vals.shape)} "
          f"(groups {hyb.main.groups}), hub tier {tuple(hyb.hub.vals.shape)}, remainder "
          f"{hyb.main.rem_data.shape[0]}, slot fill {hyb.main.fill():.3f} grouped, "
          f"{hyb.hub.fill():.3f} hub, traffic {hyb.traffic_bytes / 1e6:.1f} MB; launches "
          f"{launches_lell}; vs twin {err_twin:.2e} (max abs {abs_lell:.2e}), vs scipy f64 "
          f"{err_sp:.2e} (tol {F32_TOL:.0e})", flush=True)
    del yl, yl_twin

    t_lap = _lap("lell", t_lap)
    # -- 18. main path: CG with Jacobi over the POH plan of an SPD system -------
    t0 = time.perf_counter()
    spd_sp = _row_shifted_spd(pl_sp)
    spd = from_scipy(spd_sp)
    spd_plan = ct.poh_plan(spd, device=dev)
    Mp = jacobi(spd, device=dev)
    bp = torch.from_numpy(rng.standard_normal(PL_N).astype(np.float32)).to(dev)
    torch.cuda.synchronize()
    t_sys = time.perf_counter() - t0
    _reset()
    t0 = time.perf_counter()
    res = ct.solvers.cg(spd_plan, bp, tol=1e-6, maxiter=200, M=Mp)
    torch.cuda.synchronize()
    t_cg = time.perf_counter() - t0
    launches_pcg = _launched("poh_spmv", "cg over the POH plan")
    if not res.converged:
        raise AssertionError(f"poh cg did not converge: {res.iterations} iterations, "
                             f"residual {res.residual_norm:.3e}")
    if launches_pcg != res.iterations + 1:
        raise AssertionError(f"poh cg launched poh_spmv {launches_pcg} times for "
                             f"{res.iterations} iterations (want iterations + 1)")
    spd64 = spd_sp.astype(np.float64)
    b64 = bp.cpu().double().numpy()
    true_rel = float(np.linalg.norm(b64 - spd64 @ res.x.cpu().double().numpy())
                     / np.linalg.norm(b64))
    if not true_rel <= 1e-6:
        raise AssertionError(f"poh cg true relative residual {true_rel:.3e} > 1e-6")
    t0 = time.perf_counter()
    warm = ct.solvers.cg(spd_plan, bp, tol=1e-6, maxiter=200, M=Mp)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    pcg32 = (res.iterations, t_warm / max(warm.iterations, 1) * 1e6)
    print(f"[poh-cg] A + A^T, each row's diagonal raised by 1.1 x its absolute row sum: "
          f"{spd.shape[0]} rows, nnz {spd.nnz}, "
          f"{spd_plan.ntiles} tiles; jacobi, tol 1e-6: converged in {res.iterations} "
          f"iterations, first solve {t_cg * 1e3:.1f} ms, warm solve {t_warm * 1e3:.2f} ms = "
          f"{t_warm / max(warm.iterations, 1) * 1e3:.3f} ms per iteration (host clock, one "
          f"host sync per iteration); poh_spmv launches {launches_pcg} = iterations + 1; true "
          f"relative residual {true_rel:.2e} (f64 host, tol 1e-6); system build and plan "
          f"{t_sys:.1f} s", flush=True)
    del res, warm, spd_plan

    t_lap = _lap("poh-cg", t_lap)
    # [poh-cg-bf16]: the same system and Jacobi over its bf16 POH plan (B16
    # with bf16 values and f32 Krylov vectors), against the f32 solve
    t0 = time.perf_counter()
    spd_bf = ct.poh_plan(spd.to(dev).astype(torch.bfloat16))
    torch.cuda.synchronize()
    t_sys = time.perf_counter() - t0
    _reset()
    res = ct.solvers.cg(spd_bf, bp, tol=1e-6, maxiter=200, M=Mp)
    torch.cuda.synchronize()
    launches_pcg_bf = _launched("poh_spmv", "cg over the bf16 POH plan")
    if not res.converged or launches_pcg_bf != res.iterations + 1 or spd_bf.dtype != \
            torch.bfloat16:
        raise AssertionError(f"bf16 poh cg: converged {res.converged} in {res.iterations} "
                             f"iterations, {launches_pcg_bf} launches, plan {spd_bf.dtype}")
    if abs(res.iterations - pcg32[0]) > 2:
        raise AssertionError(f"bf16 poh cg took {res.iterations} iterations, the f32 solve "
                             f"{pcg32[0]} (more than 2 apart)")
    spd64_bf = _half_matrix(spd_sp, torch.bfloat16)
    true_rel = float(np.linalg.norm(b64 - spd64_bf @ res.x.cpu().double().numpy())
                     / np.linalg.norm(b64))
    if not true_rel <= 1e-5:
        raise AssertionError(f"bf16 poh cg true relative residual {true_rel:.3e} > 1e-5")
    t0 = time.perf_counter()
    warm = ct.solvers.cg(spd_bf, bp, tol=1e-6, maxiter=200, M=Mp)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    print(f"[poh-cg-bf16] the bf16 POH plan of the same system ({spd_bf.ntiles} tiles, "
          f"{spd_bf.vals.numel() * 2 / 1e6:.1f} MB of values), jacobi, b and x f32, tol 1e-6: "
          f"converged in {res.iterations} iterations (f32: {pcg32[0]}), warm "
          f"{t_warm / max(warm.iterations, 1) * 1e6:.0f} us per iteration (f32: "
          f"{pcg32[1]:.0f}; host clock); poh_spmv launches {launches_pcg_bf} = iterations + 1; "
          f"true relative residual vs the bf16-rounded matrix {true_rel:.2e} (f64 host, tol "
          f"1e-5); plan {t_sys:.1f} s", flush=True)
    del res, warm, spd64, spd64_bf, b64, spd, spd_sp, spd_bf, Mp, bp

    t_lap = _lap("poh-cg-bf16", t_lap)
    # -- 19. bf16 and f16 main paths at full width: the same matrices, half values
    bf, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    runs = {}  # label -> (launches, max abs error against the twin)

    def half_path(phase, label, kernel, call, twin, sp_ref, expect=1, twin_tol=None,
                  sp_tol=BF16_TOL):
        """Run one main path of the half value types with all counts at 0;
        hold it against its twin (normwise within ``twin_tol``, by default
        BF16_TOL for an f32 output and one ulp of the twin's f32 sums for a
        half output) and scipy f64 of the rounded inputs."""
        _reset()
        y = call()
        torch.cuda.synchronize()
        n = _launched(kernel, label)
        if n != expect:
            raise AssertionError(f"{label} launched {kernel} {n} times, not {expect}")
        others = {k: f.launches for k, f in _counters().items() if k != kernel and f.launches}
        if others:
            raise AssertionError(f"{label} also launched {others}")
        t = twin()
        if y.dtype == torch.float32 or twin_tol is not None:
            tol = twin_tol or BF16_TOL
            err = _relerr(y, t)
            _check(f"1M {label} kernel vs twin", err, tol)
            what = f"{err:.2e} (tol {tol:.0e})"
        else:
            what = f"{_check_half_out(f'1M {label} kernel vs twin', y, t):.2f} ulp of the " \
                   f"twin's f32 sums (bound 1)"
        ys = y if y.ndim == 1 else y[:, :sp_ref.shape[1]]
        err_sp = _relerr(ys, sp_ref)
        _check(f"1M {label} vs scipy f64 of the rounded inputs", err_sp, sp_tol)
        runs[label] = (n, float((y.float() - t.float()).abs().max()))
        print(f"[{phase}] {label}: y {y.dtype}; launches {kernel} {n}; vs twin {what}; vs "
              f"scipy f64 of the rounded inputs {err_sp:.2e} (tol {sp_tol:.0e})"
              + ("" if y.ndim == 1 else f" on {sp_ref.shape[1]} columns"), flush=True)

    def half_cg(phase, op, rhs, maxiter, s64, f32_run, kernel, what):
        """cg over a half operator (f32 Krylov vectors) with all counts at 0:
        one launch per application, the true residual of the rounded system
        (f64 host) within 1e-5, and for f16 the f32 solve's iterations
        within 2.  Returns (launches, the warm solve's us per iteration)."""
        _reset()
        res = ct.solvers.cg(op, op.to_padded(rhs), tol=1e-6, maxiter=maxiter)
        torch.cuda.synchronize()
        n = _launched(kernel, what)
        if not res.converged or n != res.iterations + 1:
            raise AssertionError(f"{what}: converged {res.converged} in {res.iterations} "
                                 f"iterations, {n} launches")
        if phase.endswith("f16") and abs(res.iterations - f32_run[0]) > 2:
            raise AssertionError(f"{what}: {res.iterations} iterations, the f32 solve "
                                 f"{f32_run[0]} (more than 2 apart)")
        r64 = rhs.cpu().double().numpy()
        true_rel = float(np.linalg.norm(r64 - s64 @ op.from_padded(res.x).cpu().double()
                                        .numpy()) / np.linalg.norm(r64))
        if not true_rel <= 1e-5:
            raise AssertionError(f"{what}: true relative residual {true_rel:.3e} > 1e-5")
        t0 = time.perf_counter()
        warm = ct.solvers.cg(op, op.to_padded(rhs), tol=1e-6, maxiter=maxiter)
        torch.cuda.synchronize()
        us = (time.perf_counter() - t0) / max(warm.iterations, 1) * 1e6
        print(f"[{phase}] {what}, x and b f32: converged in {res.iterations} iterations (f32: "
              f"{f32_run[0]}), warm {us:.0f} us per iteration (f32: {f32_run[1]:.0f}; host "
              f"clock); true relative residual vs the rounded matrix {true_rel:.2e} (f64 host, "
              f"tol 1e-5); launches {n} = iterations + 1", flush=True)
        return n

    x64 = x.cpu().double().numpy()
    xs64 = xs.cpu().double().numpy()
    half = {}  # h -> the plans, operands and launch counts the timing rows use
    for h in (bf, f16):
        ht = _short(h)
        hv = half[h] = {}
        # [spmv-H]: spmv(bsr_H, x) -> the cached H BDIA plan -> B1; f16 x too
        a_h = a.astype(h)  # its own matrix: its own (half) plan in the cache
        a_sp_h = hv["a_sp"] = _half_matrix(a_sp, h)
        _reset()
        t0 = time.perf_counter()
        y = ct.spmv(a_h, x)
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        hv["launches_spmv"] = _launched("bdia_spmv", f"spmv(bsr_{ht}, x)")
        plan_h = hv["plan"] = default_plan_cache.get(a_h)
        if hv["launches_spmv"] != 1 or plan_h.dtype != h or y.dtype != f32:
            raise AssertionError(f"spmv(bsr_{ht}, x): {hv['launches_spmv']} launches, plan "
                                 f"{plan_h.dtype}, y {y.dtype}")
        y_twin = plan_h._spmv_reference(x)
        err_twin = _relerr(y, y_twin)
        _check(f"1M {ht} spmv kernel vs twin", err_twin, BF16_TOL)
        hv["abs_spmv"] = float((y - y_twin).abs().max())
        err_sp = _relerr(y, torch.from_numpy(a_sp_h @ x64))
        _check(f"1M {ht} spmv kernel vs scipy f64 of the {ht} matrix", err_sp, BF16_TOL)
        err_f32 = _relerr(y, torch.from_numpy(a_sp.astype(np.float64) @ x64))
        print(f"[spmv-{ht}] spmv(bsr_{ht}, x f32): plan {plan_h.dtype} "
              f"{tuple(plan_h.vals.shape)}, {plan_h.vals.numel() * 2 / 1e6:.1f} MB of values; "
              f"first call (plan + launch) {t_first:.1f} s; launches bdia_spmv "
              f"{hv['launches_spmv']}; y {y.dtype}; vs twin {err_twin:.2e} (max abs "
              f"{hv['abs_spmv']:.2e}), vs scipy f64 of the {ht}-rounded matrix {err_sp:.2e} "
              f"(tol {BF16_TOL:.0e}); vs the f32 matrix {err_f32:.2e} (the values' {ht} "
              f"rounding)", flush=True)
        del y, y_twin
        if h == f16:  # f16 values and x: the reference's f16 y, rounded once
            x_h = hv["x"] = x.to(h)
            half_path(f"spmv-{ht}", f"spmv(bsr_{ht}, x {ht})", "bdia_spmv",
                      lambda: ct.spmv(a_h, x_h),
                      lambda: bdia_spmv_reference(plan_h.astype(f32), x_h.float()),
                      torch.from_numpy(a_sp_h @ x_h.cpu().double().numpy()), sp_tol=1e-3)

        # [cg-H]: cg(BdiaOperator(H plan), b f32) -> B2, f32 Krylov vectors
        t0 = time.perf_counter()
        op_h = hv["op"] = ct.BdiaOperator(ct.bdia_plan(s_bsr.to(dev).astype(h), device=dev))
        t_sys = time.perf_counter() - t0
        hv["launches_cg"] = half_cg(f"cg-{ht}", op_h, b, 200, _half_matrix(to_scipy(s_csr), h),
                                    cg32, "bdia_spmv", f"BdiaOperator of the {ht} plan of the "
                                    f"same system, mode {op_h.mode} (built in {t_sys:.1f} s)")
        y_op, y_op_twin = op_h(b), op_h.bdia._spmv_reference(b)
        _check(f"1M {ht} operator kernel vs twin", _relerr(y_op, y_op_twin), BF16_TOL)
        hv["abs_op"] = float((y_op - y_op_twin).abs().max())
        del y_op, y_op_twin

        # [dia-spmv-H]: spmv(csr_H, x) -> the cached H DIA plan -> B8; f16 x too
        st_h = st.astype(h)
        st_sp_h = _half_matrix(st_sp, h)
        _reset()
        t0 = time.perf_counter()
        ys = ct.spmv(st_h, xs)
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        hv["launches_dspmv"] = _launched("dia_spmv", f"spmv(csr_{ht}, x)")
        dplan_h = hv["dplan"] = default_plan_cache.get(st_h)
        if hv["launches_dspmv"] != 1 or dplan_h.dtype != h or ys.dtype != f32:
            raise AssertionError(f"spmv(csr_{ht}, x): {hv['launches_dspmv']} launches, plan "
                                 f"{dplan_h.dtype}, y {ys.dtype}")
        ys_twin = dplan_h._spmv_reference(xs)
        err_twin = _relerr(ys, ys_twin)
        _check(f"4M {ht} dia spmv kernel vs twin", err_twin, BF16_TOL)
        hv["abs_dspmv"] = float((ys - ys_twin).abs().max())
        err_sp = _relerr(ys, torch.from_numpy(st_sp_h @ xs64))
        _check(f"4M {ht} dia spmv vs scipy f64 of the {ht} matrix", err_sp, BF16_TOL)
        print(f"[dia-spmv-{ht}] spmv(csr_{ht}, x f32): plan {dplan_h.dtype} "
              f"{tuple(dplan_h.vals.shape)}; first call (plan + launch) {t_first:.1f} s; "
              f"launches dia_spmv {hv['launches_dspmv']}; vs twin {err_twin:.2e} (max abs "
              f"{hv['abs_dspmv']:.2e}), vs scipy f64 of the {ht}-rounded matrix {err_sp:.2e} "
              f"(tol {BF16_TOL:.0e})", flush=True)
        del ys, ys_twin
        if h == f16:
            xs_h = hv["xs"] = xs.to(h)
            half_path(f"dia-spmv-{ht}", f"spmv(csr_{ht}, x {ht})", "dia_spmv",
                      lambda: ct.spmv(st_h, xs_h),
                      lambda: dia_spmv_reference(dplan_h.astype(f32), xs_h.float()),
                      torch.from_numpy(st_sp_h @ xs_h.cpu().double().numpy()), sp_tol=1e-3)
        del st_sp_h

        # [dia-cg-H]: cg(solver_operator(csr_H), b) on I + stencil -> B9
        t0 = time.perf_counter()
        dop_h = hv["dop"] = ct.solver_operator(s_port.to(dev).astype(h))
        t_sys = time.perf_counter() - t0
        hv["launches_dcg"] = half_cg(f"dia-cg-{ht}", dop_h, bs, 500, _half_matrix(s_sp, h), dcg32,
                                     "dia_spmv", f"solver_operator of the {ht} CSR, mode "
                                     f"{dop_h.mode} (built in {t_sys:.1f} s)")
        yd_op, yd_twin = dop_h(bs), dop_h.dia._spmv_reference(bs)
        _check(f"4M {ht} operator kernel vs twin", _relerr(yd_op, yd_twin), BF16_TOL)
        hv["abs_dop"] = float((yd_op - yd_twin).abs().max())
        del yd_op, yd_twin

        # [spmm-H]: spmm(bsr_H, X) at k = 32 (scalar DIA, B14) and 128 (the half
        # slab, B6); the ring (B4) with f32 and H out; scalar DIA at k = 128
        # (B13) with f32 and H out.  H outs take H X: the fully-half chain.
        phase = f"spmm-{ht}"
        Xw_h = hv["Xw"] = Xw.to(h)
        Yw_sp_h = torch.from_numpy(a_sp_h @ Xw[:, :SCIPY_COLS].cpu().double().numpy())
        Yw_sp_chain = torch.from_numpy(a_sp_h @ Xw_h[:, :SCIPY_COLS].cpu().double().numpy())
        chain_tol = 2e-2 if h == bf else 1e-3  # the output's own rounding
        Xb64 = torch.from_numpy(a_sp_h @ Xb.cpu().double().numpy())
        half_path(phase, f"spmm(bsr_{ht}, X f32), k={K}", "dia_spmm",
                  lambda: ct.spmm(a_h, Xb), lambda: bdia_scalar_dia(plan_h)._spmm_reference(Xb),
                  Xb64)
        del Xb64
        splan_h = hv["splan"] = bdia_scalar_dia(plan_h)
        # the banded CSR at k = 32: its cached H DIA plan (B12)
        mm_h = mm.astype(h)
        half_path(phase, f"spmm(csr_{ht}, X f32), k={K}", "dia_spmm",
                  lambda: ct.spmm(mm_h, X),
                  lambda: default_plan_cache.get(mm_h)._spmm_reference(X),
                  torch.from_numpy(_half_matrix(mm_sp, h) @ X.cpu().double().numpy()))
        hv["mplan"] = default_plan_cache.get(mm_h)
        half_path(phase, f"spmm(bsr_{ht}, X f32), k={K_WIDE}: the {ht} slab",
                  "bdia_spmm_slab", lambda: ct.spmm(a_h, Xw),
                  lambda: bdia_spmm_slab_reference(default_plan_cache.get(plan_h, "slab"), Xw),
                  Yw_sp_h, twin_tol=BF16_SLAB_TOL)
        sl_h = hv["sl"] = default_plan_cache.get(plan_h, "slab")
        print(f"[{phase}] {ht} slab plan: g {sl_h.g}, W {sl_h.width}, "
              f"{sl_h.slabs.numel() * 2 / 1e6:.1f} MB (the f32 plan: g {sl.g}, "
              f"{sl.slabs.numel() * 4 / 1e6:.1f} MB); the BDIA plan's values "
              f"{plan_h.vals.numel() * 2 / 1e6:.1f} MB, the scalar-DIA plan's "
              f"{splan_h.vals.numel() * 2 / 1e6:.1f} MB", flush=True)
        half_path(phase, f"spmm(plan_{ht}, X f32, method='pallas_bdia'), k={K_WIDE}",
                  "bdia_spmm_ring", lambda: ct.spmm(plan_h, Xw, method="pallas_bdia"),
                  lambda: bdia_spmm_ring_reference(plan_h, Xw), Yw_sp_h)
        half_path(phase, f"spmm(plan_{ht}, X {ht}, method='pallas_bdia', accum_dtype={ht}), "
                  f"k={K_WIDE}", "bdia_spmm_ring",
                  lambda: ct.spmm(plan_h, Xw_h, method="pallas_bdia", accum_dtype=h),
                  lambda: bdia_spmm_ring_reference(plan_h, Xw_h, out_dtype=f32), Yw_sp_chain,
                  sp_tol=chain_tol)
        half_path(phase, f"spmm(scalar-DIA plan_{ht}, X f32), k={K_WIDE}", "dia_spmm",
                  lambda: ct.spmm(splan_h, Xw), lambda: splan_h._spmm_reference(Xw), Yw_sp_h)
        half_path(phase, f"dia_spmm(scalar-DIA plan_{ht}, X {ht}, out_dtype={ht}), "
                  f"k={K_WIDE}", "dia_spmm", lambda: dia_spmm(splan_h, Xw_h, out_dtype=h),
                  lambda: dia_spmm_reference(splan_h, Xw_h, out_dtype=f32), Yw_sp_chain,
                  sp_tol=chain_tol)
        del Yw_sp_h, Yw_sp_chain
        t_lap = _lap(ht, t_lap)
    del s_csr, s_bsr
    # -- 19b. half values of B7 and B16-B18 at full width: bf16 and f16 ---------
    # The power law's values rounded to bf16 and to f16, through poh_plan and
    # lell_plan_hyb of the half matrix; the FEM BSR's, through spmm(bsr_h, X,
    # method="pallas_bsr") at k = 128.  Operands in the half type and in f32.
    halves = (bf, f16)
    poh_h, hyb_h, bplan_h = {}, {}, {}
    for h in halves:
        ht = _short(h)
        t0 = time.perf_counter()
        pl_h = pl_host.to(dev).astype(h)
        poh_h[h] = ct.poh_plan(pl_h)
        hyb_h[h] = ct.lell_plan_hyb(pl_h)
        torch.cuda.synchronize()
        t_plan = time.perf_counter() - t0
        ph, hh = poh_h[h], hyb_h[h]
        if ph.dtype != h or hh.main.vals.dtype != h or hh.hub.vals.dtype != h:
            raise AssertionError(f"{ht} plans: POH {ph.dtype}, LELL {hh.main.vals.dtype} / "
                                 f"{hh.hub.vals.dtype}")
        print(f"[poh-spmv-half] poh_plan and lell_plan_hyb of the power law with {ht} values: "
              f"{t_plan:.1f} s; POH {ph.ntiles} tiles ({pplan.ntiles} in f32), "
              f"{ph.vals.numel() * 2 / 1e6:.1f} MB of values; LELL tiers "
              f"{tuple(hh.main.vals.shape)} / {tuple(hh.hub.vals.shape)}", flush=True)
        s_h = _half_matrix(pl_sp, h)
        for xdt in (h, torch.float32):
            xt = _short(xdt)
            x_in = xp.to(xdt)
            x64 = torch.from_numpy(s_h @ x_in.cpu().double().numpy())
            half_path("poh-spmv-half", f"spmv(poh_{ht}, x {xt})", "poh_spmv",
                      lambda: ct.spmv(ph, x_in), lambda: poh_spmv_reference(ph, x_in), x64)
            X_in = Xp.to(xdt)
            X64 = torch.from_numpy(s_h @ X_in[:, :SCIPY_COLS].cpu().double().numpy())
            half_path("poh-spmm-half", f"spmm(poh_{ht}, X {xt}), k={K}", "poh_spmm",
                      lambda: ct.spmm(ph, X_in), lambda: poh_spmm_reference(ph, X_in), X64)
            del X_in, X64
            f16_out = (h, xdt) == (f16, f16)  # the lane sums rounded, then a remainder too
            half_path("lell-half", f"lell_plan_hyb(A_{ht}).spmv(x {xt})", "lell_spmv",
                      lambda: hh.spmv(x_in), lambda: hh._spmv_reference(x_in), x64,
                      expect=3 if f16_out else 2, twin_tol=1e-3 if f16_out else None,
                      sp_tol=1e-3 if f16_out else BF16_TOL)
            if f16_out:  # summed in f32 and rounded once: one ulp of the f32 sums
                ulps = _check_half_out(f"1M lell {ht}/{xt} spmv", hh.spmv(x_in),
                                       _widened_lell(hh.main, hh.hub, x_in))
                print(f"[lell-half] spmv {ht}/{xt}: f16 y {ulps:.2f} ulp of the f32-summed "
                      f"twin (bound 1)", flush=True)
            worst = 0.0  # each tier's lane sums: one rounding of the twin's f32 sums
            for tier, g in ((hh.main, hh.main.groups), (hh.hub, 1)):
                y_t = lell_lane_sums(tier.vals, tier.idx, x_in, g)
                t32 = lell_lane_sums_reference(tier.vals.float(), tier.idx, x_in.float(), g)
                worst = max(worst, _check_half_out(f"1M lell {ht}/{xt} lane sums", y_t, t32)
                            if y_t.dtype != torch.float32 else _relerr(y_t, t32))
            print(f"[lell-half] lane sums of both tiers, {ht}/{xt}, kernel vs twin's f32 sums: "
                  f"{worst:.2e} {'ulp (f16 out)' if f16_out else '(f32 out, normwise)'}",
                  flush=True)
            del x64
    t_lap = _lap("poh-lell-half", t_lap)
    for h in halves:
        ht = _short(h)
        a_h = a.astype(h)
        bplan_h[h] = BsrSpmmKernel.plan(a_h, K_WIDE)
        bp_h = bplan_h[h]
        a_sp_h = _half_matrix(a_sp, h)
        for xdt in (h, torch.float32):
            xt = _short(xdt)
            X_in = Xw.to(xdt)
            X64 = torch.from_numpy(a_sp_h @ X_in[:, :SCIPY_COLS].cpu().double().numpy())
            half_path("spmm-wide-half", f"spmm(bsr_{ht}, X {xt}, method='pallas_bsr'), "
                      f"k={K_WIDE}", "bsr_spmm",
                      lambda: ct.spmm(a_h, X_in, method="pallas_bsr"),
                      lambda: bsr_spmm_reference(dataclasses.replace(
                          bp_h, vals=bp_h.vals.float()), X_in.float()),
                      X64, sp_tol=1e-2 if h == bf else 2e-3)
            del X_in, X64
        del a_h
    t_lap = _lap("spmm-wide-half", t_lap)
    # -- 19c-19f. the triangular solves, ILU(0) and its siblings, SpGEMM and add -
    tri_rows = trisolve_phase(dev, st_sp, rng)
    t_lap = _lap("trisolve", t_lap)
    ilu = ilu_cg_phase(dev, s_sp, card)
    t_lap = _lap("ilu-cg", t_lap)
    ilu_device_phase(dev, ilu.pop("S64"), ilu.pop("f64"))
    t_lap = _lap("ilu-device", t_lap)
    gem_rows, gem_extra = spgemm_phase(dev, rng, card)
    t_lap = _lap("spgemm", t_lap)
    # -- 19k-19o. the rest of the solver half ------------------------------------
    sol_rows = krylov_phase(dev, card, s_sp, dop, bs, dcg32[0], op, b, sb_sp)
    t_lap = _lap("krylov", t_lap)
    ir_phase(dev, card, s_sp)
    t_lap = _lap("ir", t_lap)
    sol_rows += amg_phase(dev, card, mm_host, mm_sp)
    t_lap = _lap("amg", t_lap)
    sol_rows += eig_phase(dev, card, mm, mm_sp, mplan)
    t_lap = _lap("eig", t_lap)
    sol_rows += lstsq_phase(dev, card)
    t_lap = _lap("lstsq", t_lap)
    # -- 19p-19q. the multi-device half ----------------------------------------
    spd_bsr = csr_to_bsr(from_scipy(sb_sp), (DOF, DOF))  # the FEM SPD system, partitioned
    ilu_one_block = dist_phase(dev, card, pl_host, pplan, op, b, sb_sp, spd_bsr, cg32[0])
    t_lap = _lap("dist", t_lap)
    b6_rows = dist_ranks_phase(dev, card, pl_host, pplan, op, b, sb_sp, spd_bsr, cg32[0],
                               ilu_one_block)
    t_lap = _lap("dist-ranks", t_lap)
    # -- 19r-19t. the device generators, bench_solve and a profile ----------------
    synth_rows = device_gen_phase(dev, card, plan, fem_host_s, dplan, sten_host_s)
    t_lap = _lap("device-gen", t_lap)
    bench_solve_phase(dev, card)
    t_lap = _lap("bench-solve", t_lap)
    profile_phase(dev, card, op, b)
    t_lap = _lap("profile", t_lap)
    # -- 19g-19j. the tuner, its calibration and the bench harness --------------
    with tempfile.TemporaryDirectory() as tmp:  # the tuner caches of this run
        tune_row = tune_phase(dev, card, rng, a, x, a_host, a_sp, st_host, st_sp, mm_host,
                              mm_sp, pl_host, pl_sp, tmp)
        t_lap = _lap("tune", t_lap)
        tune_medium_phase(dev, rng, tmp)
        t_lap = _lap("tune-medium", t_lap)
        calibrate_phase(dev, tmp)
        t_lap = _lap("calibrate", t_lap)
    bench_harness_phase(dev, a_host)
    t_lap = _lap("bench-harness", t_lap)
    # -- 20. timing: kernel vs plain twin vs library call, every entry ---------
    bw, bw_known = hbm_bandwidth()
    if not bw_known:
        bw = 3.35e12
        print(f"[timing] {kind} is not in the HBM table: bounds use the H100 SXM "
              f"3.35 TB/s", flush=True)
    entries = []
    n, m = a.shape[1], a.shape[0]
    xy_w = (n + m) * K_WIDE * 4  # X read once and Y written once at k = 128
    # Bytes and operations are those of the function, A·x or A·X, on the
    # matrix as the caller's format stores it (the BDIA plan of a BSR, the DIA
    # plan of a banded CSR, a POH or LELL plan), each value read once.  The
    # slab's shear and the scalar-DIA plan's zero-filled diagonals are packs
    # a route derives from the BDIA plan, its own traffic (their sizes are on
    # the [spmm], [spmm-wide] and [spmm-bf16] lines), so they count in no bound.
    rows = [
            ("bdia_spmv f32 [spmv(bsr, x)]", "bdia_spmv", f"{BDIA_PY}:290 (B1; also :409, B3)",
             lambda: bdia_spmv(plan, x), lambda: bdia_spmv_reference(plan, x), a_sp, x,
             (plan.vals.numel() + plan.shape[0] + plan.shape[1]) * 4, 2 * plan.vals.numel(),
             launches_spmv, abs_spmv),
            ("bdia_spmv f32 [BdiaOperator in cg]", "bdia_spmv", f"{BDIA_PY}:70 (B2)",
             lambda: bdia_spmv(op.bdia, b), lambda: bdia_spmv_reference(op.bdia, b),
             sb_sp, b,
             (op.bdia.vals.numel() + 2 * op.bdia.shape[0]) * 4, 2 * op.bdia.vals.numel(),
             launches_cg, abs_op),
            ("dia_spmv f32 [spmv(csr, x)]", "dia_spmv", f"{DIA_PY}:176 (B8)",
             lambda: dia_spmv(dplan, xs), lambda: dia_spmv_reference(dplan, xs), st_sp, xs,
             (dplan.vals.numel() + dplan.shape[0] + dplan.shape[1]) * 4,
             2 * dplan.vals.numel(), launches_dspmv, abs_dspmv),
            ("dia_spmv f32 [solver_operator in cg]", "dia_spmv",
             f"{DIA_PY}:336 (B9), :511 (B10), :650 (B11)",
             lambda: dia_spmv(dop.dia, bs), lambda: dia_spmv_reference(dop.dia, bs), s_sp, bs,
             (dop.dia.vals.numel() + 2 * dop.dia.shape[0]) * 4, 2 * dop.dia.vals.numel(),
             launches_dcg, abs_dop),
            (f"dia_spmm f32 [spmm(csr, X), k={K}]", "dia_spmm",
             f"{DIA_PY}:1148 (B14, k <= 64), :789 (B12)",
             lambda: dia_spmm(mplan, X), lambda: dia_spmm_reference(mplan, X), mm_sp, X,
             (mplan.vals.numel() + (mplan.shape[0] + mplan.shape[1]) * K) * 4,
             2 * mplan.vals.numel() * K, launches_mm_csr, abs_mm_csr),
            (f"dia_spmm f32 [spmm(csr, X), k={K_WIDE}]", "dia_spmm",
             f"{DIA_PY}:1023 (B13, k > 64)",
             lambda: dia_spmm(mplan, Xsw), lambda: dia_spmm_reference(mplan, Xsw), mm_sp, Xsw,
             (mplan.vals.numel() + (mplan.shape[0] + mplan.shape[1]) * K_WIDE) * 4,
             2 * mplan.vals.numel() * K_WIDE, launches_mm_csr_w, abs_mm_csr_w),
            (f"dia_spmm f32 [spmm(bsr, X), k={K}]", "dia_spmm",
             f"{DIA_PY}:1148 (B14, k <= 64)",
             lambda: dia_spmm(splan, Xb), lambda: dia_spmm_reference(splan, Xb), a_sp, Xb,
             (plan.vals.numel() + (m + n) * K) * 4, 2 * plan.vals.numel() * K,
             launches_mm_bsr, abs_mm_bsr),
            (f"bdia_spmm_slab f32 [spmm(bsr, X), k={K_WIDE}]", "bdia_slab_spmm",
             f"{SLAB_PY}:518 (B6; entries :505, :494), :290 (B5)",
             lambda: bdia_spmm_slab(sl, Xw), lambda: bdia_spmm_slab_reference(sl, Xw), a_sp, Xw,
             plan.vals.numel() * 4 + xy_w, 2 * plan.vals.numel() * K_WIDE, launches_slab,
             abs_slab),
            (f"bdia_spmm_ring f32 [spmm(plan, X, method='pallas_bdia'), k={K_WIDE}]", "bdia_spmm",
             f"{BDIA_PY}:607 (B4)", lambda: bdia_spmm_ring(plan, Xw),
             lambda: bdia_spmm_ring_reference(plan, Xw), a_sp, Xw,
             plan.vals.numel() * 4 + xy_w, 2 * plan.vals.numel() * K_WIDE, launches_ring,
             abs_ring),
            (f"bsr_spmm f32 [spmm(bsr, X, method='pallas_bsr'), k={K_WIDE}]", "bsr_spmm",
             f"{BSR_PY}:91 (B7)", lambda: bsr_spmm(bplan, Xw),
             lambda: bsr_spmm_reference(bplan, Xw), a_sp, Xw,
             (bplan.vals.numel() + bplan.cols.numel()) * 4 + xy_w,
             2 * bplan.vals.numel() * K_WIDE, launches_bsr, abs_bsr),
            (f"dia_spmm f32 [spmm(scalar-DIA plan, X), k={K_WIDE}]", "dia_spmm",
             f"{DIA_PY}:1023 (B13), :1314 (B15)", lambda: dia_spmm(splan, Xw),
             lambda: dia_spmm_reference(splan, Xw), a_sp, Xw,
             plan.vals.numel() * 4 + xy_w, 2 * plan.vals.numel() * K_WIDE, launches_dia_w,
             abs_dia_w),
            # the POH and LELL rows move their values once, every slot (a
            # value of 0 is what marks padding), and the int32 indices of the
            # live slots only (cloc + rloc for POH, idx for LELL), as padding
            # needs none; they count the function's operations, 2 per stored
            # entry and column
            ("poh_spmv f32 [spmv(poh, x)]", "poh_spmv", f"{POH_PY}:388 (B16)",
             lambda: poh_spmv(pplan, xp), lambda: poh_spmv_reference(pplan, xp), pl_sp, xp,
             _pack_bytes(pplan.vals, 8) + pplan.ntiles * 4 + 2 * PL_N * 4, 2 * pl_sp.nnz,
             launches_poh, abs_poh),
            (f"poh_spmm f32 [spmm(poh, X), k={K}]", "poh_spmm", f"{POH_PY}:538 (B17)",
             lambda: poh_spmm(pplan, Xp), lambda: poh_spmm_reference(pplan, Xp), pl_sp, Xp,
             _pack_bytes(pplan.vals, 8) + pplan.ntiles * 4 + 2 * PL_N * K * 4,
             2 * pl_sp.nnz * K, launches_pohmm, abs_pohmm),
            ("lell_spmv f32 [HybLell.spmv: 2 launches, the hub tier and remainder by atomics]",
             "lell_spmv",
             f"{LELL_PY}:377 (B18; also :365)", lambda: hyb.spmv(xp),
             lambda: hyb._spmv_reference(xp), pl_sp, xp,
             _pack_bytes(hyb.main.vals, 4) + hyb.main.rem_data.numel() * 12
             + _pack_bytes(hyb.hub.vals, 4) + hyb.hub.slot2row.numel() * 4 + 2 * PL_N * 4,
             2 * pl_sp.nnz,
             launches_lell, abs_lell)]
    rows = [r + (torch.float32,) for r in rows]  # the library call in f32
    xy_h = (n + m) * K_WIDE * 2  # half X read once and half Y written once
    # the half rows of the block and banded kernels (bytes at the values' and
    # operands' widths; the library call in the values' half type)
    for h in (bf, f16):
        ht, hv = _short(h), half[h]
        ph, oph, dph, doph, sph, slh, Xwh = (hv[k] for k in ("plan", "op", "dplan", "dop",
                                                             "splan", "sl", "Xw"))
        rows += [
            (f"bdia_spmv {ht} [spmv(bsr_{ht}, x f32)]", "bdia_spmv",
             f"{BDIA_PY}:290 (B1; also :409, B3)", lambda ph=ph: bdia_spmv(ph, x),
             lambda ph=ph: bdia_spmv_reference(ph, x), a_sp, x,
             ph.vals.numel() * 2 + (m + n) * 4, 2 * ph.vals.numel(), hv["launches_spmv"],
             hv["abs_spmv"], h),
            (f"bdia_spmv {ht} [BdiaOperator({ht} plan) in cg]", "bdia_spmv",
             f"{BDIA_PY}:70 (B2)", lambda oph=oph: bdia_spmv(oph.bdia, b),
             lambda oph=oph: bdia_spmv_reference(oph.bdia, b), sb_sp, b,
             oph.bdia.vals.numel() * 2 + 2 * oph.bdia.shape[0] * 4,
             2 * oph.bdia.vals.numel(), hv["launches_cg"], hv["abs_op"], h),
            (f"dia_spmv {ht} [spmv(csr_{ht}, x f32)]", "dia_spmv", f"{DIA_PY}:176 (B8)",
             lambda dph=dph: dia_spmv(dph, xs), lambda dph=dph: dia_spmv_reference(dph, xs),
             st_sp, xs, dph.vals.numel() * 2 + (dph.shape[0] + dph.shape[1]) * 4,
             2 * dph.vals.numel(), hv["launches_dspmv"], hv["abs_dspmv"], h),
            (f"dia_spmv {ht} [solver_operator(csr_{ht}) in cg]", "dia_spmv",
             f"{DIA_PY}:336 (B9), :511 (B10), :650 (B11)",
             lambda doph=doph: dia_spmv(doph.dia, bs),
             lambda doph=doph: dia_spmv_reference(doph.dia, bs), s_sp, bs,
             doph.dia.vals.numel() * 2 + 2 * doph.dia.shape[0] * 4,
             2 * doph.dia.vals.numel(), hv["launches_dcg"], hv["abs_dop"], h),
            (f"dia_spmm {ht} [spmm(csr_{ht}, X f32), k={K}]", "dia_spmm",
             f"{DIA_PY}:1148 (B14, k <= 64), :789 (B12)",
             lambda mph=hv["mplan"]: dia_spmm(mph, X),
             lambda mph=hv["mplan"]: dia_spmm_reference(mph, X), mm_sp, X,
             hv["mplan"].vals.numel() * 2 + (hv["mplan"].shape[0] + hv["mplan"].shape[1]) * K * 4,
             2 * hv["mplan"].vals.numel() * K, *runs[f"spmm(csr_{ht}, X f32), k={K}"], h),
            (f"dia_spmm {ht} [spmm(bsr_{ht}, X f32), k={K}]", "dia_spmm",
             f"{DIA_PY}:1148 (B14, k <= 64)", lambda sph=sph: dia_spmm(sph, Xb),
             lambda sph=sph: dia_spmm_reference(sph, Xb), a_sp, Xb,
             ph.vals.numel() * 2 + (m + n) * K * 4, 2 * ph.vals.numel() * K,
             *runs[f"spmm(bsr_{ht}, X f32), k={K}"], h),
            (f"bdia_spmm_slab {ht} [spmm(bsr_{ht}, X f32), k={K_WIDE}: two TF32 passes]",
             "bdia_slab_spmm", f"{SLAB_PY}:518 (B6; entries :505, :494), :290 (B5)",
             lambda slh=slh: bdia_spmm_slab(slh, Xw),
             lambda slh=slh: bdia_spmm_slab_reference(slh, Xw), a_sp, Xw,
             ph.vals.numel() * 2 + xy_w, 2 * ph.vals.numel() * K_WIDE,
             *runs[f"spmm(bsr_{ht}, X f32), k={K_WIDE}: the {ht} slab"], h),
            (f"bdia_spmm_ring {ht} [spmm(plan_{ht}, X f32, method='pallas_bdia'), "
             f"k={K_WIDE}]", "bdia_spmm", f"{BDIA_PY}:607 (B4)",
             lambda ph=ph: bdia_spmm_ring(ph, Xw),
             lambda ph=ph: bdia_spmm_ring_reference(ph, Xw), a_sp, Xw,
             ph.vals.numel() * 2 + xy_w, 2 * ph.vals.numel() * K_WIDE,
             *runs[f"spmm(plan_{ht}, X f32, method='pallas_bdia'), k={K_WIDE}"], h),
            (f"bdia_spmm_ring {ht} [X and Y {ht}: accum_dtype={ht}], k={K_WIDE}", "bdia_spmm",
             f"{BDIA_PY}:607 (B4)", lambda ph=ph, X=Xwh, h=h: bdia_spmm_ring(ph, X, out_dtype=h),
             lambda ph=ph, X=Xwh, h=h: bdia_spmm_ring_reference(ph, X, out_dtype=h), a_sp,
             Xwh, ph.vals.numel() * 2 + xy_h, 2 * ph.vals.numel() * K_WIDE,
             *runs[f"spmm(plan_{ht}, X {ht}, method='pallas_bdia', accum_dtype={ht}), "
                   f"k={K_WIDE}"], h),
            (f"dia_spmm {ht} [spmm(scalar-DIA plan_{ht}, X f32), k={K_WIDE}]", "dia_spmm",
             f"{DIA_PY}:1023 (B13), :1314 (B15)", lambda sph=sph: dia_spmm(sph, Xw),
             lambda sph=sph: dia_spmm_reference(sph, Xw), a_sp, Xw,
             ph.vals.numel() * 2 + xy_w, 2 * ph.vals.numel() * K_WIDE,
             *runs[f"spmm(scalar-DIA plan_{ht}, X f32), k={K_WIDE}"], h),
            (f"dia_spmm {ht} [X and Y {ht}: out_dtype={ht}], k={K_WIDE}", "dia_spmm",
             f"{DIA_PY}:1023 (B13), :1314 (B15)",
             lambda sph=sph, X=Xwh, h=h: dia_spmm(sph, X, out_dtype=h),
             lambda sph=sph, X=Xwh, h=h: dia_spmm_reference(sph, X, out_dtype=h), a_sp, Xwh,
             ph.vals.numel() * 2 + xy_h, 2 * ph.vals.numel() * K_WIDE,
             *runs[f"dia_spmm(scalar-DIA plan_{ht}, X {ht}, out_dtype={ht}), k={K_WIDE}"], h),
        ]
    # the f16 slice's own rows: f16 values and x (f16 y; the bf16 phases run
    # neither)
    hv = half[f16]
    p16, dp16, x16, xs16 = hv["plan"], hv["dplan"], hv["x"], hv["xs"]
    rows += [
        ("bdia_spmv f16 [spmv(bsr_f16, x f16): f16 y]", "bdia_spmv",
         f"{BDIA_PY}:290 (B1; also :409, B3)", lambda: bdia_spmv(p16, x16),
         lambda: bdia_spmv_reference(p16, x16), a_sp, x16, (p16.vals.numel() + m + n) * 2,
         2 * p16.vals.numel(), *runs["spmv(bsr_f16, x f16)"], f16),
        ("dia_spmv f16 [spmv(csr_f16, x f16): f16 y]", "dia_spmv", f"{DIA_PY}:176 (B8)",
         lambda: dia_spmv(dp16, xs16), lambda: dia_spmv_reference(dp16, xs16), st_sp, xs16,
         (dp16.vals.numel() + dp16.shape[0] + dp16.shape[1]) * 2, 2 * dp16.vals.numel(),
         *runs["spmv(csr_f16, x f16)"], f16),
    ]
    n_block_half = len(rows)
    # the half rows of B7 and B16-B18 (bytes at the values' and operands' widths)
    for h in halves:
        ht, ph, hh, bq = _short(h), poh_h[h], hyb_h[h], bplan_h[h]
        for xdt in (h, torch.float32):
            xt, xb = _short(xdt), torch.finfo(xdt).bits // 8
            x_in, X_in, Xw_in = xp.to(xdt), Xp.to(xdt), Xw.to(xdt)
            y_out = 2 if (h, xdt) == (f16, f16) else 4  # LELL's output width
            rows += [
                (f"poh_spmv {ht} [spmv(poh_{ht}, x {xt})]", "poh_spmv", f"{POH_PY}:388 (B16)",
                 lambda ph=ph, x=x_in: poh_spmv(ph, x),
                 lambda ph=ph, x=x_in: poh_spmv_reference(ph, x), pl_sp, x_in,
                 _pack_bytes(ph.vals, 8) + ph.ntiles * 4 + PL_N * (xb + 4), 2 * pl_sp.nnz,
                 *runs[f"spmv(poh_{ht}, x {xt})"], h),
                (f"poh_spmm {ht} [spmm(poh_{ht}, X {xt}), k={K}]", "poh_spmm",
                 f"{POH_PY}:538 (B17)", lambda ph=ph, X=X_in: poh_spmm(ph, X),
                 lambda ph=ph, X=X_in: poh_spmm_reference(ph, X), pl_sp, X_in,
                 _pack_bytes(ph.vals, 8) + ph.ntiles * 4 + PL_N * K * (xb + 4),
                 2 * pl_sp.nnz * K, *runs[f"spmm(poh_{ht}, X {xt}), k={K}"], h),
                (f"lell_spmv {ht} [lell_plan_hyb(A_{ht}).spmv(x {xt}): {2 + (y_out == 2)} "
                 f"launches]", "lell_spmv", f"{LELL_PY}:377 (B18; also :365)",
                 lambda hh=hh, x=x_in: hh.spmv(x), lambda hh=hh, x=x_in: hh._spmv_reference(x),
                 pl_sp, x_in,
                 _pack_bytes(hh.main.vals, 4) + hh.main.rem_data.numel() * 10
                 + _pack_bytes(hh.hub.vals, 4) + hh.hub.slot2row.numel() * 4
                 + PL_N * (xb + y_out), 2 * pl_sp.nnz,
                 *runs[f"lell_plan_hyb(A_{ht}).spmv(x {xt})"], h),
                (f"bsr_spmm {ht} [spmm(bsr_{ht}, X {xt}, method='pallas_bsr'), k={K_WIDE}]",
                 "bsr_spmm", f"{BSR_PY}:91 (B7)", lambda bq=bq, X=Xw_in: bsr_spmm(bq, X),
                 lambda bq=bq, X=Xw_in: bsr_spmm_reference(bq, X), a_sp, Xw_in,
                 bq.vals.numel() * 2 + bq.cols.numel() * 4 + n * K_WIDE * xb
                 + m * K_WIDE * 2, 2 * bq.vals.numel() * K_WIDE,
                 *runs[f"spmm(bsr_{ht}, X {xt}, method='pallas_bsr'), k={K_WIDE}"], h)]
    rows += tri_rows + ilu["rows"] + gem_rows + sol_rows + [tune_row]  # the slices' entries (f32)
    rows += b6_rows + synth_rows
    lib_mats = {}  # (id of the scipy matrix, dtype) -> its torch sparse CSR on the card

    def lib_csr(s, dtype):
        if isinstance(s, torch.Tensor):  # a CSR built on the card already
            return s.to(dtype)
        key = (id(s), dtype)
        if key not in lib_mats:
            lib_mats[key] = _sparse_csr(s, dev, dtype)
        return lib_mats[key]

    for i, (name, source, replaces, kernel, plain, lib_op, operand, nbytes, flops, launches,
            max_abs, lib_dt) in enumerate(rows):
        if lib_dt != torch.float32:  # half values: the library in their type, if torch takes it
            S = lib_csr(lib_op, lib_dt)
            v = operand.to(lib_dt)
            lt = str(lib_dt)[6:]
            try:
                y_lib = S @ v
                torch.cuda.synchronize()
            except (RuntimeError, NotImplementedError) as e:  # a refusal: no number
                library, lib_what = None, (f"library (torch.sparse_csr_tensor {lt} @ {lt}) "
                                           f"refused: {str(e).splitlines()[0][:200]}")
            else:
                library = lambda S=S, v=v: S @ v  # noqa: E731
                # a yardstick that computes the same function: its own half
                # rounding (its bf16 SpMM at k = 32 on the power law's hub rows
                # is 2.3e-2 from the f32-summed kernel on an H100), so the
                # rows of B7 and B16-B18 hold it to 1e-1
                lib_err = _relerr(y_lib, kernel())
                lib_what = (f"library (torch.sparse_csr_tensor {lt} @ {lt} -> {y_lib.dtype}, "
                            f"{lib_err:.1e} from the kernel)")
                _check(f"{name} library call vs kernel", lib_err,
                       2e-2 if i < n_block_half else 1e-1)
                del y_lib
        else:
            S = lib_csr(lib_op, torch.float32)
            library = lambda S=S, v=operand: S @ v  # noqa: E731
            lib_what = "library (torch.sparse_csr_tensor @, cuSPARSE)"
            _check(f"{name} library call vs kernel", _relerr(library(), kernel()), F32_TOL)
        # the k = 128 entries take milliseconds a call (their twins tens): fewer samples
        nr, reps = (10, 3) if operand.shape in (Xw.shape, Xp.shape) else (20, 10)
        fns = (plain, kernel, library, library, kernel, plain) if library else \
            (plain, kernel, kernel, plain)
        # the plain twin, host-launch bound and only a reference, takes 3 samples a side
        runs = [time_cuda(f, warmup=1, runs=3, reps=reps) if f is plain
                else time_cuda(f, warmup=3, runs=nr, reps=reps) for f in fns]
        ms = float(np.median(runs[1].samples_ms + runs[-2].samples_ms))
        plain_ms = float(np.median(runs[0].samples_ms + runs[-1].samples_ms))
        library_ms = float(np.median(runs[2].samples_ms + runs[3].samples_ms)) if library \
            else None
        t_bytes, t_ops = nbytes / bw, flops / F32_PEAK
        bound_ms = max(t_bytes, t_ops) * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        gbs = nbytes / (ms * 1e-3) / 1e9
        lib_time = f"{library_ms * 1e3:.1f} us" if library else "no number"
        before = BEFORE_WINDOW_US.get(name)
        earlier = "" if source not in ("dia_spmm", "bdia_spmm") else \
            f" (before the window: {before} us, PERF.md §6)" if before else \
            " (no time recorded before the window)"
        if name in BEFORE_REDESIGN_US:
            earlier = f" (before the redesign: {BEFORE_REDESIGN_US[name]} us, PERF.md §6)"
        print(f"[timing] {name}: kernel {ms * 1e3:.1f} us{earlier}, plain twin "
              f"{plain_ms * 1e3:.1f} us, "
              f"{lib_what} {lib_time}; "
              f"{nbytes / 1e6:.1f} MB moved -> {gbs:.0f} GB/s, HBM fraction "
              f"{gbs * 1e9 / bw:.3f} of {bw / 1e12:.2f} TB/s; bound {bound_ms * 1e3:.1f} us "
              f"({bound_by}: {flops / 1e9:.2f} GFLOP); card {card}; median of 2x{nr} samples "
              f"of {reps} calls, the twin 2x3 (CUDA events)", flush=True)
        entries.append({"name": name, "route": "cuda",
                        "source": f"cask_tpu_torch/csrc/{source}.cu", "replaces": replaces,
                        "launches": launches, "max_abs_err": max_abs, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": library_ms})

    # the slice's paths that are no kernel of their own, beside the one PyTorch
    # call that computes the same function where there is one
    for name, fn, lib in ilu["extra"] + gem_extra:
        lib_what, library = lib or ("no single PyTorch call computes it", None)
        fns = (fn, library, library, fn) if library else (fn, fn)
        runs = [time_cuda(f, warmup=1, runs=3, reps=1) for f in fns]
        ms = float(np.median(runs[0].samples_ms + runs[-1].samples_ms))
        lib_time = (f"{float(np.median(runs[1].samples_ms + runs[2].samples_ms)) * 1e3:.1f} us"
                    if library else "")
        print(f"[timing] {name}: {ms * 1e3:.1f} us; {lib_what} {lib_time}; card {card}; median "
              f"of 2x3 samples of 1 call (CUDA events)", flush=True)

    _lap("timing", t_lap)
    print(f"[done] {time.perf_counter() - t_start:.1f} s (host clock, by phase: "
          + ", ".join(f"{k} {v:.1f}" for k, v in _LAPS.items()) + ")", flush=True)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
