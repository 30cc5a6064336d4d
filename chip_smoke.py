#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one GPU and check them.

    python3 chip_smoke.py

The quickest proof that ``cask_tpu_torch`` still builds and runs on the
card.  Phases, one line each:

1. device — the card's name and power limit; TF32 off.
2. build — ``nvcc`` builds every kernel from ``cask_tpu_torch/csrc``, one
   compiler per source, all at once; the ptxas register and spill lines.
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
   f64, k ∈ {1, 65, 128}.
6. small-poh — the POH SpMV and SpMM kernels against their twins and scipy
   on the edge plans of the JAX package's POH tests (power law, both
   rectangles, a band, one dense column, empty rows and columns, the
   all-zero matrix, n below the window, other panel, window and tile
   sizes, and ``graph_pattern_120.mtx`` through ``read_mtx``): ``spmv``,
   ``transposed`` and ``spmm`` at k ∈ {1, 32, 150}, f32 and f64.
7. small-lell — the LELL kernel against its twin and scipy: ``lell_plan``
   at groups ∈ {1, 4, 8, 16} and ``lell_plan_hyb`` on a uniform matrix, a
   power law, a rectangle and a plan wider than the reference's 4096·B cap.
8. spmv — ``spmv(bsr, x)`` through the public entry point on the
   1,048,576-row dof-4 FEM matrix (f32).
9. cg — ``cg(BdiaOperator(...), b)`` on an SPD block system of that size.
10. block-cg — ``block_cg`` over that system's BDIA plan with 128 right-hand
   sides and Jacobi: the slab kernel once per iteration.
11. dia-spmv — ``spmv(csr, x)`` on the 4,194,304-row 5-point stencil (f32).
12. dia-cg — ``cg(solver_operator(S), b)`` with S = I + that stencil.
13. spmm — ``spmm(csr, X)`` on the 1,048,576-row stencil and ``spmm(bsr, X)``
   on the FEM matrix, k = 32 (f32).
14. spmm-wide — the FEM matrix at k = 128: ``spmm(bsr, X)`` (the slab
   kernel), ``spmm(plan, X, method="pallas_bdia")`` (the ring),
   ``spmm(bsr, X, method="pallas_bsr")`` and ``spmm`` of the scalar-DIA
   plan (the DIA SpMM kernel, the route ``spmm(bsr, X)`` took before the
   slab).
15. poh-spmv — ``spmv(poh_plan(A), x)`` on ``power_law(1_000_000,
   avg_degree=12)`` (f32): the unstructured path, one ``poh_spmv`` launch.
16. poh-spmm — ``spmm(plan, X)`` on the same plan at k = 32.
17. lell — ``lell_plan_hyb(A).spmv(x)``: the LELL kernel on the grouped and
   the hub tier.
18. poh-cg — CG with Jacobi over the POH plan of the SPD ``A + Aᵀ`` with a
   shifted diagonal: one ``poh_spmv`` launch per operator application.
19. timing — each kernel entry, its plain twin and the one PyTorch call
   that computes the same product (a cuSPARSE product through
   ``torch.sparse_csr_tensor``), with CUDA events, beside the entry's bound.

The host-side power law (generated once, shared by phases 15-18) and its
plans add about a minute of host time.  Every main path (phases 8-18)
runs with all launch counts set to 0 just before it and read just after,
and must launch its kernel; its result must match the twin and scipy
(f64, host).  It needs one CUDA device and exits
non-zero without one; any failed check raises.  The last two lines are
JSON: the kernels that ran (launches, errors and times measured in this
run), then the device.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
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
SCIPY_COLS = 8  # columns of a k = 128 product also held against scipy f64 on the host
SEED = 0
F32_TOL = 1e-5  # normwise relative; f32 sums of a few dozen products, same order
F64_TOL = 1e-12  # same products in the same order as the twin
F32_PEAK = 67e12  # FLOP/s, FP32 outside the tensor cores, H100 SXM (NVIDIA data sheet)
KERNELS = ("bdia_spmv", "dia_spmv", "dia_spmm", "bdia_slab_spmm", "bdia_spmm", "bsr_spmm",
           "poh_spmv", "poh_spmm", "lell_spmv")
BDIA_PY = "cask_tpu/ops/pallas/bdia_kernels.py"
DIA_PY = "cask_tpu/ops/pallas/dia_kernels.py"
SLAB_PY = "cask_tpu/ops/pallas/bdia_slab.py"
BSR_PY = "cask_tpu/ops/pallas/bsr_kernels.py"
POH_PY = "cask_tpu/ops/pallas/poh_kernels.py"
LELL_PY = "cask_tpu/ops/pallas/lell_kernels.py"


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
    from cask_tpu_torch.ops.kernels.lell_kernels import lell_lane_sums
    from cask_tpu_torch.ops.kernels.poh_kernels import poh_spmm, poh_spmv

    return {"bdia_spmv": bdia_spmv, "dia_spmv": dia_spmv, "dia_spmm": dia_spmm,
            "bdia_spmm_slab": bdia_spmm_slab, "bdia_spmm_slab_padded": bdia_spmm_slab_padded,
            "bdia_spmm_ring": bdia_spmm_ring, "bsr_spmm": bsr_spmm, "poh_spmv": poh_spmv,
            "poh_spmm": poh_spmm, "lell_spmv": lell_lane_sums}


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
    }


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
    }


def _relerr_or_zero(y, ref) -> float:
    """:func:`_relerr`, or the norm of ``y`` where the reference is all zero."""
    if float(ref.double().norm()) == 0.0:
        return float(y.double().norm())
    return _relerr(y, ref)


def _sparse_csr(s, dev):
    """The scipy CSR matrix as a torch sparse CSR tensor on ``dev``: the
    library call's operand (cuSPARSE), timed beside the kernels only."""
    import numpy as np
    import torch

    return torch.sparse_csr_tensor(torch.from_numpy(s.indptr.astype(np.int32)),
                                   torch.from_numpy(s.indices.astype(np.int32)),
                                   torch.from_numpy(s.data), size=s.shape).to(dev)


def _pack_bytes(vals, index_bytes: int) -> int:
    """Bytes a slot pack's product must read: every slot's value (0 marks
    padding) and ``index_bytes`` of indices for each live slot only."""
    import torch

    return vals.numel() * vals.element_size() + int(torch.count_nonzero(vals)) * index_bytes


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check runs on a GPU",
              file=sys.stderr)
        return 1

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
    dev = default_device()
    kind = torch.cuda.get_device_name(0)
    card = _card()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {kind}; torch {torch.__version__} cuda {torch.version.cuda}; "
          f"TF32 off (matmul and cudnn); name and power limit:", flush=True)
    print(card, flush=True)

    # -- 2. build: one nvcc per source, all started together ---------------
    t0 = time.perf_counter()
    libs = build.build_all(KERNELS)
    t_build = time.perf_counter() - t0
    for name, lib in libs.items():
        log = lib.with_suffix(".log").read_text()
        regs = re.findall(r"Used (\d+) registers", log)
        spills = sum(int(v) for v in re.findall(r"(\d+) bytes spill (?:stores|loads)", log))
        print(f"[build] {name}.cu ({t_build:.1f} s for all {len(libs)}, built together); "
              f"ptxas: {len(regs)} kernels, registers {'/'.join(regs)}, spill bytes {spills}",
              flush=True)

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


    # -- 6. POH kernels vs plain twins and scipy, small ------------------------
    worst = {np.float32: 0.0, np.float64: 0.0}
    worst_sp = {np.float32: 0.0, np.float64: 0.0}
    n_checks, tiles = 0, 0
    for name, (s64, kw) in _poh_cases().items():
        for dt in (np.float32, np.float64):
            s = s64.astype(dt)
            pplan = ct.poh_plan(from_scipy(s), device=dev, **kw)
            pt = ct.transposed(pplan)
            tiles += pplan.ntiles
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
    print(f"[small-poh] {n_checks} products ({len(_poh_cases())} plans, {tiles} tiles in all, "
          f"x f32/f64 x spmv, transposed spmv, spmm k in 1/32/150): kernel vs twin worst "
          f"{worst[np.float32]:.2e} f32, {worst[np.float64]:.2e} f64; vs scipy f64 worst "
          f"{worst_sp[np.float32]:.2e} f32 (tol {F32_TOL:.0e}), {worst_sp[np.float64]:.2e} "
          f"f64 (tol {F64_TOL:.0e})", flush=True)

    # -- 7. LELL kernel vs plain twin and scipy, small -------------------------
    worst = {np.float32: 0.0, np.float64: 0.0}
    n_checks = 0
    for name, s64 in _lell_cases().items():
        for dt in (np.float32, np.float64):
            s = s64.astype(dt)
            tol = F32_TOL if dt == np.float32 else F64_TOL
            x = torch.from_numpy(rng.standard_normal(s.shape[1]).astype(dt)).to(dev)
            y_sp = torch.from_numpy(s.astype(np.float64) @ x.cpu().double().numpy())
            plans = [(f"groups={g}", ct.lell_plan(from_scipy(s), groups=g, device=dev))
                     for g in (1, 4, 8, 16)]
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
                _check(f"{name} {dt.__name__} {what} spmv vs scipy f64", _relerr(y, y_sp), tol)
                n_checks += 1
    print(f"[small-lell] {n_checks} products ({len(_lell_cases())} matrices x f32/f64 x "
          f"lell_plan groups 1/4/8/16 and lell_plan_hyb; the 500x70000 one past the "
          f"reference's 4096*B cap): kernel vs twin worst {worst[np.float32]:.2e} f32, "
          f"{worst[np.float64]:.2e} f64; spmv vs scipy f64 within {F32_TOL:.0e} / "
          f"{F64_TOL:.0e}", flush=True)

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
    y_op, y_op_twin = op(b), op.bdia._spmv_reference(b)  # counts were read above
    _check("1M operator kernel vs twin", _relerr(y_op, y_op_twin), F32_TOL)
    abs_op = float((y_op - y_op_twin).abs().max())
    sb_sp = to_scipy(s_csr)  # the operator's matrix, for the library call
    del res, warm

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
    del s_csr, s_bsr, s64, res, warm, B, B64, M

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

    # -- 12. main path: cg(solver_operator(S), b), S = I + stencil --------------
    t0 = time.perf_counter()
    s_sp = (sp.identity(st_sp.shape[0], dtype=np.float32, format="csr") + st_sp).tocsr()
    dop = ct.solver_operator(from_scipy(s_sp))
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
    yd_op, yd_twin = dop(bs), dop.dia._spmv_reference(bs)
    _check("4M operator kernel vs twin", _relerr(yd_op, yd_twin), F32_TOL)
    abs_dop = float((yd_op - yd_twin).abs().max())
    del res, warm, x64, b64

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
          f"(offsets {splan.offsets}), remainder {splan.rem_data.shape[0]}; first call (BDIA "
          f"plan cached, scalar-DIA plan + launch) {t_first:.1f} s; launches "
          f"{launches_mm_bsr}; vs twin {err_twin:.2e} (max abs {abs_mm_bsr:.2e}), vs scipy "
          f"f64 {err_sp:.2e} (tol {F32_TOL:.0e})", flush=True)
    del Y, Y_twin, Yb, Yb_twin

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

    # -- 16. main path: spmm(poh, X) at k = 32 ---------------------------------
    Xp = torch.randn((PL_N, K), generator=gen, device=dev, dtype=torch.float32)
    _reset()
    Yp = ct.spmm(pplan, Xp)
    torch.cuda.synchronize()
    launches_pohmm = _launched("poh_spmm", f"spmm(poh, X) at k={K}")
    Yp_twin = poh_spmm_reference(pplan, Xp)
    err_twin = _relerr(Yp, Yp_twin)
    _check("1M poh spmm kernel vs twin", err_twin, F32_TOL)
    abs_pohmm = float((Yp - Yp_twin).abs().max())
    del Yp_twin
    err_sp = _relerr(Yp[:, :SCIPY_COLS], torch.from_numpy(
        pl_sp.astype(np.float64) @ Xp[:, :SCIPY_COLS].cpu().double().numpy()))
    _check("1M poh spmm kernel vs scipy f64", err_sp, F32_TOL)
    print(f"[poh-spmm] spmm(poh, X), k {K} (torch.Generator on the card): launches "
          f"{launches_pohmm}; vs twin {err_twin:.2e} (max abs {abs_pohmm:.2e}), vs scipy f64 "
          f"{err_sp:.2e} on {SCIPY_COLS} columns (tol {F32_TOL:.0e})", flush=True)
    del Yp

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
        raise AssertionError(f"HybLell.spmv launched the LELL kernel {launches_lell} times, "
                             f"not 2 (grouped and hub tiers)")
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

    # -- 18. main path: CG with Jacobi over the POH plan of an SPD system -------
    t0 = time.perf_counter()
    spd = _diag_shift(from_scipy((pl_sp + pl_sp.T).tocsr()), 1.1)
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
    spd64 = to_scipy(spd).astype(np.float64)
    b64 = bp.cpu().double().numpy()
    true_rel = float(np.linalg.norm(b64 - spd64 @ res.x.cpu().double().numpy())
                     / np.linalg.norm(b64))
    if not true_rel <= 1e-6:
        raise AssertionError(f"poh cg true relative residual {true_rel:.3e} > 1e-6")
    t0 = time.perf_counter()
    warm = ct.solvers.cg(spd_plan, bp, tol=1e-6, maxiter=200, M=Mp)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t0
    print(f"[poh-cg] _diag_shift(A + A^T, 1.1): {spd.shape[0]} rows, nnz {spd.nnz}, "
          f"{spd_plan.ntiles} tiles; jacobi, tol 1e-6: converged in {res.iterations} "
          f"iterations, first solve {t_cg * 1e3:.1f} ms, warm solve {t_warm * 1e3:.2f} ms = "
          f"{t_warm / max(warm.iterations, 1) * 1e3:.3f} ms per iteration (host clock, one "
          f"host sync per iteration); poh_spmv launches {launches_pcg} = iterations + 1; true "
          f"relative residual {true_rel:.2e} (f64 host, tol 1e-6); system build and plan "
          f"{t_sys:.1f} s", flush=True)
    del res, warm, spd64, b64, spd, spd_plan, Mp, bp

    # -- 19. timing: kernel vs plain twin vs library call, every entry ---------
    bw, bw_known = hbm_bandwidth()
    if not bw_known:
        bw = 3.35e12
        print(f"[timing] {kind} is not in the HBM table: bounds use the H100 SXM "
              f"3.35 TB/s", flush=True)
    entries = []
    n, m = a.shape[1], a.shape[0]
    xy_w = (n + m) * K_WIDE * 4  # X read once and Y written once at k = 128
    for (name, source, replaces, kernel, plain, lib_op, operand, nbytes, flops, launches,
         max_abs) in (
            ("bdia_spmv [spmv(bsr, x)]", "bdia_spmv", f"{BDIA_PY}:290 (B1; also :409, B3)",
             lambda: bdia_spmv(plan, x), lambda: bdia_spmv_reference(plan, x), a_sp, x,
             (plan.vals.numel() + plan.shape[0] + plan.shape[1]) * 4, 2 * plan.vals.numel(),
             launches_spmv, abs_spmv),
            ("bdia_spmv [BdiaOperator in cg]", "bdia_spmv", f"{BDIA_PY}:70 (B2)",
             lambda: bdia_spmv(op.bdia, b), lambda: bdia_spmv_reference(op.bdia, b),
             sb_sp, b,
             (op.bdia.vals.numel() + 2 * op.bdia.shape[0]) * 4, 2 * op.bdia.vals.numel(),
             launches_cg, abs_op),
            ("dia_spmv [spmv(csr, x)]", "dia_spmv", f"{DIA_PY}:176 (B8)",
             lambda: dia_spmv(dplan, xs), lambda: dia_spmv_reference(dplan, xs), st_sp, xs,
             (dplan.vals.numel() + dplan.shape[0] + dplan.shape[1]) * 4,
             2 * dplan.vals.numel(), launches_dspmv, abs_dspmv),
            ("dia_spmv [solver_operator in cg]", "dia_spmv",
             f"{DIA_PY}:336 (B9), :511 (B10), :650 (B11)",
             lambda: dia_spmv(dop.dia, bs), lambda: dia_spmv_reference(dop.dia, bs), s_sp, bs,
             (dop.dia.vals.numel() + 2 * dop.dia.shape[0]) * 4, 2 * dop.dia.vals.numel(),
             launches_dcg, abs_dop),
            (f"dia_spmm [spmm(csr, X), k={K}]", "dia_spmm",
             f"{DIA_PY}:1148 (B14, k <= 64), :789 (B12)",
             lambda: dia_spmm(mplan, X), lambda: dia_spmm_reference(mplan, X), mm_sp, X,
             (mplan.vals.numel() + (mplan.shape[0] + mplan.shape[1]) * K) * 4,
             2 * mplan.vals.numel() * K, launches_mm_csr, abs_mm_csr),
            (f"dia_spmm [spmm(bsr, X), k={K}]", "dia_spmm",
             f"{DIA_PY}:1148 (B14, k <= 64)",
             lambda: dia_spmm(splan, Xb), lambda: dia_spmm_reference(splan, Xb), a_sp, Xb,
             (splan.vals.numel() + (splan.shape[0] + splan.shape[1]) * K) * 4,
             2 * splan.vals.numel() * K, launches_mm_bsr, abs_mm_bsr),
            (f"bdia_spmm_slab [spmm(bsr, X), k={K_WIDE}]", "bdia_slab_spmm",
             f"{SLAB_PY}:518 (B6; entries :505, :494), :290 (B5)",
             lambda: bdia_spmm_slab(sl, Xw), lambda: bdia_spmm_slab_reference(sl, Xw), a_sp, Xw,
             # operations: those A @ X needs (the BDIA plan's stored values), not
             # the zeros the sheared slab multiplies as well
             sl.slabs.numel() * 4 + xy_w, 2 * plan.vals.numel() * K_WIDE, launches_slab,
             abs_slab),
            (f"bdia_spmm_ring [spmm(plan, X, method='pallas_bdia'), k={K_WIDE}]", "bdia_spmm",
             f"{BDIA_PY}:607 (B4)", lambda: bdia_spmm_ring(plan, Xw),
             lambda: bdia_spmm_ring_reference(plan, Xw), a_sp, Xw,
             plan.vals.numel() * 4 + xy_w, 2 * plan.vals.numel() * K_WIDE, launches_ring,
             abs_ring),
            (f"bsr_spmm [spmm(bsr, X, method='pallas_bsr'), k={K_WIDE}]", "bsr_spmm",
             f"{BSR_PY}:91 (B7)", lambda: bsr_spmm(bplan, Xw),
             lambda: bsr_spmm_reference(bplan, Xw), a_sp, Xw,
             (bplan.vals.numel() + bplan.cols.numel()) * 4 + xy_w,
             2 * bplan.vals.numel() * K_WIDE, launches_bsr, abs_bsr),
            (f"dia_spmm [spmm(scalar-DIA plan, X), k={K_WIDE}]", "dia_spmm",
             f"{DIA_PY}:1023 (B13), :1314 (B15)", lambda: dia_spmm(splan, Xw),
             lambda: dia_spmm_reference(splan, Xw), a_sp, Xw,
             splan.vals.numel() * 4 + xy_w, 2 * splan.vals.numel() * K_WIDE, launches_dia_w,
             abs_dia_w),
            # the POH and LELL rows move their values once, every slot (a
            # value of 0 is what marks padding), and the int32 indices of the
            # live slots only (cloc + rloc for POH, idx for LELL), as padding
            # needs none; they count the function's operations, 2 per stored
            # entry and column
            ("poh_spmv [spmv(poh, x)]", "poh_spmv", f"{POH_PY}:388 (B16)",
             lambda: poh_spmv(pplan, xp), lambda: poh_spmv_reference(pplan, xp), pl_sp, xp,
             _pack_bytes(pplan.vals, 8) + pplan.ntiles * 4 + 2 * PL_N * 4, 2 * pl_sp.nnz,
             launches_poh, abs_poh),
            (f"poh_spmm [spmm(poh, X), k={K}]", "poh_spmm", f"{POH_PY}:538 (B17)",
             lambda: poh_spmm(pplan, Xp), lambda: poh_spmm_reference(pplan, Xp), pl_sp, Xp,
             _pack_bytes(pplan.vals, 8) + pplan.ntiles * 4 + 2 * PL_N * K * 4,
             2 * pl_sp.nnz * K, launches_pohmm, abs_pohmm),
            ("lell_spmv [HybLell.spmv: 2 launches + segment sum + remainder]", "lell_spmv",
             f"{LELL_PY}:377 (B18; also :365)", lambda: hyb.spmv(xp),
             lambda: hyb._spmv_reference(xp), pl_sp, xp,
             _pack_bytes(hyb.main.vals, 4) + hyb.main.rem_data.numel() * 12
             + _pack_bytes(hyb.hub.vals, 4) + hyb.hub.slot2row.numel() * 4 + 2 * PL_N * 4,
             2 * pl_sp.nnz,
             launches_lell, abs_lell)):
        S = _sparse_csr(lib_op, dev)
        library = lambda S=S, v=operand: S @ v  # noqa: E731
        _check(f"{name} library call vs kernel", _relerr(library(), kernel()), F32_TOL)
        # the k = 128 entries take milliseconds a call (their twins tens): fewer samples
        nr, reps = (20, 10) if operand is not Xw and operand is not Xp else (10, 3)
        runs = [time_cuda(f, warmup=3, runs=nr, reps=reps)
                for f in (plain, kernel, library, library, kernel, plain)]
        ms = float(np.median(runs[1].samples_ms + runs[4].samples_ms))
        plain_ms = float(np.median(runs[0].samples_ms + runs[5].samples_ms))
        library_ms = float(np.median(runs[2].samples_ms + runs[3].samples_ms))
        del S
        t_bytes, t_ops = nbytes / bw, flops / F32_PEAK
        bound_ms = max(t_bytes, t_ops) * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        gbs = nbytes / (ms * 1e-3) / 1e9
        print(f"[timing] {name}: kernel {ms * 1e3:.1f} us, plain twin {plain_ms * 1e3:.1f} us, "
              f"library (torch.sparse_csr_tensor @, cuSPARSE) {library_ms * 1e3:.1f} us; "
              f"{nbytes / 1e6:.1f} MB moved -> {gbs:.0f} GB/s, HBM fraction "
              f"{gbs * 1e9 / bw:.3f} of {bw / 1e12:.2f} TB/s; bound {bound_ms * 1e3:.1f} us "
              f"({bound_by}: {flops / 1e9:.2f} GFLOP); card {card}; median of 2x{nr} samples "
              f"of {reps} calls (CUDA events)", flush=True)
        entries.append({"name": name, "route": "cuda",
                        "source": f"cask_tpu_torch/csrc/{source}.cu", "replaces": replaces,
                        "launches": launches, "max_abs_err": max_abs, "ms": ms,
                        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": library_ms})

    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
