"""cask_tpu_torch — the PyTorch/CUDA port of :mod:`cask_tpu` for an NVIDIA H100.

It mirrors the JAX package's layout and names, module for module, and is
held against it by the ``tests/test_torch_*.py`` parity tests.  Plain
tensor code is PyTorch; each TPU kernel on a ported path is a CUDA kernel
written by hand for ``sm_90a`` (sources in ``cask_tpu_torch/csrc``), built
with ``nvcc`` at first use.  It imports ``torch``, ``numpy`` and ``scipy``,
never JAX or the JAX package.

Ported so far: the formats and their conversions, the generators, the
gather SpMV and SpMM formulations, the BDIA plan with its CUDA SpMV and
ring SpMM kernels, the slab plan with its CUDA slab SpMM kernel, the
ELL-packed BSR SpMM with its kernel, the DIA plan with its CUDA SpMV and
SpMM kernels, the ``spmv`` and ``spmm`` dispatch with their cached plans
(the wide-k chain above k = 64 included), CG with a Jacobi preconditioner
over a :class:`BdiaOperator` or a :class:`DiaOperator`
(:func:`solver_operator`), block CG over ``spmm``, and the
unstructured-matrix path: Matrix Market input (:func:`read_mtx`,
:func:`write_mtx`), the panel one-hot plan (:func:`poh_plan`) with its CUDA
SpMV and SpMM kernels, under ``spmv``, ``spmm``, ``transposed`` and CG, and
the lane-bucketed ELL plans (:func:`lell_plan_hyb`) with their CUDA kernel;
SpGEMM (:func:`spgemm`: a host symbolic plan and a device numeric phase, the
POH SpMV kernel with A's values bound, or the native core's Gustavson),
sparse add (:func:`sp_add`, :func:`shift_identity`), the level-scheduled
and Jacobi triangular solves (:func:`trisolve`), ILU(0) on the native core
(:func:`ilu0`) and Chow–Patel on the device, and the IC(0) and SSOR
preconditioners, all over the port's own copy of the native C++
preprocessing core (:mod:`cask_tpu_torch.native`); the per-matrix autotuner
(:func:`tune`: sparsity signatures, RCM reordering (:func:`reorder_rcm`),
the tuner cache and the POH calibration) and the bench harness over it
(:mod:`cask_tpu_torch.bench`).
"""

__version__ = "0.1.0"

from cask_tpu_torch.formats import BSR, COO, CSR  # noqa: F401
from cask_tpu_torch.formats.convert import (  # noqa: F401
    bsr_to_csr,
    coo_to_csr,
    csr_to_bsr,
    csr_to_coo,
    from_scipy,
    to_scipy,
    transpose,
)
from cask_tpu_torch.formats import generate  # noqa: F401
from cask_tpu_torch.formats.mtx import read_mtx, write_mtx  # noqa: F401
from cask_tpu_torch.formats.reorder import bandwidth, reorder_rcm  # noqa: F401
from cask_tpu_torch.ops import ilu0, shift_identity, sp_add, spgemm, spmm, spmv, trisolve  # noqa: F401
from cask_tpu_torch.ops.spmv import PlanCache, transposed  # noqa: F401
from cask_tpu_torch.ops.bdia import BdiaMatrix, BdiaOperator, bdia_plan  # noqa: F401
from cask_tpu_torch.ops.dia import DiaMatrix, DiaOperator, dia_plan, solver_operator  # noqa: F401
from cask_tpu_torch.ops.lell import HybLell, LellMatrix, lell_plan, lell_plan_hyb  # noqa: F401
from cask_tpu_torch.ops.poh import PohMatrix, poh_plan  # noqa: F401
from cask_tpu_torch.tune import TunedSpmv, tune  # noqa: F401
from cask_tpu_torch import solvers  # noqa: F401
