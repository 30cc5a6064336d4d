"""Sparse ops: SpMV, SpMM and the DIA, BDIA, POH and LELL plans; SpGEMM,
sparse add, the triangular solve and ILU(0).

Each op has an always-available plain PyTorch formulation and, on the
main path, a hand-written CUDA kernel (:mod:`cask_tpu_torch.ops.kernels`).
"""

from cask_tpu_torch.ops.spmv import spmv  # noqa: F401
from cask_tpu_torch.ops.spmm import spmm  # noqa: F401
from cask_tpu_torch.ops.bdia import BdiaMatrix, BdiaOperator, bdia_plan  # noqa: F401
from cask_tpu_torch.ops.dia import DiaMatrix, DiaOperator, dia_plan, solver_operator  # noqa: F401
from cask_tpu_torch.ops.spgemm import SpGEMMPlan, spgemm  # noqa: F401
from cask_tpu_torch.ops.trisolve import TriSolvePlan, trisolve  # noqa: F401
from cask_tpu_torch.ops.ilu import ILU0Factors, ilu0  # noqa: F401
from cask_tpu_torch.ops.add import AddPlan, add_plan, shift_identity, sp_add  # noqa: F401
