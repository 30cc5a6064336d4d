"""Sparse ops: SpMV, SpMM and the DIA, BDIA, POH and LELL plans.

Each op has an always-available plain PyTorch formulation and, on the
main path, a hand-written CUDA kernel (:mod:`cask_tpu_torch.ops.kernels`).
"""

from cask_tpu_torch.ops.spmv import spmv  # noqa: F401
from cask_tpu_torch.ops.spmm import spmm  # noqa: F401
from cask_tpu_torch.ops.bdia import BdiaMatrix, BdiaOperator, bdia_plan  # noqa: F401
from cask_tpu_torch.ops.dia import DiaMatrix, DiaOperator, dia_plan, solver_operator  # noqa: F401
