"""cask_tpu_torch — the PyTorch/CUDA port of :mod:`cask_tpu` for an NVIDIA H100.

It mirrors the JAX package's layout and names, module for module, and is
held against it by the ``tests/test_torch_*.py`` parity tests.  Plain
tensor code is PyTorch; each TPU kernel on a ported path is a CUDA kernel
written by hand for ``sm_90a`` (sources in ``cask_tpu_torch/csrc``), built
with ``nvcc`` at first use.  It imports ``torch``, ``numpy`` and ``scipy``,
never JAX or the JAX package.

Ported so far: the formats and their conversions, the generators, the
gather SpMV formulations, the BDIA plan with its CUDA SpMV kernel, the
``spmv`` dispatch, and CG with a Jacobi preconditioner over a
:class:`BdiaOperator`.
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
from cask_tpu_torch.ops import spmv  # noqa: F401
from cask_tpu_torch.ops.spmv import PlanCache, transposed  # noqa: F401
from cask_tpu_torch.ops.bdia import BdiaMatrix, BdiaOperator, bdia_plan  # noqa: F401
from cask_tpu_torch import solvers  # noqa: F401
