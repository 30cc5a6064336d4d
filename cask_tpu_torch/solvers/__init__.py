"""Iterative solvers built on the port's ops."""

from cask_tpu_torch.solvers.krylov import SolveResult, block_cg, cg  # noqa: F401
from cask_tpu_torch.solvers.precond import IC0Factors, extract_diagonal, ic0, jacobi, ssor  # noqa: F401
