"""Iterative solvers built on the port's ops."""

from cask_tpu_torch.solvers.krylov import SolveResult, cg  # noqa: F401
from cask_tpu_torch.solvers.precond import extract_diagonal, jacobi  # noqa: F401
