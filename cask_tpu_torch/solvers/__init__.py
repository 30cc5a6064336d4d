"""Iterative solvers built on the port's ops."""

from cask_tpu_torch.solvers.krylov import (  # noqa: F401
    SolveResult,
    bicgstab,
    block_cg,
    cg,
    cgls,
    chebyshev,
    gmres,
    ir_solve,
    minres,
    pipelined_cg,
)
from cask_tpu_torch.solvers.eig import (  # noqa: F401
    EigResult,
    lobpcg,
)
from cask_tpu_torch.solvers.amg import (  # noqa: F401
    AmgPrecond,
    smoothed_aggregation_amg,
)
from cask_tpu_torch.solvers.precond import (  # noqa: F401
    IC0Factors,
    block_jacobi,
    chebyshev_precond,
    estimate_lmax,
    extract_diagonal,
    ic0,
    jacobi,
    lanczos_extremal,
    shard_ilu0,
    ssor,
)
