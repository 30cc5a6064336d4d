"""LOBPCG eigensolver example: extremal eigenpairs of a sparse SPD
operator, then the spectrum bounds fed into a Chebyshev-preconditioned CG
solve.  The port's twin of ``examples/eigenvalues.py`` (the same matrix,
seed and prints).

Run on the card:
    python -m cask_tpu_torch.examples.eigenvalues
"""

import numpy as np
import torch

import cask_tpu_torch as ct
from cask_tpu_torch.solvers import cg, chebyshev_precond, ic0, lobpcg
from cask_tpu_torch.utils.platform import default_device


def main(device=None):
    dev = torch.device(device) if device is not None else default_device()
    # 10k-row 2-D Poisson operator
    a = ct.generate.stencil_2d(100)
    ad = a.to(dev)
    n = a.shape[0]
    rng = np.random.default_rng(0)

    # --- smallest eigenpairs (the hard direction): IC(0)-preconditioned ---
    x0 = rng.standard_normal((n, 4))
    small = lobpcg(ad, x0, tol=1e-6, maxiter=500, M=ic0(a, device=dev).apply)
    print(f"smallest 4: {small.theta.cpu().numpy()}  "
          f"({small.iterations} iters, converged={small.converged})")

    # --- largest eigenpairs: unpreconditioned is fine ---
    large = lobpcg(ad, x0, largest=True, tol=1e-6, maxiter=500)
    print(f"largest 4:  {large.theta.cpu().numpy()}  ({large.iterations} iters)")

    # --- use the measured spectrum for a Chebyshev-preconditioned solve ---
    lmin, lmax = float(small.theta[0]), float(large.theta[-1])
    b = torch.from_numpy(rng.standard_normal(n)).to(dev)
    M = chebyshev_precond(ad, lmin=lmin, lmax=lmax, degree=8)
    res = cg(ad, b, tol=1e-10, maxiter=500, M=M)
    plain = cg(ad, b, tol=1e-10, maxiter=2000)
    print(f"chebyshev({lmin:.4f},{lmax:.4f})-PCG: {res.iterations} iters "
          f"vs plain CG {plain.iterations}")
    if not res.converged:
        raise RuntimeError("the Chebyshev-preconditioned solve did not converge")


if __name__ == "__main__":
    main()
