"""ILU(0)-preconditioned CG on a 2-D Poisson problem: the port's twin of
``examples/cg_solver.py`` (the same matrix, seed and prints).

Run on the card:
    python -m cask_tpu_torch.examples.cg_solver
"""

import numpy as np
import torch

import cask_tpu_torch as ct
from cask_tpu_torch.utils.platform import default_device


def main(device=None):
    dev = torch.device(device) if device is not None else default_device()
    side = 64
    a = ct.generate.stencil_2d(side)  # SPD Poisson, 4096 unknowns
    rng = np.random.default_rng(0)
    b = torch.from_numpy(rng.standard_normal(a.shape[0])).to(dev)
    ad = a.to(dev)

    plain = ct.solvers.cg(ad, b, tol=1e-10, maxiter=2000)
    print(f"plain CG:  {plain.iterations:4d} iterations, "
          f"residual {plain.residual_norm:.2e}")

    factors = ct.ilu0(a, device=dev)  # native C++ factorization
    pcg = ct.solvers.cg(ad, b, tol=1e-10, maxiter=2000, M=factors.apply)
    print(f"ILU(0)-CG: {pcg.iterations:4d} iterations, "
          f"residual {pcg.residual_norm:.2e}")

    x = pcg.x.cpu().numpy()
    err = np.abs(ct.to_scipy(a) @ x - b.cpu().numpy()).max()
    print(f"‖Ax − b‖∞ = {err:.2e}")


if __name__ == "__main__":
    main()
