"""Sparse least squares: CGLS on a rectangular matrix.  The port's twin of
``examples/least_squares.py`` (the same matrix, seeds and prints).

``cgls`` iterates CG on the normal equations AᵀA x = Aᵀb without forming
AᵀA: each iteration is one SpMV and one transposed SpMV.  The transpose of
a plan (DIA, BDIA, POH) is a one-time host repack
(``cask_tpu_torch.transposed``), so the loop pays no transposition an
iteration.

Run on the card:
    python -m cask_tpu_torch.examples.least_squares
"""

import numpy as np
import torch

import cask_tpu_torch as ct
from cask_tpu_torch.solvers import cgls
from cask_tpu_torch.utils.platform import default_device


def main(device=None):
    dev = torch.device(device) if device is not None else default_device()
    m, n = 4000, 1200
    a = ct.generate.random_uniform(m, n, density=0.01, seed=0)
    rng = np.random.default_rng(1)
    x_true = rng.standard_normal(n)
    noise = 1e-3 * rng.standard_normal(m)
    b = ct.to_scipy(a) @ x_true + noise

    # a CSR applies Aᵀ by spmv(a, v, transpose=True); for a plan, cgls builds
    # transposed(plan) once
    res = cgls(a.to(dev), torch.from_numpy(b).to(dev), tol=1e-10, maxiter=5000)
    x = res.x.cpu().numpy()

    s = ct.to_scipy(a)
    normal_res = np.linalg.norm(s.T @ (b - s @ x))
    print(f"converged={res.converged} iters={res.iterations}")
    print(f"‖Aᵀ(b−Ax)‖ = {normal_res:.3e}")
    print(f"‖x − x_true‖/‖x_true‖ = "
          f"{np.linalg.norm(x - x_true) / np.linalg.norm(x_true):.3e}")
    if not normal_res < 1e-6:
        raise RuntimeError(f"‖Aᵀ(b−Ax)‖ = {normal_res:.3e} is not below 1e-6")


if __name__ == "__main__":
    main()
