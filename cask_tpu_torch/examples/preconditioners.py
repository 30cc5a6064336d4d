"""Preconditioner tour on a 2-D Poisson problem: iteration counts for plain
CG against Jacobi, block Jacobi, the Chebyshev polynomial, host ILU(0),
device (Chow–Patel) ILU(0) and smoothed-aggregation AMG.  The port's twin
of ``examples/preconditioners.py`` (the same matrix, seed and prints), with
the AMG V-cycle added to the table.

Run on the card:
    python -m cask_tpu_torch.examples.preconditioners
"""

import numpy as np
import torch

from cask_tpu_torch.formats.generate import stencil_2d
from cask_tpu_torch.ops.ilu import ilu0, ilu0_device
from cask_tpu_torch.solvers import (block_jacobi, cg, chebyshev_precond, estimate_lmax, jacobi,
                                    smoothed_aggregation_amg)
from cask_tpu_torch.utils.platform import default_device


def main(device=None):
    dev = torch.device(device) if device is not None else default_device()
    a = stencil_2d(48)  # 2304-unknown Poisson system
    ad = a.to(dev)
    b = torch.from_numpy(np.random.default_rng(0).standard_normal(a.shape[0])).to(dev)

    lmax = estimate_lmax(ad, a.shape[0], iters=30)
    precs = {
        "none": None,
        "jacobi": jacobi(a, device=dev),
        "block_jacobi(64)": block_jacobi(a, 64, device=dev),
        "chebyshev(deg=8)": chebyshev_precond(
            ad, lmin=lmax / 100, lmax=lmax, degree=8, M=jacobi(a, device=dev)),
        "ilu0 (host)": ilu0(a, device=dev).apply,
        "ilu0 (device, Chow-Patel)": ilu0_device(a, sweeps=8, device=dev).apply,
        "smoothed_aggregation_amg": smoothed_aggregation_amg(a, device=dev),
    }
    for name, M in precs.items():
        res = cg(ad, b, tol=1e-8, maxiter=1000, M=M)
        print(f"{name:28s} iters={res.iterations:4d} "
              f"resid={res.residual_norm:.2e} "
              f"converged={res.converged}")


if __name__ == "__main__":
    main()
