"""CG over the solver-resident DIA operator: the port's twin of
``examples/solver_resident_cg.py`` (the same matrix, seed and prints).

A Krylov loop applies A hundreds of times.  ``DiaOperator`` keeps every
vector in the layout its kernel reads (natural order on the card), so an
iteration pays no padding or format copy: each product is one launch of
the DIA SpMV kernel.

Run on the card:
    python -m cask_tpu_torch.examples.solver_resident_cg
"""

import numpy as np
import torch

import cask_tpu_torch as ct
from cask_tpu_torch.ops.dia import DiaOperator
from cask_tpu_torch.utils.platform import default_device


def main(device=None):
    dev = torch.device(device) if device is not None else default_device()
    a = ct.generate.stencil_2d(95)  # SPD Poisson, 9025 unknowns
    op = DiaOperator(a, device=dev)
    print(f"operator mode: {op.mode} (offsets {op.dia.offsets})")

    rng = np.random.default_rng(0)
    b = rng.standard_normal(a.shape[0])
    res = ct.solvers.cg(op, op.to_padded(b), tol=1e-8, maxiter=800)
    x = op.from_padded(res.x).cpu().numpy()
    err = np.abs(ct.to_scipy(a) @ x - b).max()
    print(f"CG: {res.iterations} iterations, converged={res.converged}, "
          f"‖Ax−b‖∞ = {err:.2e}")


if __name__ == "__main__":
    main()
