"""Unstructured SpMV on the panel one-hot (POH) pack: the port's twin of
``examples/unstructured_spmv.py`` (the same matrix, seed and prints).

A power-law graph matrix has no band and no blocks.  ``poh_plan`` packs its
entries column-sorted into dense tiles of row panels; on the card one
kernel gathers x and scatters into each panel's rows in shared memory.
The reference's ``"split"`` and ``"fast"`` modes choose how its one-hot
products round on the TPU's matrix unit; on the card both are the same
FP32 FMAs, so the two lines print the same error.

Run on the card:
    python -m cask_tpu_torch.examples.unstructured_spmv
"""

import numpy as np
import torch

from cask_tpu_torch.formats.convert import to_scipy
from cask_tpu_torch.formats.generate import power_law
from cask_tpu_torch.ops.poh import poh_plan
from cask_tpu_torch.tune import tune
from cask_tpu_torch.utils.platform import default_device


def main(device=None):
    dev = torch.device(device) if device is not None else default_device()
    a = power_law(20_000, avg_degree=15, dtype=np.float32, seed=1)
    x = np.random.default_rng(0).standard_normal(a.shape[1]).astype(np.float32)

    # direct: plan once (host), apply many times (device)
    p = poh_plan(a, device=dev)
    xd = torch.from_numpy(x).to(dev)
    y = p.spmv(xd).cpu().numpy()
    y_fast = p.spmv(xd, precision="fast").cpu().numpy()
    ref = to_scipy(a) @ x
    print(f"poh split relerr: {np.abs(y - ref).max() / np.abs(ref).max():.2e}")
    print(f"poh fast  relerr: {np.abs(y_fast - ref).max() / np.abs(ref).max():.2e}")
    print(f"pack fill: {p.fill():.1%} over {p.ntiles} tiles")

    # or let the autotuner pick (it enumerates the POH variants for
    # unstructured f32 matrices and caches the winner by signature)
    t = tune(a, include_pallas=True, time_budget=2, device=dev)
    print(f"tuned variant: {t.variant}")


if __name__ == "__main__":
    main()
