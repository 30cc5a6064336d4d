"""Instance-directed tuning: the port's twin of ``examples/autotune_bench.py``
(the same four matrices and prints).

The tuner times the variants its traffic model ranks highest for one
matrix and caches the winner by sparsity signature, so a second run, or
another matrix of the same structure, goes straight to the tuned kernel.
Then ``bench_matrix`` prints one JSON record per variant with its share of
the card's memory roofline.

Run on the card:
    python -m cask_tpu_torch.examples.autotune_bench
"""

import sys

import torch

import cask_tpu_torch as ct
from cask_tpu_torch.bench.harness import bench_matrix
from cask_tpu_torch.utils.platform import default_device


def main(device=None, time_budget: int = 3):
    dev = torch.device(device) if device is not None else default_device()
    mats = {
        "banded_20k": ct.generate.banded(20000, 8, seed=0),
        "stencil_158": ct.generate.stencil_2d(158),
        "fem_dof4": ct.generate.fem_blocks(60, dof=4),
        "powerlaw_20k": ct.generate.power_law(20000, avg_degree=8, seed=1),
    }
    for name, a in mats.items():
        t = ct.tune(a, time_budget=time_budget, force=True, device=dev)
        print(f"{name:14s} → {t.variant:12s} {t.seconds_per_op:.3e} s/op")

    print("\nroofline records (f32 SpMV):")
    for name, a in mats.items():
        bench_matrix(name, a, device=dev, out=sys.stdout)


if __name__ == "__main__":
    main()
