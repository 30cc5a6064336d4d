"""The forward step on the flagship path: the port's twin of ``entry()`` in
the repository's ``__graft_entry__.py``.

``entry()`` returns ``(fn, args)``: the BDIA SpMV, one launch of its CUDA
kernel on the card, on a 4096-row FEM matrix with dense 4×4 node blocks.

    python -m cask_tpu_torch.examples.entry
"""

import numpy as np
import torch

from cask_tpu_torch.formats.generate import fem_blocks
from cask_tpu_torch.ops.bdia import bdia_plan
from cask_tpu_torch.utils.platform import default_device


def entry(device=None):
    """Return ``(fn, (plan, x))`` with ``fn(plan, x) = plan.spmv(x)``, the plan
    and x on ``device`` (the CUDA device unless given)."""
    dev = torch.device(device) if device is not None else default_device()
    a = fem_blocks(32, dof=4, dtype=np.float32)  # 4096 rows
    plan = bdia_plan(a, (4, 4), device=dev)

    def fn(mat, x):
        return mat.spmv(x)

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(a.shape[1]).astype(np.float32)).to(dev)
    return fn, (plan, x)


def main(device=None):
    fn, args = entry(device)
    out = fn(*args)
    print("entry ok:", tuple(out.shape), float(out[:8].sum()))


if __name__ == "__main__":
    main()
