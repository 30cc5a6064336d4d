"""One distributed CG-style step over ``n`` ranks at tiny shapes: the port's
twin of ``dryrun_multichip`` in the repository's ``__graft_entry__.py``.

It exercises the DIA row partition with its ring halo exchange, the COO
remainder's all-gather, inner products summed across ranks, CG and
pipelined CG on the shards, the BDIA partition with its kernel interior
and edge fix-ups, the slab SpMM interior, the COO and POH paths and the
2-D grid: the whole multi-device program at tiny shapes.

    python -m cask_tpu_torch.examples.dryrun_multichip [N]   # N gloo ranks on the CPU
    python -m cask_tpu_torch.examples.dryrun_multichip N --gpu   # N NCCL ranks, one a GPU
"""

from __future__ import annotations

import sys

import numpy as np


def dryrun_rank(device=None) -> str:
    """The rank program; returns what it ran."""
    from cask_tpu_torch.formats.generate import power_law, stencil_2d
    from cask_tpu_torch.parallel import (Dist2DSpmv, DistSpmv, fem_bdia_partition, mesh_2d,
                                         partition_2d, partition_coo, partition_dia,
                                         partition_poh, row_mesh, slab_choice)
    from cask_tpu_torch.solvers import cg, pipelined_cg

    mesh = row_mesh(device=device)
    n = mesh.size
    rng = np.random.default_rng(0)

    # banded path: ring halo exchange, then CG and pipelined CG on the shards
    side = max(4, int(np.ceil(np.sqrt(n * 64))))
    a = stencil_2d(side, dtype=np.float32)
    op = DistSpmv(partition_dia(a, n), mesh)
    b = op.padded(rng.standard_normal(a.shape[0]).astype(np.float32))
    res = cg(op.padded_op, b, tol=1e-3, maxiter=3)
    resp = pipelined_cg(op.padded_op, b, tol=1e-3, maxiter=3)
    assert np.isfinite(res.residual_norm) and np.isfinite(resp.residual_norm)

    # block path: BDIA block-row partition, ring halo of block components,
    # edge fix-ups; the kernel interior, then the slab SpMM interior
    bplan = fem_bdia_partition(max(8, n * 2), dof=4, nshards=n)
    bop = DistSpmv(bplan, mesh)
    bb = bop.padded(rng.standard_normal(bplan.shape[0]).astype(np.float32))
    assert np.isfinite(cg(bop.padded_op, bb, tol=1e-3, maxiter=3).residual_norm)
    DistSpmv(bplan, mesh, interior="fused")(
        rng.standard_normal(bplan.shape[1]).astype(np.float32))
    if slab_choice(bplan)[0] is not None:
        DistSpmv(bplan, mesh, mm_interior="slab")(
            rng.standard_normal((bplan.shape[1], 96)).astype(np.float32))

    # general path: interior/exterior split with the all-gather overlapped
    g = power_law(max(n * 32, 128), avg_degree=4, seed=1)
    x = rng.standard_normal(g.shape[1])
    DistSpmv(partition_coo(g, n), mesh)(x)
    # unstructured path: per-shard POH packs
    DistSpmv(partition_poh(g, n, row_panel=256, col_window=128, tile_slots=256),
             mesh)(x.astype(np.float32))
    # 2-D path: x split over the grid's columns, partials summed along its rows
    if n >= 4 and n % 2 == 0:
        Dist2DSpmv(partition_2d(g, n // 2, 2), mesh_2d(n // 2, 2, device=device))(x)
    return f"rank {mesh.rank} of {n} ({mesh.device}): dryrun ok"


def dryrun_multichip(n_devices: int, *, device: str = "cpu") -> list:
    """Run :func:`dryrun_rank` on ``n_devices`` spawned ranks: gloo on the CPU,
    or NCCL with one rank a GPU (``device="cuda"``)."""
    from cask_tpu_torch.examples import dryrun_multichip as me  # importable in the ranks
    from cask_tpu_torch.parallel import launch

    if device == "cpu":
        return launch(me.dryrun_rank, n_devices, "cpu", timeout=600.0)
    return launch(me.dryrun_rank, n_devices, None, backend="nccl", timeout=600.0)


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    for line in dryrun_multichip(int(args[0]) if args else 8,
                                 device="cuda" if "--gpu" in sys.argv else "cpu"):
        print(line)
    print("dryrun_multichip ok")
