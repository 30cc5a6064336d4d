"""Row-partitioned SpMV with overlapped halo exchange over a world of ranks:
the port's twin of ``examples/distributed_spmv.py`` (the same matrix, seed
and prints).

Run across the GPUs of one host, one NCCL rank a GPU:
    torchrun --nproc-per-node N -m cask_tpu_torch.examples.distributed_spmv
or on one GPU, a world of one rank:
    python -m cask_tpu_torch.examples.distributed_spmv

``main(device="cpu")`` spawns eight gloo ranks on the CPU, the shape of the
reference's eight-device CPU mesh.
"""

import numpy as np
import torch.distributed as dist

import cask_tpu_torch as ct
from cask_tpu_torch.parallel import DistSpmv, init_world, launch, partition_dia, row_mesh


def run(device=None) -> list:
    """The rank program: the lines rank 0 prints."""
    mesh = row_mesh(device=device)
    on_card = mesh.device.type == "cuda"
    a = ct.generate.stencil_2d(256, dtype=np.float32)  # 65k rows
    # the DIA kernel interior on the card needs 8192-row shards
    plan = partition_dia(a, mesh.size, align=8192 if on_card else 1)
    lines = [f"devices: {mesh.size}",
             f"partition: {plan.nshards} shards × {plan.mloc} rows, "
             f"{plan.vals.shape[1]} diagonals, halo ±{plan.halo_lo}/{plan.halo_hi}"]

    op = DistSpmv(plan, mesh, interior="pallas" if on_card else "plain")
    x = np.random.default_rng(0).standard_normal(a.shape[1]).astype(np.float32)
    y = op(x)
    err = np.abs(y.cpu().numpy() - ct.to_scipy(a) @ x).max()
    lines.append(f"‖y − ref‖∞ = {err:.2e}")

    # distributed CG on this rank's padded shards (f32 Poisson at 65k
    # unknowns: expect O(500–1500) iterations)
    res = ct.solvers.cg(op.padded_op, op.padded(x), tol=1e-4, maxiter=2000)
    lines.append(f"distributed CG: {res.iterations} iterations, converged={res.converged}")
    return lines


def main(device=None, nshards: int = 8):
    if device == "cpu":
        lines = launch(run, nshards, "cpu", timeout=600.0)[0]
    else:
        init_world()
        lines = run(device)
        if dist.get_rank():
            lines = []
    for line in lines:
        print(line)


if __name__ == "__main__":
    main()
