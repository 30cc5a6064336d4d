"""Multi-GPU scaling job: the port's twin of ``examples/scaling_job.py``.

A weak-scaling ladder of the distributed halo SpMV, the overlap A/B and an
optional profiler trace, emitting the reference's JSON records.  Run it
with one rank a GPU (NCCL):

    torchrun --nproc-per-node N -m cask_tpu_torch.examples.scaling_job \\
        --rows-per-shard 2000000 --shards 1,2,4,8

Each shard count ``P`` of the ladder runs on the first ``P`` ranks (a
subgroup); the others wait.  ``--cpu`` spawns the ranks as gloo processes
on this host instead (eight unless ``--shards`` asks for more or fewer):

    python -m cask_tpu_torch.examples.scaling_job --cpu --rows-per-shard 300000 \\
        --shards 1,2,4,8

Output: one JSON line per (kind, nshards) with ``ns_per_row`` (the slowest
rank's time per product over the rows); weak-scaling efficiency =
ns_per_row(first P) / ns_per_row(P); 0.70 is the north-star bar on a
machine with several GPUs.  On the CPU the number checks the program's
structure, not a GPU interconnect.  The last line aggregates:
``{"op": "scaling_summary", ...}``.  On the card the shard interiors are
the DIA kernel (``--kind dia``) or the BDIA kernel (``--kind bdia``) and,
with ``--mm K``, the slab SpMM kernel where its pack fits the byte cap.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

_T0 = time.time()


def _parser():
    ap = argparse.ArgumentParser(prog="cask_tpu_torch.examples.scaling_job")
    ap.add_argument("--rows-per-shard", type=int, default=2_000_000,
                    help="weak scaling: rows per shard (the problem grows with P)")
    ap.add_argument("--shards", default=None,
                    help="comma list, e.g. 1,2,4,8 (default: powers of 2 up to the ranks)")
    ap.add_argument("--out", default=None, help="append JSON lines to file")
    ap.add_argument("--trace", default=None,
                    help="directory for a torch.profiler trace of three overlapped steps")
    ap.add_argument("--cpu", action="store_true", help="spawn gloo ranks on the CPU")
    ap.add_argument("--kind", default="dia", choices=("dia", "bdia"),
                    help="dia: scalar 5-point stencil; bdia: dof-4 FEM block matrix")
    ap.add_argument("--mm", type=int, default=0, metavar="K",
                    help="also ladder the SpMM path with K dense columns")
    return ap


def _plan(args, p: int):
    from cask_tpu_torch.parallel import fem_bdia_partition, stencil_dia_partition

    if args["kind"] == "bdia":
        nx = int(math.sqrt(args["rows_per_shard"] * p / 4))  # dof-4 blocks: rows = nx²·4
        return fem_bdia_partition(nx, dof=4, nshards=p)
    return stencil_dia_partition(int(math.sqrt(args["rows_per_shard"] * p)), nshards=p,
                                 align=8192)


def _slowest(seconds: float, group) -> float:
    import torch.distributed as dist

    got = [None] * dist.get_world_size(group)
    dist.all_gather_object(got, seconds, group=group)
    return max(got)


def job(args: dict, device=None) -> list:
    """The rank program; returns the records (rank 0's are the job's)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from cask_tpu_torch.parallel import DistSpmv, row_mesh
    from cask_tpu_torch.tune.timing import measure

    world, rank = dist.get_world_size(), dist.get_rank()
    shards = [p for p in args["shards"] if p <= world]
    records = []
    on_card = row_mesh(device=device).device.type == "cuda"
    interior = ("pallas" if args["kind"] == "dia" else "fused") if on_card else "plain"
    backend = "cuda" if on_card else "cpu"

    def timed(op, v):
        meas = measure(op.padded_op, op.padded(v))
        return _slowest(meas.seconds_per_iter, op.mesh.group), meas.reliable

    base = {}
    groups = {p: (None if p == world else dist.new_group(list(range(p)))) for p in shards}
    for p in shards:
        if rank < p:
            plan = _plan(args, p)
            n = plan.shape[0]
            mesh = row_mesh(group=groups[p], device=device)
            op = DistSpmv(plan, mesh, interior=interior)
            rng = np.random.default_rng(0)
            x0 = (0.1 * rng.standard_normal(n)).astype(np.float32)
            sec, reliable = timed(op, x0)
            ns = sec / n * 1e9
            base.setdefault("spmv", ns)
            records.append({"op": "dist_spmv_weak_scaling", "kind": args["kind"], "nshards": p,
                            "rows": n, "interior": op.interior, "seconds_per_op": sec,
                            "ns_per_row": round(ns, 4), "reliable": reliable,
                            "backend": backend, "staged": mesh.staged,
                            "efficiency": round(base["spmv"] / ns, 4)})
            if args["mm"]:
                X0 = (0.1 * np.random.default_rng(2).standard_normal((n, args["mm"]))
                      ).astype(np.float32)
                sec, reliable = timed(op, X0)
                ns = sec / n * 1e9
                base.setdefault("spmm", ns)
                records.append({"op": "dist_spmm_weak_scaling", "kind": args["kind"],
                                "k": args["mm"], "nshards": p, "rows": n,
                                "mm_interior": op.mm_interior, "seconds_per_op": sec,
                                "ns_per_row": round(ns, 4), "reliable": reliable,
                                "backend": backend, "efficiency": round(base["spmm"] / ns, 4)})
            del op, plan
        dist.barrier()

    # overlap A/B at the largest shard count
    p = max(shards)
    if rank < p:
        plan = _plan(args, p)
        mesh = row_mesh(group=groups[p], device=device)
        x0 = (0.1 * np.random.default_rng(1).standard_normal(plan.shape[0])).astype(np.float32)
        times = {}
        for name, ov in (("overlapped", True), ("serialized", False)):
            op = DistSpmv(plan, mesh, overlap=ov, interior=interior)
            times[name], reliable = timed(op, x0)
            records.append({"op": "dist_spmv_overlap_ab", "kind": args["kind"],
                            "variant": name, "nshards": p, "rows": plan.shape[0],
                            "interior": op.interior, "seconds_per_op": times[name],
                            "reliable": reliable, "staged": mesh.staged})
        hidden = times["serialized"] - times["overlapped"]
        records.append({"op": "dist_spmv_overlap_ab", "variant": "hidden_comm_seconds",
                        "nshards": p, "value": hidden,
                        "hidden_frac_of_serialized": round(hidden / times["serialized"], 4)})
        if args["trace"]:
            import os

            op = DistSpmv(plan, mesh, overlap=True, interior=interior)
            xp = op.padded(x0)
            op.padded_op(xp)  # build and warm outside the trace
            acts = [torch.profiler.ProfilerActivity.CPU]
            if on_card:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(3):
                    op.padded_op(xp)
                if on_card:
                    torch.cuda.synchronize()
            os.makedirs(args["trace"], exist_ok=True)
            path = os.path.join(args["trace"], f"trace_rank{rank}.json")
            prof.export_chrome_trace(path)
            records.append({"op": "profiler_trace", "path": path,
                            "note": "the halo exchange against the interior kernel"})
    dist.barrier()

    effs = [r["efficiency"] for r in records if r["op"] == "dist_spmv_weak_scaling"]
    records.append({"op": "scaling_summary",
                    "weak_scaling_efficiency_at_max_shards": effs[-1] if effs else None,
                    "target": 0.70, "shards": shards, "ndevices": world,
                    "wall_s": round(time.time() - _T0, 1)})
    return records


def main(argv=None):
    args = vars(_parser().parse_args(argv))
    want = [int(s) for s in args["shards"].split(",")] if args["shards"] else None
    if args["cpu"]:
        from cask_tpu_torch.examples import scaling_job as me  # importable in the ranks
        from cask_tpu_torch.parallel import launch

        world = max(want) if want else 8
        args["shards"] = want or [p for p in (1, 2, 4, 8) if p <= world]
        records = launch(me.job, world, args, "cpu", timeout=3600.0)[0]
    else:
        import torch.distributed as dist

        from cask_tpu_torch.parallel import init_world

        init_world()
        world = dist.get_world_size()
        args["shards"] = want or [p for p in (1, 2, 4, 8, 16, 32, 64) if p <= world]
        records = job(args)
        if dist.get_rank():
            return 0
    out = open(args["out"], "a") if args["out"] else sys.stdout
    for rec in records:
        print(json.dumps(rec), file=out, flush=True)
    if args["out"]:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
