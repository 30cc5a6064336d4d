"""Command-line bench:  python -m cask_tpu_torch.bench.cli <subcommand>.

The PyTorch counterpart of :mod:`cask_tpu.bench.cli`.  Subcommands:

  spmv      --mtx FILE | --suite small|medium   [--dtype f32|f64] [--variants a,b]
  spmm      --k 32|128 ...
  tune      --mtx FILE | --suite ... [--k N]   (populate the tuner cache)
  calibrate [--force]                          (POH cost constants for this card)
  scaling   [--side N] [--shards 1,2,4,8]      (distributed SpMV weak scaling)
  overlap   [--side N] [--shards N]            (halo exchange overlapped vs serialized)
  solve     [--side N]                         (CG and pipelined CG, µs an iteration)

Everything runs on the CUDA device unless ``--cpu`` asks for the CPU
(``scaling`` and ``overlap``: one NCCL rank a GPU, or gloo ranks on the
CPU).  Records are JSON lines on stdout; ``--out FILE`` appends them to a
file.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _load(args):
    from cask_tpu_torch.formats.generate import suite
    from cask_tpu_torch.formats.mtx import read_mtx

    if args.mtx:
        return {args.mtx: read_mtx(args.mtx)}
    return suite(args.suite)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="cask_tpu_torch.bench.cli")
    ap.add_argument("--out", default=None, help="append JSON lines to file")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain twins) instead of the card")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_spmv = sub.add_parser("spmv")
    p_spmm = sub.add_parser("spmm")
    p_tn = sub.add_parser("tune")
    for p in (p_spmv, p_spmm, p_tn):
        p.add_argument("--mtx", default=None)
        p.add_argument("--suite", default="small", choices=["small", "medium"])
    for p in (p_spmv, p_spmm):
        p.add_argument("--dtype", default="f32", choices=["f32", "f64"])
        p.add_argument("--variants", default=None,
                       help="comma list, e.g. dia_pallas,csr_xla")
    p_spmm.add_argument("--k", type=int, default=32)
    p_tn.add_argument("--k", type=int, default=None)
    p_cal = sub.add_parser(
        "calibrate", help="measure the POH cost constants on this card and store "
        "them in the tuner cache")
    p_cal.add_argument("--force", action="store_true")
    p_sc = sub.add_parser("scaling")
    p_sc.add_argument("--side", type=int, default=512)
    p_sc.add_argument("--shards", default="1,2,4,8")
    p_ov = sub.add_parser("overlap")
    p_ov.add_argument("--side", type=int, default=512)
    p_ov.add_argument("--shards", type=int, default=None)
    p_sv = sub.add_parser("solve")
    p_sv.add_argument("--side", type=int, default=512)

    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None

    out = open(args.out, "a") if args.out else sys.stdout
    try:
        if args.cmd in ("spmv", "spmm"):
            from cask_tpu_torch.bench.harness import bench_matrix

            variants = args.variants.split(",") if args.variants else None
            k = getattr(args, "k", None)
            dtype = {"f32": np.float32, "f64": np.float64}[args.dtype]
            for name, a in _load(args).items():
                bench_matrix(name, a, k=k, dtype=dtype, variants=variants, out=out,
                             device=device)
        elif args.cmd == "tune":
            from cask_tpu_torch.tune import tune

            for name, a in _load(args).items():
                t = tune(a, k=args.k, force=True, device=device)
                print(f"{name}: {t.variant} ({t.seconds_per_op:.3e} s/op)", file=sys.stderr)
        elif args.cmd == "scaling":
            from cask_tpu_torch.bench.harness import bench_scaling

            bench_scaling(side=args.side, nshards_list=[int(v) for v in args.shards.split(",")],
                          out=out, device=device)
        elif args.cmd == "overlap":
            from cask_tpu_torch.bench.harness import bench_overlap

            bench_overlap(side=args.side, nshards=args.shards, out=out, device=device)
        elif args.cmd == "solve":
            from cask_tpu_torch.bench.harness import bench_solve

            bench_solve(side=args.side, out=out, device=device)
        elif args.cmd == "calibrate":
            from cask_tpu_torch.tune.calibrate import backend_kind, calibrate_poh

            eb = calibrate_poh(force=args.force, device=device)
            print(json.dumps({"op": "calibrate_poh", "backend": backend_kind(device),
                              "equiv_bytes": eb}), file=out, flush=True)
    finally:
        if args.out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
