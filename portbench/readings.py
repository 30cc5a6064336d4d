"""The two readings each correctness limit is set from, for one cell, in one
process on the card:

- the program's: a short window of the cell's own traffic at its own size
  on each of ``--seeds`` (the comparison a run makes, of as many outputs);
- the control's: the plain reference in the precision below the
  configuration's, put in the program's place, on each of ``--control-seeds``.

    python -m portbench.readings --workload <name> --seeds 1,2,3 --control-seeds 4,5,6

Prints one JSON line a seed; the limits in ``portbench/limits/`` lie between
the program's largest reading and the control's smallest.
"""

import argparse
import json
import os
import sys
import time

from portbench.run import CACHES, ROOT


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    for var, rel in CACHES.items():
        os.environ[var] = str(ROOT / rel)

    import torch

    from portbench import harness, spec

    if not torch.cuda.is_available():
        print("readings are taken on a CUDA card", file=sys.stderr)
        return 1
    cell = spec.cell(args.workload)
    log = lambda s: print(s, file=sys.stderr, flush=True)  # noqa: E731
    seeds = [int(s) for s in args.seeds.split(",") if s]
    for seed in seeds:
        run = harness.Run(cell=cell, seed=seed, device=torch.device("cuda"), log=log)
        t0 = time.perf_counter()
        state = cell.entry.setup(run)
        w = cell.entry.window(run, state, args.seconds)
        cell.entry.release(state)
        del state
        numbers = {n: max(v.values()) for n, v in cell.entry.judge(run, w).items()}
        print(json.dumps({"workload": args.workload, "seed": seed, "kind": "program",
                          "calls": w.calls, "numbers": numbers,
                          "seconds": time.perf_counter() - t0}), flush=True)
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        run = harness.Run(cell=cell, seed=seed, device=torch.device("cuda"), log=log)
        t0 = time.perf_counter()
        numbers = {n: max(v.values()) for n, v in cell.entry.control(run).items()}
        print(json.dumps({"workload": args.workload, "seed": seed, "kind": "control",
                          "numbers": numbers, "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
