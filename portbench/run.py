"""Run one cell of the port's benchmark once, on the card this process sees.

    python -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the compared numbers beside their
limits on standard error, then one JSON line on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, ``built`` (the kernel libraries this run compiled), and
``checks`` last.  A cell of more than one chip runs as one process a
card (``portbench/ranks.py``) and prints one line for all its ranks.
Exits non-zero, printing no result, without a CUDA card, with fewer cards
than the cell asks for, when a rank fails, outlives its limit or shares a
card with another, or when JAX, Flax or the JAX package is loaded once the
window has closed.
"""

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# The port's compile caches live at fixed places inside the checkout, so
# that only a checkout's first run of a cell compiles.
CACHES = {"CASK_TPU_TORCH_BUILD_DIR": "build/portbench/kernels",
          "TRITON_CACHE_DIR": "build/portbench/triton",
          "TORCH_EXTENSIONS_DIR": "build/portbench/torch_extensions"}


def _log(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def _card() -> str:
    """Each card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return "; ".join(out.stdout.strip().splitlines()) if out.stdout.strip() else out.stderr.strip()


def main(argv=None, *, bench=None, cells="portbench.spec:cell") -> int:
    """The command line.  ``bench`` stands in for ``BENCHMARK.json`` and
    ``cells`` names the function that finds a cell's parts (the tests'
    cells are found elsewhere)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, rel in CACHES.items():
        os.environ[var] = str(ROOT / rel)

    import torch

    marks = {"torch": time.perf_counter()}
    from portbench import harness, ranks, spec

    bench = bench or spec.load_benchmark()
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(args.workload)
    if chips is None:
        _log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _log(f"{args.workload} needs {chips} CUDA card(s); torch sees "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 1
    if chips > 1:  # the ranks make their own contexts, one a card
        result = ranks.run(args.workload, args.seed, args.seconds, bool(args.trace),
                           chips=chips, t_start=T_START, bench=bench, marks=marks, log=_log,
                           cells=cells)
        return 1 if result is None else emit(result)
    torch.cuda.init()
    marks["cuda"] = time.perf_counter()
    try:
        import cask_tpu_torch  # noqa: F401
    except ImportError as e:
        _log(f"the port is not importable from {ROOT}: {e}")
        return 1
    marks["port"] = time.perf_counter()

    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              t_start=T_START, device="cuda", log=_log, bench=bench,
                              marks=marks, cells=cells)
    return emit(result)


def emit(result: dict) -> int:
    """Print ``result`` as the run's last line, its checks the last lines on
    standard error, unless this process holds JAX or the JAX package."""
    from portbench import harness

    found = harness.forbidden_modules()
    if found:
        _log(f"JAX or the JAX package is loaded in this process: {found}")
        return 3
    _log(f"[card] {_card()}")
    _log(f"[result] attempted {result['attempted']}, failed {result['failed']}, "
         f"correct {result['correct']}")
    for name, c in result["checks"].items():
        _log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
