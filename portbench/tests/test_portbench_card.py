"""On a card: each cell at its small size comes out correct through the
port's kernels, and its control does not.  Skips without a CUDA card.

    python -m pytest portbench/tests/test_portbench_card.py -m gpu
"""

import pytest
import torch

from portbench import harness, spec
from portbench.tests.tiny import CELLS, run_tiny, tiny_bench


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_card(tmp_path, card, workload):
    bench = tiny_bench(tmp_path)
    before = harness.counters()
    r = run_tiny(bench, workload, device=card, trace=True)
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert harness.moved(before, harness.counters()), "no kernel of the port launched"
    cell = spec.cell(workload, bench)
    run = harness.Run(cell=cell, seed=2 ** 31 + 3, device=torch.device(card), log=print)
    numbers = cell.entry.control(run)
    assert any(max(v.values()) > cell.limits[n]["limit"] for n, v in numbers.items())
