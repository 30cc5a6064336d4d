"""The control, the plain reference in the precision below the
configuration's put in the program's place, comes out not correct under
each cell's limits, at the configurations' small sizes; the program comes
out correct.  (On the card, at the cells' own sizes:
``python -m portbench.readings``.)"""

import pytest
import torch

from portbench import harness, spec
from portbench.tests.tiny import CELLS, run_tiny, tiny_bench


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11, 2 ** 33 + 1])
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails(tmp_path, workload, seed):
    cell = spec.cell(workload, tiny_bench(tmp_path))
    run = harness.Run(cell=cell, seed=seed, device=torch.device("cpu"), log=lambda s: None)
    numbers = cell.entry.control(run)
    over = [n for n, v in numbers.items() if max(v.values()) > cell.limits[n]["limit"]]
    assert over, numbers


@pytest.mark.parametrize("workload", CELLS)
def test_program_passes(tmp_path, workload):
    assert run_tiny(tiny_bench(tmp_path), workload, seed=2 ** 32 + 17)["correct"]
