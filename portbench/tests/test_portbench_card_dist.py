"""On four cards: the cell ``fem-dof4-1677m.dist4`` at its small size
through ``portbench/run.py``'s command line, one NCCL rank a card, traced:
one line, every rank correct, four distinct cards, and every per-layer
metric of the cell read from the device trace and the program's counter.
Skips with fewer than four CUDA cards.

    python -m pytest portbench/tests/test_portbench_card_dist.py -m gpu
"""

import json

import pytest
import torch

from portbench import run, spec
from portbench.tests.tiny import tiny_bench

WORKLOAD = "fem-dof4-1677m.dist4"


@pytest.fixture
def four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")


@pytest.mark.gpu
def test_dist_cell_on_four_cards(tmp_path, four_cards, capsys):
    bench = tiny_bench(tmp_path)
    code = run.main(["--workload", WORKLOAD, "--seed", str(2 ** 31 + 41), "--seconds", "1",
                     "--trace", "1"], bench=bench)
    out = capsys.readouterr()
    assert code == 0, out.err[-3000:]
    line = json.loads(out.out.splitlines()[-1])
    assert line["correct"] is True and line["device"]["count"] == 4
    assert line["device"]["platform"] == "gpu"
    wanted = {m["name"] for m in spec.cell(WORKLOAD, bench).per_layer}
    assert set(line["metrics"]) == wanted
    assert 0 < line["metrics"]["kernel_roofline.dist"]["value"] <= 105
    assert line["metrics"]["dist.fixup_us_per_call"]["value"] > 0
    assert line["metrics"]["dist.exchange_exposed_us_per_call"]["value"] >= 0
