"""On cards: the ranks of :mod:`portbench.tests.ring` join over NCCL through
``portbench/run.py``'s own command line, one a card, and its line counts
the distinct cards they used; asking for more cards than the machine holds
prints nothing.  Skips without a CUDA card.

    python -m pytest portbench/tests/test_portbench_card_ranks.py -m gpu
"""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

from portbench import spec


@pytest.fixture
def cards():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.cuda.device_count()


def _ring(tmp_path, ranks, *args):
    return subprocess.run([sys.executable, "-m", "portbench.tests.ring", "--dir", str(tmp_path),
                           "--ranks", str(ranks), "--device", "cuda", *args], cwd=spec.ROOT,
                          env=dict(os.environ), capture_output=True, text=True, timeout=600)


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_ranks_on_distinct_cards(tmp_path, cards, trace):
    if cards < 2:
        pytest.skip("one card: test_more_chips_than_cards_prints_nothing runs on it instead")
    ranks = min(4, cards)
    out = _ring(tmp_path, ranks, "--trace", str(trace))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
    assert line["device"]["count"] == ranks
    uuids = re.findall(r"\[rank \d\] card (\S+) \(", out.stderr)
    assert len(uuids) == ranks and len(set(uuids)) == ranks
    assert line["device"]["kind"] == torch.cuda.get_device_name(0)
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.gpu
def test_more_chips_than_cards_prints_nothing(tmp_path, cards):
    out = _ring(tmp_path, cards + 1)
    assert out.returncode == 1 and out.stdout == ""
    assert f"needs {cards + 1} CUDA card(s)" in out.stderr
