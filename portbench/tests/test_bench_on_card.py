"""The command once, end to end, on a card. Skips where there is none.

    python -m pytest -p no:cacheprovider -m gpu portbench/tests/test_bench_on_card.py
"""

import json
import os
import subprocess
import sys

import pytest
from portbench_tiny import ROOT, SANN_CELL

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the command measures on a card only")


def test_the_command_runs_a_cell(card):
    bench = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    out = subprocess.run([sys.executable, *bench["command"][1:], "--workload", SANN_CELL, "--seed", "2147483659",
                          "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["checks"]
    assert set(result["metrics"]) == {"sann_queries_per_s", "setup_s"}
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert list(result)[-1] == "checks"
