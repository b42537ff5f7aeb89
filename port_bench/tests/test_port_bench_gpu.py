"""On the card: a short run of a cell as the driver starts it is correct and
prints the contract's line. Skips where no CUDA device is present."""

import json
import subprocess
import sys

import pytest
import torch

from port_bench import cells


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
def test_short_run_on_the_card(card, trace):
    out = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", "ks8.ensemble",
         "--seed", "4000000007", "--seconds", "2", "--trace", str(trace)],
        cwd=cells.BENCH_DIR.parent, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert list(line)[-1] == "checks"
