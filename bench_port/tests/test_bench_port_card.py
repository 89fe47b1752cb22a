"""On the card: a short run of each cell prints the contract's line, with
``correct`` true.  Run on the GPU machine with
``python -m pytest -m cuda bench_port/tests``; skips elsewhere."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
from conftest import CELLS, ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_short_run_on_the_card(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run([sys.executable, "bench_port/run.py", "--workload", name, "--seed",
                           "2147483700", "--seconds", "2", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, result["check"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert list(result)[-1] == "check"
