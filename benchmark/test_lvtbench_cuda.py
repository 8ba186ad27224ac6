"""On the card (``python -m pytest benchmark -m cuda`` on a machine with
one): each cell runs once, short, from the command line, with ``correct``
true."""

import json
import subprocess
import sys

import pytest
import torch

from lvtbench import cells

ROOT = cells.REPO


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in cells.load_benchmark()["workloads"]])
def test_cell_runs_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                        "2147483999", "--seconds", "3", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["failed"] == 0, out["checks"]
