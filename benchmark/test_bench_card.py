"""On the card: each cell runs through its command and reads correct,
and its control, at the cell's own size, reads not correct.  Skipped
without a CUDA card; ``python -m pytest benchmark/ -q -m card``."""

import json
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.conftest import ROOT

CELLS = [w["name"] for w in harness.load_spec()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct(card, name, trace):
    proc = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", name, "--seed",
         "2147483701", "--seconds", "4", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"], proc.stderr[-3000:]
    assert res["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cells_size(card, name):
    proc = subprocess.run(
        [sys.executable, "benchmark/control.py", "--workload", name,
         "--seconds", "2", "--seeds", "3", "4", "5", "--programs",
         "control"], cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    runs = [json.loads(line) for line in proc.stdout.strip().splitlines()]
    assert len(runs) == 3 and not any(r["correct"] for r in runs)
