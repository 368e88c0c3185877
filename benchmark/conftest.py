"""Tests of the benchmark: ``python -m pytest benchmark/ -q``.

Tests marked ``card`` need a CUDA card; they take the ``card`` fixture,
which skips them where there is none (decided when a test runs, never
when a module is imported).  On the card: ``python -m pytest benchmark/
-q -m card``.
"""

import pathlib
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skipped without one)")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    return torch.device("cuda", 0)


def small_cell(name: str, root=None):
    """Cell ``name`` of BENCHMARK.json cut to a size the CPU runs in a
    test: 4 chains of 64 samples, 4 files of 4 batches."""
    from benchmark import harness
    cell = harness.resolve(harness.load_spec(root), name, root)
    cell.config.update(batch=4, samples=64)
    cell.traffic.update(files=4, batches_per_file=4, keep_share=1.0)
    return cell


@pytest.fixture
def run_small():
    """Run a cut cell on the CPU: (name, program, trace) -> result."""
    import io

    import torch

    from benchmark import harness

    def run(name, program="port", trace=False, seed=2 ** 31 + 11,
            seconds=0.3, **traffic):
        """``traffic``: mix parameters that replace the cut cell's."""
        log = io.StringIO()
        cell = small_cell(name)
        cell.traffic.update(traffic)
        res = harness.run_cell(
            harness.Run(cell, seed, torch.device("cpu"), program), seconds,
            trace, log=log)
        return res, log.getvalue()
    return run
