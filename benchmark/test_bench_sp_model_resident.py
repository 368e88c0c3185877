"""The reader ``metrics/sp_model_resident_share.py`` on the CPU: the cell
``long-chain-encode`` at a small size reads every MODEL block's model as
resident on the device; the reader gives the counters' ratio on a
stand-in module, and None on a module without the counters, with no
MODEL block, or with no module at all."""

import sys
import types

import pytest

from benchmark.test_bench_long import SP, _reader, _requests, _run, _view

METRIC = "sp_model_resident_share"


def test_traced_run_reads_every_model_block_resident():
    res, log = _run(trace=True)
    assert res["correct"], log
    assert res["metrics"][METRIC] == {"value": 1.0, "unit": "share"}


def _model_counters(monkeypatch, **counters):
    """A stand-in for the long-stream tier's module with the given MODEL
    block counters (none: as before they existed)."""
    monkeypatch.setitem(sys.modules, SP, types.SimpleNamespace(**counters))


def test_reader_is_a_whole_run_ratio(monkeypatch):
    _model_counters(monkeypatch, model_blocks=8, model_resident_blocks=6)
    assert _reader(METRIC)(_view(_requests())) == 0.75


@pytest.mark.parametrize("case", ["no_counters", "no_blocks", "no_module"])
def test_reader_without_counters_reads_none(monkeypatch, case):
    if case == "no_counters":
        _model_counters(monkeypatch, encoded_blocks=3)
    elif case == "no_blocks":
        _model_counters(monkeypatch, model_blocks=0, model_resident_blocks=0)
    else:
        monkeypatch.delitem(sys.modules, SP, raising=False)
    assert _reader(METRIC)(_view(_requests())) is None
