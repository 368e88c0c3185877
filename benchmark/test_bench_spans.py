"""The readers of the program's spans and transfer counters
(benchmark/spans.py, metrics/*_ms.py of the batch tier's stages,
metrics/pageable_MiB.py) on hand-built traces and counters."""

import sys
import types

import pytest

from benchmark import harness, spans, tracing
from benchmark.conftest import small_cell

SPAN_METRICS = {"upload_ms.decode": "stream.upload",
                "stage_ms.decode": "stream.stage",
                "dispatch_ms.encode": "stream.dispatch",
                "fetch_ms.decode": "stream.fetch",
                "cast_ms.decode": "stream.cast"}


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _view(events, batches=2):
    return harness.TraceView(tracing.Trace(events), batches, {}, {}, None)


def _requests():
    return [_x("user_annotation", tracing.REQUEST_SPAN, 0, 100),
            _x("user_annotation", tracing.REQUEST_SPAN, 100, 100),
            _x("kernel", "decode_blocks_kernel<1>", 40, 20)]


def _reader(metric):
    cell = small_cell("flagship-encode" if metric.endswith(".encode")
                      else "headline-decode")
    return harness.metric_reader(cell, metric)


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_span_reader_sums_over_the_batches(metric):
    name = SPAN_METRICS[metric]
    view = _view([*_requests(),
                  _x("user_annotation", name, 10, 5),
                  _x("user_annotation", name, 120, 7),
                  # another stage, and a device record of the same name
                  _x("user_annotation", "stream.other", 30, 50),
                  _x("gpu_user_annotation", name, 10, 90)])
    assert _reader(metric)(view) == pytest.approx(12e-6 / 2 * 1e3)


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_span_reader_leaves_out_spans_outside_the_requests(metric):
    name = SPAN_METRICS[metric]
    view = _view([*_requests(),
                  _x("user_annotation", name, -50, 20),      # before
                  _x("user_annotation", name, 50, 10),
                  _x("user_annotation", name, 250, 20)],     # after
                 batches=4)
    assert _reader(metric)(view) == pytest.approx(10e-6 / 4 * 1e3)


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_span_reader_without_spans_reads_none(metric):
    assert _reader(metric)(_view(_requests())) is None
    assert _reader(metric)(None) is None


def _program(monkeypatch, pageable=(0, 0), encoded=0, decoded=0):
    """A stand-in for the batch tier's module with its counters."""
    up = types.SimpleNamespace(pageable_bytes=pageable[0])
    fetch = types.SimpleNamespace(pageable_bytes=pageable[1])
    mod = types.SimpleNamespace(_upload=up, _fetch=fetch,
                                encoded_batches=encoded,
                                decoded_batches=decoded)
    monkeypatch.setitem(sys.modules, spans.STREAM, mod)


@pytest.mark.parametrize("metric", ["pageable_MiB.decode",
                                    "pageable_MiB.encode"])
def test_pageable_mib_over_the_programs_batches(metric, monkeypatch):
    _program(monkeypatch, pageable=(3 << 20, 16 << 20), decoded=2,
             encoded=0)
    assert _reader(metric)(_view(_requests())) == pytest.approx(9.5)


@pytest.mark.parametrize("metric", ["pageable_MiB.decode",
                                    "pageable_MiB.encode"])
def test_pageable_mib_without_the_program_reads_none(metric, monkeypatch):
    view = _view(_requests())
    monkeypatch.delitem(sys.modules, spans.STREAM, raising=False)
    assert _reader(metric)(view) is None
    # a program that keeps no transfer counters (an older batch tier)
    monkeypatch.setitem(sys.modules, spans.STREAM, types.ModuleType("old"))
    assert _reader(metric)(view) is None
    # no batch counted, or a trace with no device work
    _program(monkeypatch)
    assert _reader(metric)(view) is None
    _program(monkeypatch, pageable=(1, 1), encoded=1)
    assert _reader(metric)(_view(_requests()[:2])) is None
