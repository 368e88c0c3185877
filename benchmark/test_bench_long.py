"""The cell ``long-chain-encode`` on the CPU at a small size: the request
kind ``encode_long`` reads the port correct and the control and each
planted fault not correct; the long-stream tier's readers
(``metrics/sp_*.py``) read its spans and counters, and None on a trace
without them; the long kernels' byte counts."""

import sys
import types

import pytest

from benchmark import harness, roofline_long, tracing

CELL = "long-chain-encode"
BROKEN = ["control", "fault.answer_altered", "fault.trailer_wrong",
          "fault.state_unchanged"]
SPAN_METRICS = {"sp_upload_ms": "sp.encode.upload",
                "sp_preprocess_ms": "sp.encode.preprocess",
                "sp_codes_ms": "sp.encode.codes",
                "sp_pack_ms": "sp.encode.pack",
                "sp_checksum_ms": "sp.encode.checksum",
                "sp_fetch_ms": "sp.encode.fetch",
                "sp_update_ms": "sp.chain.update"}
SP = "airs_compression_tpu_torch.parallel.sp"


def small_long_cell(samples=1024, **traffic):
    """The cell with blocks of ``samples`` samples, every answer kept
    unless ``traffic`` says otherwise."""
    cell = harness.resolve(harness.load_spec(), CELL)
    cell.config.update(samples=samples)
    cell.traffic.update({"keep_share": 1.0, **traffic})
    return cell


def _run(program="port", trace=False, seconds=0.5, **traffic):
    import io

    import torch

    log = io.StringIO()
    res = harness.run_cell(
        harness.Run(small_long_cell(**traffic), 2 ** 31 + 29,
                    torch.device("cpu"), program), seconds, trace, log=log)
    return res, log.getvalue()


def test_port_is_correct():
    res, log = _run()
    assert res["correct"], log
    assert res["attempted"] > harness.WARM_REQUESTS
    assert all(c["value"] == 0 == c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("program", BROKEN)
def test_broken_timed_path_is_not_correct(program):
    res, log = _run(program)
    assert not res["correct"], log
    assert res["checks"]["bytes_wrong"]["value"] > 0


@pytest.mark.parametrize("program", ["fault.trailer_wrong",
                                     "fault.answer_altered"])
def test_probes_see_the_header_and_trailer(program):
    """With only the window's first answer kept whole, a flipped trailer
    byte is still seen in every probed answer; a flipped payload byte is
    seen in the kept one."""
    res, log = _run(program, keep_share=0.0)
    assert not res["correct"], log
    wrong = res["checks"]["bytes_wrong"]["value"]
    # every answer of the window is kept or probed
    assert wrong >= (res["attempted"] if program == "fault.trailer_wrong"
                     else 1)


def test_traced_run_reads_the_long_tiers_metrics():
    res, log = _run(trace=True)
    assert res["correct"], log
    got = res["metrics"]
    for name in SPAN_METRICS:
        assert got[name]["value"] > 0, name
        assert got[name]["unit"] == "ms/block"
    # on the CPU no byte crosses to a card: the counters read nothing
    assert "sp_pageable_MiB" not in got


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _view(events, blocks=2):
    return harness.TraceView(tracing.Trace(events), blocks, {}, {}, None)


def _requests():
    return [_x("user_annotation", tracing.REQUEST_SPAN, 0, 100),
            _x("user_annotation", tracing.REQUEST_SPAN, 100, 100),
            _x("kernel", "xxh32_long_kernel", 40, 20)]


def _reader(metric):
    return harness.metric_reader(small_long_cell(), metric)


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_span_reader_sums_over_the_blocks(metric):
    name = SPAN_METRICS[metric]
    view = _view([*_requests(),
                  _x("user_annotation", name, 10, 5),
                  _x("user_annotation", name, 120, 7),
                  _x("user_annotation", name, 250, 9),       # after
                  _x("user_annotation", "sp.encode.other", 30, 50)])
    assert _reader(metric)(view) == pytest.approx(12e-6 / 2 * 1e3)


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_span_reader_without_its_spans_reads_none(metric):
    assert _reader(metric)(_view(_requests())) is None
    assert _reader(metric)(None) is None


def _program(monkeypatch, up=0, fetch=0, blocks=0, counters=True):
    """A stand-in for the long-stream tier's module with its counters,
    or (``counters`` False) without them, as before they existed."""
    mod = types.SimpleNamespace(encoded_blocks=blocks)
    if counters:
        mod._upload = types.SimpleNamespace(pageable_bytes=up)
        mod._fetch = types.SimpleNamespace(pageable_bytes=fetch)
    monkeypatch.setitem(sys.modules, SP, mod)


def test_pageable_reader_is_a_whole_run_ratio(monkeypatch):
    _program(monkeypatch, up=3 * 2 ** 20, fetch=2 ** 20, blocks=2)
    assert _reader("sp_pageable_MiB")(_view(_requests())) == 2.0


@pytest.mark.parametrize("case", ["no_counters", "no_blocks", "no_module",
                                  "no_device_work"])
def test_pageable_reader_without_counters_reads_none(monkeypatch, case):
    view = _view(_requests())
    if case == "no_counters":
        _program(monkeypatch, blocks=3, counters=False)
    elif case == "no_blocks":
        _program(monkeypatch, up=5)
    elif case == "no_module":
        monkeypatch.delitem(sys.modules, SP, raising=False)
    else:
        _program(monkeypatch, up=5, blocks=1)
        view = _view(_requests()[:2])
    assert _reader("sp_pageable_MiB")(view) is None


@pytest.mark.parametrize("metric,family", [("k1_roofline.long", "k1"),
                                           ("k4_roofline.long", "k4")])
def test_long_rooflines_read_their_family(metric, family):
    events = [*_requests(), _x("kernel", "pack_long_kernel<ResidualCodes>",
                               60, 10)]
    view = harness.TraceView(tracing.Trace(events), 1,
                             {family: 33500}, {}, 3.35e12)
    seconds = 10e-6 if family == "k1" else 20e-6
    assert _reader(metric)(view) == pytest.approx(1e-8 / seconds * 100)
    assert _reader(metric)(_view(_requests())) is None


def test_long_kernel_bytes():
    n = 1 << 22
    # 512 rows of 8192 codes; a 3,000,026-byte frame: 22 header bytes, 4
    # trailer bytes, 3,000,000 payload bytes in 750,000 words
    assert roofline_long.k1_long_bytes(3_000_026, n, 22, 4) == \
        4 * n + 4 * 750_000 + 4 * 512
    assert roofline_long.k1_long_bytes(27, 1000, 22, 4) == 4000 + 4 + 4
