"""The configuration ``adaptive_chain_cs`` under ``encode_adaptive_chain``
on the CPU at a small size: the request kind ``encode_adaptive`` reads the
port correct and the control and each planted fault (``fault.fixed_param``
among them) not correct; it refuses an environment that makes the program
choose otherwise than the configuration; K2's byte count against a count
from the codes; the adaptive tier's readers (``metrics/adapt_*.py``,
``k2_roofline``) read their spans, counters and kernels, and None on a run
without them.
"""

import io
import sys
import types

import numpy as np
import pytest
import torch

from benchmark import harness, roofline_k2, tracing
from benchmark.conftest import small_cell
from benchmark.kinds import encode_adaptive

CELL = "adaptive-chain-encode"
CONFIG = "adaptive_chain_cs"
TRAFFIC = "encode_adaptive_chain"
#: the end-to-end metrics of an encode cell
END_TO_END = ("encode_GBps", "encode_p95_ms", "setup_s")
#: the per-layer metrics the cell reads, with their units
PER_LAYER = {"k2_roofline": "%", "adapt_select_ms": "ms/batch",
             "adapt_codes_ms": "ms/batch", "adapt_candidates": "columns/block",
             "torch_ops_ms.encode": "ms/batch",
             "launches.encode": "launches/batch",
             "dispatch_ms.encode": "ms/batch", "upload_ms.encode": "ms/batch",
             "fetch_ms.encode": "ms/batch", "copy_ms.encode": "ms/batch",
             "pageable_MiB.encode": "MiB/batch", "k4_roofline": "%",
             "k5_roofline": "%", "device_idle_pct.encode": "%"}
BROKEN = ["control", "fault.answer_altered", "fault.half_batch",
          "fault.state_unchanged", "fault.fixed_param"]
SPAN_METRICS = {"adapt_select_ms": "adapt.select",
                "adapt_codes_ms": "adapt.codewords"}
ADAPT = "airs_compression_tpu_torch.ops.adapt"


def adaptive_cell(small: bool = True) -> harness.Cell:
    """The cell as ``BENCHMARK.json`` lists it; ``small`` cuts it as
    ``conftest.small_cell`` does: 4 chains of 64 samples, 4 files of 4
    batches, every file kept."""
    return small_cell(CELL) if small else harness.resolve(
        harness.load_spec(), CELL)


def run_small(program="port", trace=False, seed=2 ** 31 + 11, seconds=0.3):
    """Run the cut cell on the CPU: (result, log)."""
    log = io.StringIO()
    res = harness.run_cell(
        harness.Run(adaptive_cell(), seed, torch.device("cpu"), program),
        seconds, trace, log=log)
    return res, log.getvalue()


def test_port_is_correct():
    res, log = run_small()
    assert res["correct"], log
    assert res["attempted"] > harness.WARM_REQUESTS
    assert all(c["value"] == 0 == c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("program", BROKEN)
def test_broken_timed_path_is_not_correct(program):
    res, log = run_small(program)
    assert not res["correct"], log
    assert res["checks"]["bytes_wrong"]["value"] > 0


def test_traced_run_reads_the_adaptive_tiers_metrics():
    res, log = run_small(trace=True)
    assert res["correct"], log
    got = res["metrics"]
    for name in [*SPAN_METRICS, "dispatch_ms.encode", "upload_ms.encode",
                 "fetch_ms.encode"]:
        assert got[name]["value"] > 0, name
        assert got[name]["unit"] == "ms/batch"
    assert got["adapt_candidates"]["value"] == 6.0
    # no kernel runs on the CPU: the device's metrics read nothing
    for name in ("k2_roofline", "k4_roofline", "k5_roofline",
                 "launches.encode", "torch_ops_ms.encode", "copy_ms.encode",
                 "pageable_MiB.encode", "device_idle_pct.encode"):
        assert name not in got, name


def test_cell_runs_the_configurations_choice():
    cell = adaptive_cell(small=False)
    assert (cell.config["name"], cell.chips) == (CONFIG, 1)
    listed = [w for w in harness.load_spec()["workloads"]
              if w["name"] == CELL]
    assert [(w["config"], w["traffic"]) for w in listed] == [
        (CONFIG, TRAFFIC)]
    assert [m["name"] for m in cell.end_to_end] == list(END_TO_END)
    assert {m["name"]: m["unit"] for m in cell.per_layer} == PER_LAYER
    from airs_compression_tpu_torch.ops.adapt import DEFAULT_LADDER
    assert tuple(cell.config["adaptive"]["ladder"]) == DEFAULT_LADDER
    assert cell.config["adaptive"]["select"] == "fast"
    assert cell.config["adaptive"]["window"] == 2
    assert cell.config["reduced"] == []
    assert (cell.config["batch"], cell.config["samples"]) == (512, 8192)
    # the pool is one chain cycle, four files of four batches
    assert (cell.traffic["files"], cell.traffic["batches_per_file"]) == (4, 4)
    assert cell.traffic["files"] * cell.traffic["batches_per_file"] == \
        1 + cell.config["params"]["secondary_iterations"]


@pytest.mark.parametrize("env", [
    {"AIRS_ADAPTIVE_SELECT": "exact"},
    {"AIRS_ADAPTIVE_WINDOW": "3"},
    {"AIRS_ADAPTIVE_WINDOW": "0"},
    {"AIRS_ADAPTIVE_WINDOW": "two"},
    {"AIRS_ADAPTIVE_SELECT": "fast", "AIRS_ADAPTIVE_WINDOW": "1"},
])
def test_kind_refuses_another_choice(monkeypatch, env):
    for var in encode_adaptive.SWITCHES:
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    run = harness.Run(adaptive_cell(), 5, torch.device("cpu"))
    with pytest.raises(ValueError, match="unset AIRS_ADAPTIVE_"):
        encode_adaptive.Work(run)


@pytest.mark.parametrize("env", [
    {}, {"AIRS_ADAPTIVE_SELECT": "fast"}, {"AIRS_ADAPTIVE_WINDOW": "2"},
    {"AIRS_ADAPTIVE_SELECT": "fast", "AIRS_ADAPTIVE_WINDOW": "2"},
])
def test_kind_takes_the_configurations_choice(env):
    encode_adaptive.check_environment({"select": "fast", "window": 2}, env)


def test_exact_choice_has_no_window():
    encode_adaptive.check_environment(
        {"select": "exact", "window": 2},
        {"AIRS_ADAPTIVE_SELECT": "exact", "AIRS_ADAPTIVE_WINDOW": "5"})
    with pytest.raises(ValueError):
        encode_adaptive.check_environment({"select": "exact", "window": 2},
                                          {})


def test_k2_bytes_by_hand():
    # two frames of 22 header + 5 and 9 payload + 4 trailer bytes: 2 and
    # 3 payload words; 3 codes a row
    sizes = [31, 35]
    assert roofline_k2.k2_bytes(sizes, 3, 22, 4, multi=False) == \
        2 * 4 * 2 * 3 + 4 * 5 + 4 * 2
    assert roofline_k2.k2_bytes(sizes, 3, 22, 4, multi=True) == \
        3 * 4 * 2 * 3 + 4 * 5 + 4 * 2


@pytest.mark.parametrize("encoder", ["GOLOMB_ZERO", "GOLOMB_MULTI"])
def test_k2_bytes_count_the_codes_words(encoder):
    """On one tiny batch the payload words from the frame sizes are those
    the chosen codes fill: a count from the codes' lengths."""
    import airs_compression_tpu_torch as tx
    from airs_compression_tpu_torch.ops import adapt, preprocess

    B, N = 3, 40
    rng = np.random.default_rng(4)
    x = (1100 + rng.normal(0, 1, (B, N)) * np.array([1, 9, 300])[:, None]
         ).astype(np.uint16)
    multi = encoder == "GOLOMB_MULTI"
    params = tx.CmpParams(primary_preprocessing=tx.Preprocessing.DIFF,
                          primary_encoder_type=tx.EncoderType[encoder],
                          primary_encoder_param=2,
                          primary_encoder_outlier=40 if multi else 0,
                          checksum_enabled=True)
    bc = tx.BatchCompressor(params, B, N, adaptive=True, device="cpu")
    _, sizes = bc.compress_frames_packed(x)
    r = preprocess.preprocess_forward(
        1, torch.from_numpy(x.view(np.int16)).to(torch.int32), None)
    if multi:
        g, out, _ = adapt.select_golomb_multi(r, 40)
        _, _, lens = adapt.encode_codewords_dynamic_multi(r, g, out)
    else:
        g, _ = adapt.select_golomb_zero(r)
        _, _, lens = adapt.encode_codewords_dynamic(r, g)
    words = int(((lens.sum(1) + 31) // 32).sum())
    arrays = 3 if multi else 2
    assert roofline_k2.k2_bytes(sizes, N, 22, 4, multi) == \
        4 * arrays * B * N + 4 * words + 4 * B


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _view(events, batches=2, kbytes=None, hbm=None):
    return harness.TraceView(tracing.Trace(events), batches, kbytes or {},
                             {}, hbm)


def _requests():
    return [_x("user_annotation", tracing.REQUEST_SPAN, 0, 100),
            _x("user_annotation", tracing.REQUEST_SPAN, 100, 100),
            _x("kernel", "xxh32_blocks_kernel", 40, 20)]


def _reader(metric):
    return harness.metric_reader(adaptive_cell(), metric)


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_span_reader_sums_over_the_batches(metric):
    name = SPAN_METRICS[metric]
    view = _view([*_requests(),
                  _x("user_annotation", name, 10, 5),
                  _x("user_annotation", name, 120, 7),
                  _x("user_annotation", name, 250, 9),       # after
                  _x("user_annotation", "adapt.other", 30, 50)])
    assert _reader(metric)(view) == pytest.approx(12e-6 / 2 * 1e3)


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_span_reader_without_its_spans_reads_none(metric):
    assert _reader(metric)(_view(_requests())) is None
    assert _reader(metric)(None) is None


def _program(monkeypatch, blocks=0, costed=0, counters=True):
    """A stand-in for ops/adapt.py with its counters, or (``counters``
    False) without them, as before they existed."""
    mod = types.SimpleNamespace()
    if counters:
        mod.selected_blocks = blocks
        mod.costed_candidates = costed
    monkeypatch.setitem(sys.modules, ADAPT, mod)


def test_candidates_reader_is_a_whole_run_ratio(monkeypatch):
    _program(monkeypatch, blocks=3 * 512, costed=3 * 512 * 6)
    assert _reader("adapt_candidates")(_view(_requests())) == 6.0
    _program(monkeypatch, blocks=4, costed=4 * 21)
    assert _reader("adapt_candidates")(None) == 21.0


@pytest.mark.parametrize("case", ["no_counters", "no_blocks", "no_module"])
def test_candidates_reader_without_counters_reads_none(monkeypatch, case):
    if case == "no_counters":
        _program(monkeypatch, counters=False)
    elif case == "no_blocks":
        _program(monkeypatch, costed=6)
    else:
        monkeypatch.delitem(sys.modules, ADAPT, raising=False)
    assert _reader("adapt_candidates")(_view(_requests())) is None


def test_k2_roofline_reads_its_family():
    events = [*_requests(), _x("kernel", "pack_codes_kernel<LoadedCodes>",
                               60, 10)]
    view = _view(events, 1, {"k2": 33500}, 3.35e12)
    assert _reader("k2_roofline")(view) == pytest.approx(1e-8 / 10e-6 * 100)
    assert _reader("k2_roofline")(_view(_requests(), 1, {"k2": 33500},
                                        3.35e12)) is None
