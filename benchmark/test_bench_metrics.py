"""The yardstick on known inputs: kernel byte counts, the trace reading
and the per-layer readers."""

import numpy as np
import pytest

from benchmark import harness, roofline, tracing
from benchmark.conftest import small_cell


def test_k1_bytes_counts_the_words_the_payload_fills():
    # two rows of 8 samples: residuals 2 * 8 * 4, payload words of
    # (30 - 22 - 4) = 4 bytes -> 1 word and (31 - 26) = 5 bytes -> 2
    # words, a bit count a row
    assert roofline.k1_bytes([30, 31], 8, 22, 4) == 64 + 4 * 3 + 8


def test_k3_bytes():
    assert roofline.k3_bytes([100, 101, 102], 16) == \
        303 + 8 * 3 + 4 * 16 * 3 + 4 * 3


def test_k4_and_k5_bytes():
    assert roofline.k4_bytes(512, 8192) == 4 * 512 * 8192 + 4 * 512
    # frames of 9 and 4 bytes lie in 3 + 1 int64 words
    assert roofline.k5_bytes([9, 4]) == 4 * 8 + 8 + 13


@pytest.mark.parametrize("name,family", [
    ("void (anonymous namespace)::pack_kernel<(anonymous namespace)::"
     "ResidualCodes<1> >(...)", "k1"),
    ("void pack_long_kernel<(anonymous namespace)::LoadedCodes<2> >", "k2"),
    ("void decode_blocks_kernel<1, false>(unsigned int const*)", "k3"),
    ("decode_windows_kernel<2, 1>", "k3"),
    ("xxh32_blocks_kernel(int const*, int, int)", "k4"),
    ("assemble_kernel<long>", "k5"),
    ("void at::native::vectorized_elementwise_kernel<4>", None),
])
def test_family_of(name, family):
    assert roofline.family_of(name) == family


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _trace():
    return tracing.Trace([
        _x("user_annotation", tracing.REQUEST_SPAN, 0, 100),
        _x("user_annotation", tracing.REQUEST_SPAN, 100, 100),
        _x("cpu_op", "aten::to", 0, 30),
        _x("cuda_runtime", "cudaMemcpyAsync", 5, 20),
        _x("cpu_op", "finish", 150, 50),
        _x("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 10, 10),
        _x("kernel", "decode_blocks_kernel<1>", 40, 20),
        _x("kernel", "void at::native::copy_kernel", 50, 20),   # overlaps
        _x("gpu_memset", "Memset (Device)", 120, 10),
        _x("kernel", "before the window", -50, 20),
    ])


def test_trace_busy_idle_and_counts():
    t = _trace()
    assert t.requests == 2 and t.window_s == pytest.approx(200e-6)
    # busy: [10, 20), [40, 70), [120, 130) -> 50 us
    assert t.busy_s() == pytest.approx(50e-6)
    assert t.count("kernel", family="k3") == 1
    assert t.count("kernel", others=True) == 2
    assert t.device_s("kernel", family="k3") == pytest.approx(20e-6)
    assert t.device_s("gpu_memcpy") == pytest.approx(10e-6)
    gaps = dict(t.idle_gaps())
    assert sum(gaps.values()) == pytest.approx(150e-6)
    # [0, 10): the runtime call 5..25 overlaps half, aten::to all of it
    assert gaps["aten::to"] == pytest.approx(30e-6)       # [0,10) + [20,40)
    # a whole gap goes to one record: [130, 200) to finish (150..200)
    assert gaps["finish"] == pytest.approx(70e-6)
    assert gaps["host: no traced operation"] == pytest.approx(50e-6)
    ops = dict(t.device_ops())
    assert ops["decode_blocks_kernel<1>"] == pytest.approx(20e-6)


def _view(**kw):
    base = dict(trace=_trace(), batches=2, kernel_bytes={"k3": 33500},
                launches={"k3": 1}, hbm_bytes_per_s=3.35e12)
    base.update(kw)
    return harness.TraceView(**base)


def test_readers():
    cell = small_cell("headline-decode")
    read = {m: harness.metric_reader(cell, m) for m in (
        "copy_ms.decode", "torch_ops_ms.decode", "launches.decode",
        "k3_roofline", "device_idle_pct.decode")}
    v = _view()
    assert read["copy_ms.decode"](v) == pytest.approx(10e-6 / 2 * 1e3)
    # the kernel before the window counts: it is in the traced requests
    assert read["torch_ops_ms.decode"](v) == pytest.approx(40e-6 / 2 * 1e3)
    assert read["launches.decode"](v) == 1.5
    # 33500 bytes at 3.35e12 B/s: 1e-8 s against 20e-6 s -> 0.05 %
    assert read["k3_roofline"](v) == pytest.approx(0.05)
    assert read["device_idle_pct.decode"](v) == pytest.approx(75.0)


def test_readers_with_nothing_to_read_return_none():
    cell = small_cell("flagship-encode")
    empty = _view(trace=tracing.Trace([]), kernel_bytes={})
    for m in cell.per_layer:
        assert harness.metric_reader(cell, m["name"])(empty) is None, m
    assert roofline.share(_view(hbm_bytes_per_s=None), "k3") is None


def test_window_metrics():
    lat = list(np.linspace(0.01, 0.2, 20))
    assert harness.window_metric("decode_GBps", 1, 2.0, 4e9, lat) == 2.0
    assert harness.window_metric("setup_s", 7.5, 2.0, 0, lat) == 7.5
    assert harness.window_metric("encode_p95_ms", 0, 1, 0, lat) == \
        pytest.approx(np.percentile(lat, 95) * 1e3)
    with pytest.raises(KeyError):
        harness.window_metric("ratio", 0, 1, 0, lat)
