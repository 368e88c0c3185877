"""The batch tier's spans and transfer counters (models/stream.py).

Under ``torch.profiler`` one ``compress_frames_packed`` opens the flat
spans ``stream.upload``, ``stream.dispatch``, ``stream.fetch``,
``stream.dispatch``, ``stream.fetch``; ``decompress_file_stream`` opens
``stream.upload`` once, then a ``stream.stage`` a window, a
``stream.dispatch`` a launch and a ``stream.fetch`` and ``stream.cast``
a window, in the order its pipeline runs them.  No two spans overlap.
An adaptive encode (ops/adapt.py) opens ``adapt.select`` and
``adapt.codewords`` inside its ``stream.dispatch``, and counts the blocks
it chose for and the candidates it costed.  Without a profiler ``span``
is one shared null context.  Every copy goes
through ``_upload`` or ``_fetch``, which count pageable bytes only where
a CUDA device is one side of the copy.

The tests marked ``card`` decode files on the card: one holds the counted
bytes to the sizes of the copies, the other holds the decode's fetch to
the narrowed samples' bytes, its answers to the CPU's and its arrays to
their owners; they skip without a card.  On the card: ``python -m pytest
tests/test_torch_tracing.py -m card --noconftest -q`` (this file imports
no JAX).
"""

import contextlib

import numpy as np
import pytest
import torch

import airs_compression_tpu_torch as tx
from airs_compression_tpu_torch.models import stream as tstream
from airs_compression_tpu_torch.ops import adapt as tadapt
from airs_compression_tpu_torch.utils.profiling import range_times, span

HEADLINE = dict(primary_preprocessing=tx.Preprocessing.DIFF,
                primary_encoder_type=tx.EncoderType.GOLOMB_ZERO,
                primary_encoder_param=4)
FLAGSHIP = dict(HEADLINE, secondary_iterations=15,
                secondary_preprocessing=tx.Preprocessing.MODEL,
                secondary_encoder_type=tx.EncoderType.GOLOMB_MULTI,
                secondary_encoder_param=2, secondary_encoder_outlier=40,
                model_rate=8, checksum_enabled=True)
CONFIGS = {"headline": HEADLINE, "flagship": FLAGSHIP}


def _frames(seed, batches, b, n):
    rng = np.random.default_rng(seed)
    return (1100 + rng.normal(0, 6, (batches, b, n))).astype(np.uint16)


def _file(params, frames, device):
    """The packed streams of ``frames`` one after another, with their
    frame offsets and lengths."""
    bc = tx.BatchCompressor(tx.CmpParams(**params), frames.shape[1],
                            frames.shape[2], device=device)
    streams, lens = [], []
    for f in frames:
        s, z = bc.compress_frames_packed(f, as_array=True)
        streams.append(s)
        lens.append(z.astype(np.int64))
    lens = np.concatenate(lens)
    return np.concatenate(streams).tobytes(), np.cumsum(lens) - lens, lens


def _spans(prof):
    """The ``stream.*`` spans of a finished profile: (name, start, end)
    in the order they started."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.name.startswith("stream.")), key=lambda r: r[1])


def _profile(fn):
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
    return prof, out


HELPERS = (tstream._upload, tstream._fetch)


def _counters():
    return {h.__name__: h.pageable_bytes for h in HELPERS}


@pytest.mark.parametrize("name", ["stream.upload", "sp.encode.upload"])
def test_span_is_one_shared_null_context_without_a_profiler(name):
    assert not torch.autograd._profiler_enabled()
    first, second = span(name), span(name)
    assert first is second
    assert isinstance(first, contextlib.nullcontext)
    with first:
        pass
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        on = span(name)
        assert on is not first
        with on:
            torch.ones(4).sum()
    assert range_times(prof, name)[name]["calls"] == 1


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("packed", [True, False])
def test_encode_spans(config, packed):
    """One encode call: upload, dispatch, fetch, then the frames'
    dispatch (K5, or the byte order of the list path) and fetch; the
    spans do not overlap."""
    frames = _frames(5, 2, 4, 64)
    bc = tx.BatchCompressor(tx.CmpParams(**CONFIGS[config]), 4, 64,
                            device="cpu")
    bc.compress_frames_packed(frames[0])
    call = bc.compress_frames_packed if packed else bc.compress_frames
    prof, _ = _profile(lambda: call(frames[1]))
    spans = _spans(prof)
    assert [s[0] for s in spans] == [
        "stream.upload", "stream.dispatch", "stream.fetch",
        "stream.dispatch", "stream.fetch"]
    for (_, _, end), (_, start, _) in zip(spans, spans[1:]):
        assert end <= start


S, D, F, C = "stream.stage", "stream.dispatch", "stream.fetch", "stream.cast"


@pytest.mark.parametrize("coalesce,windows,order", [
    # one launch a window; a window is finished once the next is queued
    (False, 3, [S, D, S, D, F, C, S, D, F, C, F, C]),
    # two windows a launch; the first launch's windows are finished once
    # the second launch is queued
    (2, 4, [S, S, D, S, S, D, F, C, F, C, F, C, F, C]),
    # the default: every window of the file in one launch
    (None, 3, [S, S, S, D, F, C, F, C, F, C]),
])
def test_decode_spans(coalesce, windows, order):
    data, offsets, lens = _file(HEADLINE, _frames(7, windows, 4, 64), "cpu")
    bd = tx.BatchDecompressor(tx.CmpParams(**HEADLINE), 4, 64, device="cpu")
    prof, out = _profile(lambda: list(bd.decompress_file_stream(
        data, offsets, lens, coalesce=coalesce)))
    assert len(out) == windows
    spans = _spans(prof)
    assert [s[0] for s in spans] == ["stream.upload", *order]
    for (_, _, end), (_, start, _) in zip(spans, spans[1:]):
        assert end <= start


def test_adaptive_encode_spans():
    """An adaptive encode chooses in one ``adapt.select`` and makes its
    codewords in one ``adapt.codewords``, in that order, both inside the
    encode's first ``stream.dispatch``."""
    frames = _frames(6, 2, 4, 64)
    bc = tx.BatchCompressor(tx.CmpParams(**FLAGSHIP), 4, 64, adaptive=True,
                            device="cpu")
    bc.compress_frames_packed(frames[0])
    prof, _ = _profile(lambda: bc.compress_frames_packed(frames[1]))
    spans = sorted(((e.name, e.time_range.start, e.time_range.end)
                    for e in prof.events()
                    if e.name.startswith(("adapt.", "stream.dispatch"))),
                   key=lambda r: r[1])
    assert [s[0] for s in spans] == ["stream.dispatch", "adapt.select",
                                     "adapt.codewords", "stream.dispatch"]
    (_, a, b), (_, s0, s1), (_, c0, c1) = spans[:3]
    assert a <= s0 <= s1 <= c0 <= c1 <= b


@pytest.mark.parametrize("select,columns", [("fast", 6), ("exact", 21)])
def test_adaptive_counters_without_a_profiler(select, columns, monkeypatch):
    """Without a profiler no span object is made, and each pass adds its
    B blocks to ``selected_blocks`` and B times the columns costed (the
    window of 2w + 1 and ``ladder[0]``, or the whole ladder) to
    ``costed_candidates``."""
    def no_span(name):
        raise AssertionError(f"span {name} made without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", no_span)
    monkeypatch.setenv("AIRS_ADAPTIVE_SELECT", select)
    monkeypatch.delenv("AIRS_ADAPTIVE_WINDOW", raising=False)
    frames = _frames(7, 3, 4, 64)
    bc = tx.BatchCompressor(tx.CmpParams(**FLAGSHIP), 4, 64, adaptive=True,
                            device="cpu")
    blocks0, costed0 = tadapt.selected_blocks, tadapt.costed_candidates
    for k, f in enumerate(frames):
        bc.compress_frames_packed(f)
        assert tadapt.selected_blocks - blocks0 == 4 * (k + 1)
        assert tadapt.costed_candidates - costed0 == 4 * columns * (k + 1)


@pytest.mark.parametrize("way", ["encode", "decode", "decode_frames"])
def test_transfer_counters_stay_zero_on_the_cpu(way, monkeypatch):
    """On the CPU every copy goes through the counting helpers, and no
    byte is counted; the batch counts grow one a batch."""
    frames = _frames(11, 3, 4, 64)
    params = tx.CmpParams(**FLAGSHIP)
    data, offsets, lens = _file(FLAGSHIP, frames, "cpu")
    calls = {"_upload": 0, "_fetch": 0}

    def counted(helper):
        def call(*args):
            calls[helper.__name__] += 1
            return helper(*args)
        return call

    for helper in HELPERS:
        monkeypatch.setattr(tstream, helper.__name__, counted(helper))
    before = _counters()
    enc0, dec0 = tstream.encoded_batches, tstream.decoded_batches
    if way == "encode":
        bc = tx.BatchCompressor(params, 4, 64, device="cpu")
        for f in frames:
            bc.compress_frames_packed(f)
    elif way == "decode":
        bd = tx.BatchDecompressor(params, 4, 64, device="cpu")
        list(bd.decompress_file_stream(data, offsets, lens))
    else:
        bd = tx.BatchDecompressor(params, 4, 64, device="cpu")
        for w in range(3):
            at = slice(4 * w, 4 * w + 4)
            bd.decompress_frames([data[o:o + n] for o, n in
                                  zip(offsets[at], lens[at])])
    assert calls["_upload"] > 0 and calls["_fetch"] > 0
    assert _counters() == before
    assert (tstream.encoded_batches - enc0,
            tstream.decoded_batches - dec0) == \
        ((3, 0) if way == "encode" else (0, 3))


@pytest.mark.card
def test_decode_on_the_card_counts_every_copy():
    """One decode of a 4-batch file (one coalesced launch of 4B rows):
    the dispatch and fetch spans hold device work, and the pageable
    bytes are exactly the copies' sizes."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    b, n, batches = 256, 2048, 4
    frames = _frames(13, batches, b, n)
    data, offsets, lens = _file(HEADLINE, frames, "cuda")
    bd = tx.BatchDecompressor(tx.CmpParams(**HEADLINE), b, n, device="cuda")
    list(bd.decompress_file_stream(data, offsets, lens))     # warm-up
    torch.cuda.synchronize()
    before = _counters()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        out = list(bd.decompress_file_stream(data, offsets, lens))
        torch.cuda.synchronize()
    after = _counters()
    assert np.array_equal(np.stack(out), frames)
    steps = range_times(prof, "stream.")
    assert steps["stream.dispatch"]["device_s"] > 0
    assert steps["stream.fetch"]["device_s"] > 0
    rows = batches * b
    want = {
        # the stream padded to whole words and two guard words
        "_upload": len(data) + (-len(data)) % 4 + 8
        # the row offsets and lengths, the Golomb parameters and outliers
        # (int64 a row each)
        + 4 * 8 * rows,
        # the samples narrowed to 16 bits and the int32 end bits
        "_fetch": 2 * rows * n + 4 * rows,
    }
    for name, nbytes in want.items():
        assert after[name] - before[name] == nbytes, name


@pytest.mark.card
@pytest.mark.parametrize("config,coalesce", [
    ("headline", None),       # one coalesced launch a file
    ("headline", False),      # one launch a batch
    ("flagship", None),       # a MODEL chain with checksums, batch by batch
])
def test_decode_on_the_card_fetches_narrowed_samples(config, coalesce):
    """Three 4-batch files of one chain decoded by one decompressor: each
    batch fetches its samples as 2BN bytes (and its end bits and
    checksums); the windows equal the CPU decode's, byte for byte, and
    the first file's are unchanged after the two later files."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    b, n, batches = 64, 1024, 4
    params = tx.CmpParams(**CONFIGS[config])
    frames = _frames(17, 3 * batches, b, n)
    data, offsets, lens = _file(CONFIGS[config], frames, "cuda")
    files = []
    for f in range(3):
        at = slice(f * batches * b, (f + 1) * batches * b)
        o = offsets[at]
        files.append((data[o[0]:o[-1] + lens[at][-1]], o - o[0], lens[at]))
    decs = {dev: tx.BatchDecompressor(params, b, n, device=dev)
            for dev in ("cuda", "cpu")}
    out = {}
    for dev, bd in decs.items():
        before = _counters()
        out[dev] = [list(bd.decompress_file_stream(*f, coalesce=coalesce))
                    for f in files]
        after = _counters()
        if dev == "cuda":
            kept = [w.copy() for w in out[dev][0]]
            per_batch = 2 * b * n + 4 * b + (8 * b if "checksum_enabled"
                                             in CONFIGS[config] else 0)
            assert after["_fetch"] - before["_fetch"] == \
                3 * batches * per_batch
        else:
            assert after == before
    for f in range(3):
        for got, want, cpu in zip(out["cuda"][f], frames[f * batches:],
                                  out["cpu"][f]):
            assert got.dtype == np.uint16 and got.flags.c_contiguous
            assert got.tobytes() == cpu.tobytes() == want.tobytes()
    for got, copy in zip(out["cuda"][0], kept):
        assert np.array_equal(got, copy)
