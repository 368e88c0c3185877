"""The port's long-stream tier (parallel/sp.py) against the JAX package's,
on the CPU.

The port runs with ``device="cpu"`` (the kernels' plain versions); the
JAX package runs pinned to the CPU as its own tests run it.  Frames are
compared byte for byte: with the JAX ``compress_long_stream`` and
``ChunkedLongStreamEncoder`` on ``make_mesh(1, "sp")`` and on the 8-device
CPU mesh of ``tests/conftest.py`` (each JAX program is compiled once, in a
module-scoped fixture), and over every preprocessing and encoder with the
JAX host codec (``compress_pass_host``) under a pinned identifier.  Chains
are held to one JAX host context (``CmpContext``), which is what the JAX
tier's own tests hold its chains to.  Sidecars and decoded samples equal
the JAX ones, and corrupt sidecars, payloads and trailers raise the same
``CmpErrorCode``.  The streaming XXH32 (``XXH32State``,
``cmp_checksum_chunked``) and the plain version of kernel K4's streaming
form equal the JAX package's.
"""

import dataclasses

import numpy as np
import pytest
import torch

import airs_compression_tpu as act
import airs_compression_tpu_torch as tx
from airs_compression_tpu.engine.host import compress_pass_host
from airs_compression_tpu.format.dtypes import CmpType, SampleView
from airs_compression_tpu.parallel import sp as j_sp
from airs_compression_tpu.parallel.mesh import make_mesh
from airs_compression_tpu.utils import xxh32 as j_xxh
from airs_compression_tpu_torch.ops.xxh32_device import (
    StreamHasher,
    xxh32_lanes,
    xxh32_lanes_plain,
)
from airs_compression_tpu_torch.parallel import sp as t_sp
from airs_compression_tpu_torch.utils import xxh32 as t_xxh

P, E = act.Preprocessing, act.EncoderType
CPU = "cpu"

HEADLINE = act.CmpParams(primary_preprocessing=P.DIFF,
                         primary_encoder_type=E.GOLOMB_ZERO,
                         primary_encoder_param=4, checksum_enabled=True)


class _Stamp:
    def __init__(self, start=0):
        self.counter = start

    def __call__(self):
        c = self.counter
        self.counter += 1
        return (c >> 16) & 0xFFFFFFFF, c & 0xFFFF


def _tparams(params):
    return tx.params_from_reference(dataclasses.asdict(params))


def _stream(seed, n, sigma=9.0, level=1100):
    rng = np.random.default_rng(seed)
    return ((level + rng.normal(0, sigma, n)).astype(np.int64)
            & 0xFFFF).astype(np.uint16)


def _host_frame(params, x, identifier, seq=0, model=None):
    """The JAX host codec's frame with a pinned identifier (the codec
    updates a model it is given in place: it gets a copy)."""
    view = SampleView(np.ascontiguousarray(x).tobytes(), CmpType.U16)
    res = compress_pass_host(params, seq > 0, view,
                             None if model is None else model.copy(), seq,
                             identifier, 1 << 25)
    assert res.error == 0, res.error
    return res.compressed


def _code(fn):
    try:
        fn()
    except (act.CmpError, tx.CmpError) as e:
        return int(e.code)
    return None


# -- the streaming XXH32 -------------------------------------------------------

CUTS = [[], [1], [15], [16], [17], [3, 20, 999], [15, 16, 17, 500]]


@pytest.mark.parametrize("cuts", CUTS)
def test_xxh32_state_equals_jax(cuts):
    data = np.random.default_rng(0).integers(0, 256, 1000,
                                             dtype=np.uint8).tobytes()
    t, j = t_xxh.XXH32State(t_xxh.CHECKSUM_SEED), \
        j_xxh.XXH32State(j_xxh.CHECKSUM_SEED)
    prev = 0
    for c in cuts + [len(data)]:
        t.update(data[prev:c])
        j.update(data[prev:c])
        prev = c
    assert t.intdigest() == j.intdigest() == j_xxh.xxh32(data,
                                                          j_xxh.CHECKSUM_SEED)


@pytest.mark.parametrize("sizes", [[0], [7], [8, 8], [1, 2, 3, 4, 1000],
                                   [333, 0, 4096]])
def test_cmp_checksum_chunked_equals_jax(sizes):
    rng = np.random.default_rng(sum(sizes))
    chunks = [rng.integers(0, 1 << 16, s).astype(np.uint16) for s in sizes]
    assert t_xxh.cmp_checksum_chunked(chunks) \
        == j_xxh.cmp_checksum_chunked(chunks) \
        == j_xxh.cmp_checksum(np.concatenate(chunks))


@pytest.mark.parametrize("cuts", [[], [1], [7, 8, 9], [100, 105, 2000],
                                  [2999, 3000]])
def test_streamed_k4_plain_equals_jax(cuts):
    """The plain version of K4's streaming form, fed pieces of any length
    through StreamHasher, gives the JAX package's checksum."""
    x = np.random.default_rng(1).integers(0, 1 << 16, 3001).astype(np.uint16)
    h = StreamHasher(CPU)
    prev = 0
    for c in cuts + [x.size]:
        h.update(torch.from_numpy(x[prev:c].view(np.int16)))
        prev = c
    assert h.intdigest() == j_xxh.cmp_checksum(x)


def test_k4_lanes_plain_equals_state():
    """Lanes after whole stripes equal XXH32State's accumulators."""
    x = np.random.default_rng(2).integers(0, 1 << 16, (3, 64)).astype(np.uint16)
    seed = t_xxh.CHECKSUM_SEED
    lanes = torch.zeros((3, 4), dtype=torch.int32)
    st = [t_xxh.XXH32State(seed) for _ in range(3)]
    lanes.copy_(torch.tensor([[v - (1 << 32) if v >= 1 << 31 else v
                               for v in s._acc] for s in st]))
    xxh32_lanes(lanes, torch.from_numpy(x.view(np.int16)))
    for i, s in enumerate(st):
        s.update(x[i].astype(">u2").tobytes())
        assert (lanes[i].numpy().view(np.uint32).tolist() == s._acc)
    with pytest.raises(ValueError, match="multiple of 8"):
        xxh32_lanes_plain(lanes, torch.zeros((3, 12), dtype=torch.int32))


# -- one-shot encode -----------------------------------------------------------

GRID = [(prep, enc, g) for prep in (P.NONE, P.DIFF, P.IWT)
        for enc, g in ((E.GOLOMB_ZERO, 1), (E.GOLOMB_ZERO, 4),
                       (E.GOLOMB_ZERO, 5), (E.GOLOMB_MULTI, 3))] \
    + [(P.DIFF, E.UNCOMPRESSED, 1), (P.NONE, E.UNCOMPRESSED, 1)]


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("prep,enc,g", GRID)
def test_compress_long_stream_equals_host(prep, enc, g, checksum):
    """Every preprocessing and encoder: the JAX host codec's frame (pinned
    identifier), decoded back by the port's decompress."""
    params = act.CmpParams(primary_preprocessing=prep,
                           primary_encoder_type=enc,
                           primary_encoder_param=g,
                           primary_encoder_outlier=40,
                           checksum_enabled=checksum)
    x = _stream(3, 1 << 12, sigma=30)
    frame = t_sp.compress_long_stream(_tparams(params), x,
                                      identifier=0xABCDEF12345,
                                      sequence_number=0, device=CPU)
    assert frame == _host_frame(params, x, 0xABCDEF12345)
    np.testing.assert_array_equal(tx.decompress(frame)[0], x)


def test_compress_long_stream_model_secondary_equals_host():
    params = act.CmpParams(primary_preprocessing=P.DIFF,
                           primary_encoder_type=E.GOLOMB_ZERO,
                           primary_encoder_param=4, secondary_iterations=2,
                           secondary_preprocessing=P.MODEL,
                           secondary_encoder_type=E.GOLOMB_MULTI,
                           secondary_encoder_param=2,
                           secondary_encoder_outlier=40, model_rate=8,
                           checksum_enabled=True)
    x = _stream(4, 1 << 11)
    model = _stream(5, 1 << 11).view(np.int16)
    frame = t_sp.compress_long_stream(_tparams(params), x, identifier=9,
                                      sequence_number=1, model=model,
                                      secondary=True, device=CPU)
    assert frame == _host_frame(params, x, 9, seq=1, model=model)


@pytest.fixture(scope="module")
def jax_frames():
    """The JAX compress_long_stream's frames of one stream on the one- and
    the 8-device mesh (one compile each), and the stream."""
    x = _stream(6, 1 << 11)
    return x, {d: j_sp.compress_long_stream(make_mesh(d, "sp"), HEADLINE, x,
                                            identifier=77,
                                            sequence_number=3)
               for d in (1, 8)}


@pytest.mark.parametrize("devices", [1, 8])
def test_compress_long_stream_equals_jax(jax_frames, devices):
    x, frames = jax_frames
    assert t_sp.compress_long_stream(_tparams(HEADLINE), x, identifier=77,
                                     sequence_number=3, device=CPU) \
        == frames[devices]


@pytest.mark.parametrize("case", ["too_large", "iwt_not_pow2",
                                  "model_missing", "bad_params"])
def test_compress_long_stream_refusals(case):
    iwt = dataclasses.replace(HEADLINE, primary_preprocessing=P.IWT)
    chain = dataclasses.replace(HEADLINE, secondary_iterations=1,
                                secondary_preprocessing=P.MODEL,
                                secondary_encoder_type=E.GOLOMB_ZERO,
                                secondary_encoder_param=2, model_rate=4)
    params, x, kw = {
        "too_large": (HEADLINE, np.zeros(1 << 23, np.uint16), {}),
        "iwt_not_pow2": (iwt, np.zeros(3000, np.uint16), {}),
        "model_missing": (chain, np.zeros(64, np.uint16),
                          {"secondary": True}),
        "bad_params": (dataclasses.replace(HEADLINE, primary_encoder_param=0),
                       np.zeros(64, np.uint16), {}),
    }[case]
    want = _code(lambda: j_sp.compress_long_stream(make_mesh(1, "sp"),
                                                   params, x, **kw))
    assert want is not None
    assert _code(lambda: t_sp.compress_long_stream(
        _tparams(params), x, device=CPU, **kw)) == want


# -- sidecar and decode --------------------------------------------------------

DECODE_CASES = {
    "diff_zero": (P.DIFF, E.GOLOMB_ZERO, 4, True),
    "none_multi": (P.NONE, E.GOLOMB_MULTI, 3, False),
    "iwt_zero": (P.IWT, E.GOLOMB_ZERO, 2, True),
}


@pytest.fixture(scope="module")
def decoded():
    """Per case: params, stream, the port's frame and sidecar (256-sample
    chunks), and the JAX package's sidecar and decoded samples."""
    out = {}
    for name, (prep, enc, g, cs) in DECODE_CASES.items():
        params = act.CmpParams(primary_preprocessing=prep,
                               primary_encoder_type=enc,
                               primary_encoder_param=g,
                               primary_encoder_outlier=40,
                               checksum_enabled=cs)
        x = _stream(7, 1 << 12, sigma=20)
        frame = t_sp.compress_long_stream(_tparams(params), x, identifier=5,
                                          device=CPU)
        idx = t_sp.stream_chunk_index(_tparams(params), x, 256, device=CPU)
        out[name] = (params, x, frame, idx,
                     j_sp.stream_chunk_index(params, x, 256),
                     j_sp.decompress_long_stream(frame, idx))
    return out


@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_chunk_index_equals_jax(decoded, name):
    _, _, _, idx, j_idx, _ = decoded[name]
    assert idx.dtype == j_idx.dtype
    np.testing.assert_array_equal(idx, j_idx)


@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_decompress_long_stream_equals_jax(decoded, name):
    _, x, frame, idx, _, j_out = decoded[name]
    out = t_sp.decompress_long_stream(frame, idx, device=CPU)
    assert out.dtype == np.uint16
    np.testing.assert_array_equal(out, j_out)
    np.testing.assert_array_equal(out, x)


def test_chunk_index_model_and_refusals():
    chain = dataclasses.replace(HEADLINE, secondary_iterations=1,
                                secondary_preprocessing=P.MODEL,
                                secondary_encoder_type=E.GOLOMB_ZERO,
                                secondary_encoder_param=2, model_rate=4)
    x = _stream(8, 1024)
    model = _stream(9, 1024).view(np.int16)
    np.testing.assert_array_equal(
        t_sp.stream_chunk_index(_tparams(chain), x, 128, secondary=True,
                                model=model, device=CPU),
        j_sp.stream_chunk_index(chain, x, 128, secondary=True, model=model))
    unc = dataclasses.replace(HEADLINE,
                              primary_encoder_type=E.UNCOMPRESSED)
    for params, kw in ((chain, {"secondary": True}), (unc, {}),
                       (HEADLINE, {"chunk_samples": 1000})):
        want = _code(lambda: j_sp.stream_chunk_index(params, x, **kw))
        assert want is not None
        assert _code(lambda: t_sp.stream_chunk_index(
            _tparams(params), x, device=CPU, **kw)) == want


def _corrupt(kind, frame, idx):
    """(frame, sidecar) with one fault."""
    frame = bytearray(frame)
    idx = idx.copy()
    if kind == "lying_sidecar":
        idx[3] += 1
        idx[4] -= 1
    elif kind == "short_sidecar":
        idx = idx[:-1]
    elif kind == "sidecar_past_end":
        idx[-1] += 64
    elif kind == "flipped_payload":
        frame[200] ^= 0x10
    elif kind == "zeroed_payload":
        frame[100:116] = bytes(16)
    elif kind == "cut_payload":
        frame = frame[: len(frame) // 2]
    elif kind == "trailer":
        frame[-1] ^= 1
    elif kind == "empty_sidecar":
        idx = idx[:0]
    return bytes(frame), idx


@pytest.mark.parametrize("kind", ["lying_sidecar", "short_sidecar",
                                  "sidecar_past_end", "flipped_payload",
                                  "zeroed_payload", "cut_payload", "trailer",
                                  "empty_sidecar"])
def test_corrupt_input_same_error(decoded, kind):
    _, _, frame, idx, _, _ = decoded["diff_zero"]
    fr, ix = _corrupt(kind, frame, idx)
    want = _code(lambda: j_sp.decompress_long_stream(fr, ix))
    assert want is not None
    assert _code(lambda: t_sp.decompress_long_stream(fr, ix,
                                                     device=CPU)) == want


def test_decode_refuses_other_frames():
    """Uncompressed frames and MODEL frames without a model: the same
    errors as the JAX package's."""
    x = _stream(10, 1024)
    unc = dataclasses.replace(HEADLINE, primary_preprocessing=P.NONE,
                              primary_encoder_type=E.UNCOMPRESSED)
    frame = t_sp.compress_long_stream(_tparams(unc), x, device=CPU)
    idx = np.full(4, 256 * 16)
    chain = dataclasses.replace(HEADLINE, secondary_iterations=1,
                                secondary_preprocessing=P.MODEL,
                                secondary_encoder_type=E.GOLOMB_ZERO,
                                secondary_encoder_param=2, model_rate=4)
    model = _stream(11, 1024).view(np.int16)
    m_frame = t_sp.compress_long_stream(_tparams(chain), x, model=model,
                                        secondary=True, sequence_number=1,
                                        device=CPU)
    m_idx = t_sp.stream_chunk_index(_tparams(chain), x, 256, secondary=True,
                                    model=model, device=CPU)
    for fr, ix in ((frame, idx), (m_frame, m_idx)):
        want = _code(lambda: j_sp.decompress_long_stream(fr, ix))
        assert want is not None
        assert _code(lambda: t_sp.decompress_long_stream(
            fr, ix, device=CPU)) == want
    np.testing.assert_array_equal(
        t_sp.decompress_long_stream(m_frame, m_idx, model=model, device=CPU),
        x)


# -- chains --------------------------------------------------------------------

CHAINS = {
    "model": act.CmpParams(primary_preprocessing=P.DIFF,
                           primary_encoder_type=E.GOLOMB_ZERO,
                           primary_encoder_param=4, secondary_iterations=3,
                           secondary_preprocessing=P.MODEL,
                           secondary_encoder_type=E.GOLOMB_MULTI,
                           secondary_encoder_param=2,
                           secondary_encoder_outlier=40, model_rate=8,
                           checksum_enabled=True),
    "iwt": act.CmpParams(primary_preprocessing=P.IWT,
                         primary_encoder_type=E.GOLOMB_ZERO,
                         primary_encoder_param=4, secondary_iterations=2,
                         secondary_preprocessing=P.IWT,
                         secondary_encoder_type=E.GOLOMB_ZERO,
                         secondary_encoder_param=2, checksum_enabled=True),
    "fallback": act.CmpParams(primary_preprocessing=P.DIFF,
                              primary_encoder_type=E.GOLOMB_ZERO,
                              primary_encoder_param=1,
                              uncompressed_fallback_enabled=True,
                              secondary_iterations=2,
                              secondary_preprocessing=P.MODEL,
                              secondary_encoder_type=E.GOLOMB_ZERO,
                              secondary_encoder_param=1, model_rate=4,
                              checksum_enabled=True),
}


@pytest.mark.parametrize("name", list(CHAINS))
def test_long_stream_compressor_equals_host_context(name):
    """Chains of six frames (a noise frame in the middle: the fallback
    resets the chain) equal one JAX host context under the same
    identifiers, and decode back through the port's decompress."""
    params = CHAINS[name]
    n = 1 << 10
    rng = np.random.default_rng(12)
    base = 1100 + rng.normal(0, 3000 if name == "fallback" else 9, n)
    frames = [((base + rng.normal(0, 3, n)).astype(np.int64) & 0xFFFF)
              .astype(np.uint16) for _ in range(6)]
    frames[3] = rng.integers(0, 1 << 16, n).astype(np.uint16)
    act.set_timestamp_func(_Stamp())
    tx.set_timestamp_func(_Stamp())
    try:
        ctx = act.CmpContext(params)
        lsc = t_sp.LongStreamCompressor(_tparams(params), device=CPU)
        want = [ctx.compress_u16(f) for f in frames]
        got = [lsc.compress(f) for f in frames]
    finally:
        act.set_timestamp_func(None)
        tx.set_timestamp_func(None)
    assert got == want
    assert lsc.seq == ctx.sequence_number
    assert lsc.identifier == ctx.identifier
    if params.model_is_needed():
        np.testing.assert_array_equal(lsc.model.cpu().numpy(), ctx.model)
    dec, hdrs = tx.decompress(b"".join(got))
    np.testing.assert_array_equal(dec, np.concatenate(frames))
    if name == "fallback":
        assert [h.encoder_type for h in hdrs].count(0) >= 1


def test_long_stream_compressor_size_change_refused():
    params = CHAINS["model"]
    lsc = t_sp.LongStreamCompressor(_tparams(params), device=CPU)
    lsc.compress(_stream(13, 512))
    ctx = act.CmpContext(params)
    ctx.compress_u16(_stream(13, 512))
    want = _code(lambda: ctx.compress_u16(_stream(13, 256)))
    assert want == int(act.CmpErrorCode.SRC_SIZE_MISMATCH)
    assert _code(lambda: lsc.compress(_stream(13, 256))) == want


# -- streaming encode ----------------------------------------------------------

@pytest.fixture(scope="module")
def jax_chunked():
    """The JAX ChunkedLongStreamEncoder's frame on the 8-device mesh: two
    feeds then feed_many of the other six chunks."""
    x = _stream(14, 1 << 11)
    chunks = x.reshape(8, 256)
    enc = j_sp.ChunkedLongStreamEncoder(make_mesh(8, "sp"), HEADLINE,
                                        x.size, 256, identifier=21)
    enc.feed(chunks[0])
    enc.feed(chunks[1])
    enc.feed_many(chunks[2:])
    return x, enc.finish()


def _feed_all(params, x, chunk, model=None, secondary=False, seq=0,
              identifier=21, device_chunks=False):
    enc = t_sp.ChunkedLongStreamEncoder(_tparams(params), x.size, chunk,
                                        identifier=identifier,
                                        sequence_number=seq,
                                        secondary=secondary, device=CPU)
    chunks = x.reshape(-1, chunk)
    mc = None if model is None else model.reshape(-1, chunk)
    feed = (lambda v: torch.from_numpy(v.astype(np.int32))) \
        if device_chunks else (lambda v: v)
    enc.feed(feed(chunks[0]), None if mc is None else mc[0])
    enc.feed(feed(chunks[1]), None if mc is None else mc[1])
    enc.feed_many(feed(chunks[2:]), None if mc is None else mc[2:])
    return enc.finish()


@pytest.mark.parametrize("device_chunks", [False, True])
def test_chunked_encoder_equals_jax(jax_chunked, device_chunks):
    x, want = jax_chunked
    assert _feed_all(HEADLINE, x, 256, device_chunks=device_chunks) == want
    assert t_sp.compress_long_stream(_tparams(HEADLINE), x, identifier=21,
                                     device=CPU) == want


@pytest.mark.parametrize("prep,enc,g", [(P.NONE, E.GOLOMB_MULTI, 3),
                                        (P.DIFF, E.GOLOMB_ZERO, 1),
                                        (P.MODEL, E.GOLOMB_ZERO, 2),
                                        (P.MODEL, E.UNCOMPRESSED, 1)])
def test_chunked_encoder_equals_host(prep, enc, g):
    """Secondary passes of every streamable method: the JAX host codec's
    frame, and the port's one-shot frame."""
    params = act.CmpParams(primary_preprocessing=P.DIFF,
                           primary_encoder_type=E.GOLOMB_ZERO,
                           primary_encoder_param=4, secondary_iterations=1,
                           secondary_preprocessing=prep,
                           secondary_encoder_type=enc,
                           secondary_encoder_param=g,
                           secondary_encoder_outlier=40, model_rate=8,
                           checksum_enabled=True)
    x = _stream(15, 1 << 12, sigma=40)
    model = (x.astype(np.int64) + 3).astype(np.int16)
    got = _feed_all(params, x, 512, model=model, secondary=True, seq=1)
    assert got == _host_frame(params, x, 21, seq=1, model=model)
    assert got == t_sp.compress_long_stream(
        _tparams(params), x, identifier=21, sequence_number=1, model=model,
        secondary=True, device=CPU)


MISFEEDS = ["wrong_size", "overfed", "overfed_many", "bad_buffer",
            "finish_early", "model_missing", "iwt", "not_dividing",
            "too_large"]


@pytest.mark.parametrize("case", MISFEEDS)
def test_chunked_encoder_misfeeds_same_error(case):
    mesh = make_mesh(1, "sp")
    iwt = dataclasses.replace(HEADLINE, primary_preprocessing=P.IWT)
    chain = dataclasses.replace(HEADLINE, secondary_iterations=1,
                                secondary_preprocessing=P.MODEL,
                                secondary_encoder_type=E.GOLOMB_ZERO,
                                secondary_encoder_param=2, model_rate=4)
    z = np.zeros(64, np.uint16)

    def run(make):
        enc = make(HEADLINE if case not in ("iwt", "model_missing")
                   else iwt if case == "iwt" else chain,
                   {"not_dividing": 100, "too_large": 1 << 23}.get(case, 128),
                   64, case == "model_missing")
        if case == "wrong_size":
            enc.feed(z[:63])
        elif case in ("overfed", "overfed_many"):
            enc.feed_many(np.zeros((2, 64), np.uint16))
            if case == "overfed":
                enc.feed(z)
            else:
                enc.feed_many(np.zeros((1, 64), np.uint16))
        elif case == "bad_buffer":
            enc.feed_many(np.zeros((2, 32), np.uint16))
        elif case == "finish_early":
            enc.feed(z)
            enc.finish()
        elif case == "model_missing":
            enc.feed(z)

    want = _code(lambda: run(
        lambda p, total, chunk, sec: j_sp.ChunkedLongStreamEncoder(
            mesh, p, total, chunk, secondary=sec)))
    assert want is not None
    assert _code(lambda: run(
        lambda p, total, chunk, sec: t_sp.ChunkedLongStreamEncoder(
            _tparams(p), total, chunk, secondary=sec, device=CPU))) == want


def test_chunked_encoder_takes_no_clamp():
    """The entropy clamp is not ported: the argument is absent, not
    ignored."""
    with pytest.raises(TypeError):
        t_sp.ChunkedLongStreamEncoder(_tparams(HEADLINE), 128, 64,
                                      clamp=False, device=CPU)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x = np.zeros(64, np.uint16)
    params = _tparams(HEADLINE)
    for fn in (lambda: t_sp.compress_long_stream(params, x),
               lambda: t_sp.stream_chunk_index(params, x, 16),
               lambda: t_sp.decompress_long_stream(
                   t_sp.compress_long_stream(params, x, device=CPU),
                   np.zeros(4)),
               lambda: t_sp.ChunkedLongStreamEncoder(params, 64, 64),
               lambda: t_sp.LongStreamCompressor(params)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()


def test_steps_are_profiler_ranges():
    """The entry points take the JAX signatures (no timer argument); their
    steps are torch.profiler ranges that utils/profiling.range_times
    reads, each once per call."""
    from airs_compression_tpu_torch.utils.profiling import range_times

    params = _tparams(HEADLINE)
    x = _stream(31, 1 << 10)
    with pytest.raises(TypeError):
        t_sp.compress_long_stream(params, x, device=CPU, timer=None)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        frame = t_sp.compress_long_stream(params, x, device=CPU)
        idx = t_sp.stream_chunk_index(params, x, 256, device=CPU)
        back = t_sp.decompress_long_stream(frame, idx, device=CPU)
    assert np.array_equal(back, x)
    steps = range_times(prof, "sp.")
    assert set(steps) == {
        *(f"sp.encode.{s}" for s in ("upload", "preprocess", "codes",
                                     "pack", "checksum", "fetch")),
        *(f"sp.decode.{s}" for s in ("upload", "decode", "inverse", "check",
                                     "checksum", "fetch"))}
    for r in steps.values():
        assert r["calls"] == 1 and r["s"] > 0 and r["device_s"] == 0
