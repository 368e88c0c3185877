"""The port's chunked file path (models/chunked.py) against the JAX
package's, on the CPU.

The cases of ``tests/test_chunked.py``, each run through both packages
with a counter installed as the identifier source of each: the (n, chunk,
batch) grid, fallback chunks, adaptive chunks, the host tail, a model-chain
stream through the host path, both staging tiers, a checksum mismatch and a
truncated stream.  ``compress_chunked`` must give the same bytes,
``decompress_chunked`` the same samples, and malformed streams the same
``CmpErrorCode``.  The port runs with ``device="cpu"`` (the kernels' plain
versions).  A stream whose frame is cut short on a nonzero word holds the
port's decoder, which reads zeros past a row where the JAX scan repeats the
row's last word, to the JAX package's error.
"""

import dataclasses
import functools

import numpy as np
import pytest

import airs_compression_tpu as act
import airs_compression_tpu_torch as tx
from airs_compression_tpu.models import chunked as j_chunked
from airs_compression_tpu.models.stream import BatchCompressor as JBatch
from airs_compression_tpu_torch.engine import decode as t_dec
from airs_compression_tpu_torch.format.errors import CmpError as TCmpError
from airs_compression_tpu_torch.models import chunked as t_chunked

P, E = act.Preprocessing, act.EncoderType


class _Stamp:
    def __init__(self):
        self.counter = 0

    def __call__(self):
        c = self.counter
        self.counter += 1
        return (c >> 16) & 0xFFFFFFFF, c & 0xFFFF


def _data(rng, n, sigma=9.0):
    return (1100 + rng.normal(0, sigma, n)).astype(np.int64).astype(np.uint16)


PARAMS = act.CmpParams(primary_preprocessing=P.DIFF,
                       primary_encoder_type=E.GOLOMB_ZERO,
                       primary_encoder_param=4, checksum_enabled=True)
FALLBACK = act.CmpParams(primary_preprocessing=P.DIFF,
                         primary_encoder_type=E.GOLOMB_ZERO,
                         primary_encoder_param=1,
                         uncompressed_fallback_enabled=True,
                         checksum_enabled=True)


def _tparams(params):
    return tx.params_from_reference(dataclasses.asdict(params))


def _both_compress(params, data, chunk, batch, adaptive=False):
    """compress_chunked of each package, each from a fresh counter."""
    act.set_timestamp_func(_Stamp())
    tx.set_timestamp_func(_Stamp())
    try:
        jcls = functools.partial(JBatch, adaptive=True) if adaptive else JBatch
        tcls = (functools.partial(tx.BatchCompressor, adaptive=True)
                if adaptive else tx.BatchCompressor)
        j = j_chunked.compress_chunked(params, data, chunk_samples=chunk,
                                       batch=batch, compressor_cls=jcls)
        t = t_chunked.compress_chunked(_tparams(params), data,
                                       chunk_samples=chunk, batch=batch,
                                       compressor_cls=tcls, device="cpu")
    finally:
        act.set_timestamp_func(None)
        tx.set_timestamp_func(None)
    return j, t


def _outcome(fn):
    """(result, None), or (None, the CmpErrorCode value ``fn`` raised)."""
    try:
        return fn(), None
    except (act.CmpError, TCmpError) as e:
        return None, int(e.code)


def _code(fn):
    return _outcome(fn)[1]


def _both_decompress(stream, batch, **kw):
    """decompress_chunked of each package: equal samples (returned), or
    the same error code from both (returned)."""
    j, jc = _outcome(lambda: j_chunked.decompress_chunked(
        stream, batch=batch, **kw))
    t, tc = _outcome(lambda: t_chunked.decompress_chunked(
        stream, batch=batch, device="cpu", **kw))
    assert tc == jc
    if jc is not None:
        return jc
    np.testing.assert_array_equal(t, j)
    return t


@pytest.mark.parametrize("n,chunk,batch", [
    (4096, 1024, 2),      # 4 full chunks, 2 device batches
    (5000, 1024, 3),      # 4 full chunks + 904-sample host tail
    (1000, 1024, 4),      # smaller than one chunk: host tail only
    (6144, 1024, 16),     # one partial batch
])
def test_grid_same_bytes(n, chunk, batch):
    """The port's bytes equal one JAX host context fed the same chunk grid
    (what tests/test_chunked.py holds the JAX compress_chunked to; the JAX
    compress_chunked itself runs at batch 2 in the other tests here, since
    each batch size costs it a compile)."""
    data = _data(np.random.default_rng(0), n)
    act.set_timestamp_func(_Stamp())
    tx.set_timestamp_func(_Stamp())
    try:
        t = t_chunked.compress_chunked(_tparams(PARAMS), data,
                                       chunk_samples=chunk, batch=batch,
                                       device="cpu")
        ctx = act.CmpContext(PARAMS)
        ref = b"".join(ctx.compress_u16(data[i: i + chunk])
                       for i in range(0, n, chunk))
    finally:
        act.set_timestamp_func(None)
        tx.set_timestamp_func(None)
    assert t == ref
    dec, hdrs = t_dec.decompress(t)
    np.testing.assert_array_equal(dec, data)
    assert all(h.sequence_number == 0 for h in hdrs)
    for staged in (False, True):
        np.testing.assert_array_equal(
            _both_decompress(t, 4, device_staged=staged), data)


class _FramesOnly:
    """A compressor class with ``compress_frames`` only (no packed
    stream), as ``compress_chunked(compressor_cls=)`` may be given."""

    def __init__(self, params, batch, n, device="cuda"):
        self._bc = tx.BatchCompressor(params, batch, n, device=device)

    def compress_frames(self, frames):
        return self._bc.compress_frames(frames)


def test_compressor_cls_without_packed_stream():
    """A compressor_cls without compress_frames_packed gives its
    compress_frames list, as the JAX compress_chunked takes it: the same
    bytes as one JAX host context fed the chunk grid."""
    n, chunk = 5000, 1024
    data = _data(np.random.default_rng(3), n)
    act.set_timestamp_func(_Stamp())
    tx.set_timestamp_func(_Stamp())
    try:
        t = t_chunked.compress_chunked(_tparams(PARAMS), data,
                                       chunk_samples=chunk, batch=3,
                                       compressor_cls=_FramesOnly,
                                       device="cpu")
        ctx = act.CmpContext(PARAMS)
        ref = b"".join(ctx.compress_u16(data[i: i + chunk])
                       for i in range(0, n, chunk))
    finally:
        act.set_timestamp_func(None)
        tx.set_timestamp_func(None)
    assert t == ref


def _fallback_data():
    rng = np.random.default_rng(5)
    return np.concatenate([
        _data(rng, 1024),
        rng.integers(0, 1 << 16, 2048).astype(np.uint16),  # falls back
        _data(rng, 1500),  # a 476-sample host tail block
    ])


@pytest.fixture(scope="module")
def fallback_stream():
    data = _fallback_data()
    j, t = _both_compress(FALLBACK, data, 1024, 4)
    assert t == j
    return data, t


def test_fallback_chunks_and_tail(fallback_stream):
    """Fallback chunks and the host tail: the same bytes, and both staging
    tiers of both packages decode them."""
    data, stream = fallback_stream
    dec, hdrs = t_dec.decompress(stream)
    np.testing.assert_array_equal(dec, data)
    assert any(h.encoder_type == 0 for h in hdrs)  # fallback happened
    for staged in (False, True):
        np.testing.assert_array_equal(
            _both_decompress(stream, 4, device_staged=staged), data)


@pytest.mark.parametrize("staged", [False, True])
def test_corrupt_checksum_same_error(fallback_stream, staged):
    data, stream = fallback_stream
    bad = bytearray(stream)
    bad[-1] ^= 0xFF  # the tail block's trailing checksum
    assert _both_decompress(bytes(bad), 4, device_staged=staged) is not None
    # a device-run block's checksum
    bad = bytearray(stream)
    bad[int.from_bytes(stream[2:5], "big") - 1] ^= 0xFF
    assert _both_decompress(bytes(bad), 4, device_staged=staged) is not None
    np.testing.assert_array_equal(
        _both_decompress(bytes(bad), 4, device_staged=staged,
                         verify_checksum=False), data)


def test_secondary_iterations_and_empty_rejected():
    chain = act.CmpParams(primary_preprocessing=P.DIFF,
                          primary_encoder_type=E.GOLOMB_ZERO,
                          primary_encoder_param=4, secondary_iterations=2,
                          secondary_preprocessing=P.MODEL,
                          secondary_encoder_type=E.GOLOMB_ZERO,
                          secondary_encoder_param=4, model_rate=8)
    for params, data in ((chain, np.zeros(100, np.uint16)),
                         (PARAMS, np.zeros(0, np.uint16))):
        want = _code(lambda: j_chunked.compress_chunked(params, data))
        assert want is not None
        assert _code(lambda: t_chunked.compress_chunked(
            _tparams(params), data, device="cpu")) == want


def test_adaptive_chunks():
    """Chunked + adaptive compose (per-block parameter in each header)."""
    rng = np.random.default_rng(6)
    data = np.concatenate(
        [_data(rng, 1024, sigma=s) for s in (1, 40, 900, 3)])
    j, t = _both_compress(PARAMS, data, 1024, 4, adaptive=True)
    assert t == j
    _, hdrs = t_dec.decompress(t)
    assert len({h.encoder_param for h in hdrs}) >= 2
    np.testing.assert_array_equal(_both_decompress(t, 4), data)


def test_model_chain_stream_uses_host_path():
    """Streams with MODEL blocks (chain state) decode exactly through the
    host path of both packages."""
    params = act.CmpParams(primary_preprocessing=P.DIFF,
                           primary_encoder_type=E.GOLOMB_ZERO,
                           primary_encoder_param=2,
                           secondary_iterations=10,
                           secondary_preprocessing=P.MODEL,
                           secondary_encoder_type=E.GOLOMB_ZERO,
                           secondary_encoder_param=2, model_rate=8)
    rng = np.random.default_rng(7)
    ctx = act.CmpContext(params)
    base = (1100 + rng.normal(0, 4, 512)).astype(np.int64)
    frames = [((base + rng.normal(0, 2, 512)).astype(np.int64)
               & 0xFFFF).astype(np.uint16) for _ in range(4)]
    stream = b"".join(ctx.compress_u16(f) for f in frames)
    np.testing.assert_array_equal(_both_decompress(stream, 2048),
                                  np.concatenate(frames))


@functools.lru_cache(maxsize=1)
def _grid_stream():
    """compress_chunked of both packages at batch 2: the same bytes."""
    data = _data(np.random.default_rng(9), 4096)
    j, t = _both_compress(PARAMS, data, 1024, 2)
    assert t == j
    return t


def test_same_bytes_as_jax_compress_chunked():
    assert t_dec.decompress(_grid_stream())[0].size == 4096


@pytest.mark.parametrize("cut", [3, 1, 40])
def test_truncated_stream_same_error(cut):
    stream = _grid_stream()
    assert _both_decompress(stream[:-cut], 2) is not None


def _cut_frame(stream, k, drop):
    """The stream with block k's last ``drop`` payload bytes removed (its
    header's compressed_size lowered to match, its checksum trailer
    kept)."""
    offs, o = [], 0
    while o < len(stream):
        offs.append(o)
        o += int.from_bytes(stream[o + 2: o + 5], "big")
    o = offs[k]
    size = int.from_bytes(stream[o + 2: o + 5], "big")
    frame = bytearray(stream[o: o + size])
    frame[2:5] = (size - drop).to_bytes(3, "big")
    cut = frame[: size - 4 - drop] + frame[size - 4:]
    return stream[:o] + bytes(cut) + stream[o + size:], bytes(frame[:size - 4])


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("drop", [4, 9])
def test_frame_cut_on_nonzero_word_same_error(staged, drop):
    """A device-run frame whose payload is cut short on a nonzero word:
    both packages raise the same error through decompress_chunked (the
    port's decoder reads zeros past the row, the JAX scan repeats its last
    word), and through the host decoder."""
    stream = _grid_stream()
    bad, frame = _cut_frame(stream, 1, drop)
    payload_end = len(frame) - drop
    assert any(frame[payload_end - 4: payload_end])  # nonzero last word
    code = _both_decompress(bad, 2, device_staged=staged)
    assert code is not None
    jc = _code(lambda: act.decompress(bad))
    assert jc is not None and _code(lambda: t_dec.decompress(bad)) == jc
