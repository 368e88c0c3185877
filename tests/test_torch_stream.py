"""Port parity, packed streams: compress_frames_packed and the stream decoders.

The port's ``BatchCompressor.compress_frames_packed`` (CPU tensors: the
kernels' plain versions, K5's included) must give the JAX package's packed
stream and sizes byte for byte (``assemble="host"``), fixed-rate and
adaptive, with synchronized timestamp stubs in both packages.  The port's
``decompress_stream`` over ``stage_frames_at`` batches and its
``decompress_file_stream`` over one manifest must return the JAX package's
samples, and a corrupted or truncated stream, or spans outside it, must
raise the same ``CmpErrorCode``.  Tolerance: exact (bytes, samples and
error codes).

The decode's fetch, on the port alone: the samples are narrowed to their
low 16 bits before they leave the device, and ``finish`` returns
C-contiguous (B, N) uint16 arrays that the caller owns, grouped or not;
a corrupt payload or a wrong checksum still raises before any sample of
its batch is returned.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import airs_compression_tpu as jx
from airs_compression_tpu.models.stream import (
    BatchCompressor as JBatchCompressor,
    BatchDecompressor as JBatchDecompressor,
)

import airs_compression_tpu_torch as tx
from airs_compression_tpu_torch.models import stream as tstream

B, N, BATCHES = 4, 32, 3

_FLAGSHIP = dict(primary_preprocessing=jx.Preprocessing.DIFF,
                 primary_encoder_type=jx.EncoderType.GOLOMB_ZERO,
                 primary_encoder_param=4, secondary_iterations=15,
                 secondary_preprocessing=jx.Preprocessing.MODEL,
                 secondary_encoder_type=jx.EncoderType.GOLOMB_MULTI,
                 secondary_encoder_param=2, secondary_encoder_outlier=40,
                 model_rate=8, checksum_enabled=True)

# name -> (params, adaptive, ladder, {batch: noisy rows})
CONFIGS = {
    "headline_fixed": (jx.CmpParams(
        primary_preprocessing=jx.Preprocessing.DIFF,
        primary_encoder_type=jx.EncoderType.GOLOMB_ZERO,
        primary_encoder_param=4), False, None, {}),
    "headline_adaptive": (jx.CmpParams(
        primary_preprocessing=jx.Preprocessing.DIFF,
        primary_encoder_type=jx.EncoderType.GOLOMB_ZERO,
        primary_encoder_param=4), True, None, {}),
    "flagship_adaptive": (jx.CmpParams(**_FLAGSHIP), True, None, {}),
    # a fallback in batch 1 resets chain 2; batch 2 then mixes primary and
    # secondary passes, and the fallback frames' identifiers are patched
    "mixed_fallback_adaptive": (jx.CmpParams(
        primary_preprocessing=jx.Preprocessing.DIFF,
        primary_encoder_type=jx.EncoderType.GOLOMB_ZERO,
        primary_encoder_param=2, secondary_iterations=1,
        secondary_preprocessing=jx.Preprocessing.MODEL,
        secondary_encoder_type=jx.EncoderType.GOLOMB_MULTI,
        secondary_encoder_param=2, secondary_encoder_outlier=40,
        model_rate=8, uncompressed_fallback_enabled=True,
        checksum_enabled=True), True, None, {1: (2,)}),
}


class _Stamp:
    """Deterministic timestamp source (same sequence in both packages)."""

    def __init__(self):
        self.counter = 0

    def __call__(self):
        c = self.counter
        self.counter += 1
        return (c >> 16) & 0xFFFFFFFF, c & 0xFFFF


def _port_params(params):
    return tx.params_from_reference(dataclasses.asdict(params))


def _frames(rng, noisy_rows=()):
    f = np.stack([1100 + rng.normal(0, 0.7 * (1 + 3 * b), N)
                  for b in range(B)])
    f = (f.astype(np.int64) & 0xFFFF).astype(np.uint16)
    for r in noisy_rows:
        f[r] = rng.integers(0, 1 << 16, N).astype(np.uint16)
    return f


@functools.lru_cache(maxsize=None)
def _streams(name):
    """Compress BATCHES batches of the config in both packages.

    Returns (frames, jax (stream, sizes) per batch, port (stream, sizes)
    per batch, port compress_frames output per batch).
    """
    params, adaptive, ladder, noisy = CONFIGS[name]
    rng = np.random.default_rng(len(name))
    frames = [_frames(rng, noisy.get(k, ())) for k in range(BATCHES)]
    outs = []
    for pkg, make in (
            (jx, lambda: JBatchCompressor(params, B, N, adaptive=adaptive,
                                          ladder=ladder)),
            (tx, lambda: tx.BatchCompressor(
                _port_params(params), B, N, adaptive=adaptive,
                ladder=ladder, device="cpu"))):
        pkg.set_timestamp_func(_Stamp())
        try:
            bc = make()
            if pkg is jx:
                outs.append([bc.compress_frames_packed(f, assemble="host")
                             for f in frames])
            else:
                outs.append([bc.compress_frames_packed(f) for f in frames])
        finally:
            pkg.set_timestamp_func(None)
    tx.set_timestamp_func(_Stamp())
    try:
        bc = tx.BatchCompressor(_port_params(params), B, N,
                                adaptive=adaptive, ladder=ladder,
                                device="cpu")
        lists = [bc.compress_frames(f) for f in frames]
    finally:
        tx.set_timestamp_func(None)
    return frames, outs[0], outs[1], lists


def _manifest(packed):
    """One file stream of all batches, with its offsets and lengths."""
    stream = b"".join(s for s, _ in packed)
    lens = np.concatenate([z for _, z in packed]).astype(np.int64)
    return stream, np.cumsum(lens) - lens, lens


@pytest.mark.parametrize("name", list(CONFIGS))
def test_packed_stream_matches(name):
    frames, jout, tout, lists = _streams(name)
    for k, ((js, jz), (ts, tz)) in enumerate(zip(jout, tout)):
        assert isinstance(ts, bytes)
        assert ts == js, f"batch {k}"
        np.testing.assert_array_equal(tz, jz)
        assert ts == b"".join(lists[k])
        assert [len(f) for f in lists[k]] == tz.tolist()
    if name.startswith("mixed"):
        # chain 2 fell back (method NONE + UNCOMPRESSED, checksum bit on)
        assert lists[1][2][15] == 0x08 and lists[1][0][15] != 0x08
        # batch 2 restarts the other chains (DIFF primary pass) while chain
        # 2 runs its secondary pass against the noise model and falls back
        assert [f[15] >> 4 for f in lists[2]] == [1, 1, 0, 1]


def test_packed_as_array():
    params = _port_params(CONFIGS["headline_adaptive"][0])
    frames = _frames(np.random.default_rng(1))
    tx.set_timestamp_func(_Stamp())
    try:
        a, za = tx.BatchCompressor(params, B, N, adaptive=True,
                                   device="cpu") \
            .compress_frames_packed(frames, as_array=True)
    finally:
        tx.set_timestamp_func(None)
    tx.set_timestamp_func(_Stamp())
    try:
        s, zs = tx.BatchCompressor(params, B, N, adaptive=True,
                                   device="cpu") \
            .compress_frames_packed(frames)
    finally:
        tx.set_timestamp_func(None)
    assert a.dtype == np.uint8 and a.tobytes() == s
    np.testing.assert_array_equal(za, zs)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_stream_decoders_match(name):
    """decompress_stream(stage_frames_at(...)) and decompress_file_stream
    return the input frames and the JAX package's samples."""
    params, _, _, _ = CONFIGS[name]
    frames, _, packed, _ = _streams(name)
    stream, offs, lens = _manifest(packed)
    td = tx.BatchDecompressor(_port_params(params), B, N, device="cpu")
    staged = (td.stage_frames_at(s, np.cumsum(z) - z, z) for s, z in packed)
    got = list(td.decompress_stream(staged))
    td2 = tx.BatchDecompressor(_port_params(params), B, N, device="cpu")
    got_file = list(td2.decompress_file_stream(stream, offs, lens, depth=2))
    jd = JBatchDecompressor(params, B, N)
    want = list(jd.decompress_file_stream(stream, offs, lens))
    assert len(got) == len(got_file) == len(want) == BATCHES
    for k in range(BATCHES):
        np.testing.assert_array_equal(got[k], frames[k])
        np.testing.assert_array_equal(got_file[k], frames[k])
        np.testing.assert_array_equal(want[k], frames[k])
    # a bytes list is staged by decompress_stream itself
    td3 = tx.BatchDecompressor(_port_params(params), B, N, device="cpu")
    lists = _streams(name)[3]
    for k, out in enumerate(td3.decompress_stream(iter(lists))):
        np.testing.assert_array_equal(out, frames[k])


def _corruptions(stream, offs, lens):
    """(label, stream, offsets, lens) variants of one batch's manifest."""
    first = int(offs[0])
    one = np.eye(B, dtype=np.int64)

    def patch(**at):
        s = bytearray(stream)
        for k, v in at.items():
            s[first + int(k[1:])] = v
        return bytes(s)

    method = stream[first + 15] & 0xF
    return [
        ("span past the end", stream, offs,
         lens + one[-1] * (len(stream) - int(offs[-1] + lens[-1]) + 1)),
        ("negative offset", stream, offs - one[0] * (first + 1), lens),
        ("truncated stream", stream[: int(offs[-1]) + 3], offs, lens),
        ("header truncated", stream, offs,
         np.where(np.arange(B) == 1, 10, lens)),
        ("frame shorter than compressed_size", stream, offs, lens - one[0]),
        ("original size", patch(b7=stream[first + 7] ^ 2), offs, lens),
        ("unknown method", patch(b15=0x50 | method), offs, lens),
        ("MODEL on a primary pass", patch(b15=0x30 | method), offs, lens),
        ("bad Golomb parameter", patch(b17=0, b18=0), offs, lens),
    ]


def _code(fn):
    try:
        fn()
    except (tx.CmpError, jx.CmpError) as e:
        return e.code.name
    return None


@pytest.mark.parametrize("name", ["headline_adaptive", "flagship_adaptive"])
def test_corrupt_stream_errors_match(name):
    """Staging rejects every corruption with the JAX package's error code,
    both through stage_headers_at and stage_frames_at."""
    params, _, _, _ = CONFIGS[name]
    _, _, packed, _ = _streams(name)
    stream, offs, lens = _manifest(packed[:1])
    td = tx.BatchDecompressor(_port_params(params), B, N, device="cpu")
    jd = JBatchDecompressor(params, B, N)
    for label, s, o, z in _corruptions(stream, offs, lens):
        want = _code(lambda: jd.stage_headers_at(s, o, z))
        assert want is not None, label
        assert _code(lambda: td.stage_headers_at(s, o, z)) == want, label
        assert _code(lambda: jd.stage_frames_at(s, o, z)) == want, label
        assert _code(lambda: td.stage_frames_at(s, o, z)) == want, label


@pytest.mark.parametrize("name", ["headline_adaptive", "flagship_adaptive"])
def test_corrupt_payload_raises_as_jax(name):
    """A garbled payload decodes to the JAX package's error (bitstream
    overrun, or checksum mismatch where checksums are on)."""
    params, _, _, _ = CONFIGS[name]
    _, _, packed, _ = _streams(name)
    stream, offs, lens = _manifest(packed[:1])
    s = bytearray(stream)
    at = int(offs[1]) + 22
    s[at: int(offs[1] + lens[1])] = b"\xff" * (int(lens[1]) - 22)
    s = bytes(s)
    td = tx.BatchDecompressor(_port_params(params), B, N, device="cpu")
    jd = JBatchDecompressor(params, B, N)
    want = _code(lambda: list(jd.decompress_file_stream(s, offs, lens)))
    assert want in ("INT_BITSTREAM", "GENERIC")
    assert _code(lambda: list(td.decompress_file_stream(s, offs, lens))) \
        == want
    td2 = tx.BatchDecompressor(_port_params(params), B, N, device="cpu")
    assert _code(lambda: list(td2.decompress_stream(
        [td2.stage_frames_at(s, offs, lens)]))) == want


def test_manifest_must_fill_batches():
    params = _port_params(CONFIGS["headline_fixed"][0])
    td = tx.BatchDecompressor(params, B, N, device="cpu")
    with pytest.raises(tx.CmpError) as e:
        list(td.decompress_file_stream(b"\0" * 64, np.zeros(3),
                                       np.zeros(3)))
    assert e.value.code is tx.CmpErrorCode.SRC_SIZE_WRONG


def test_header_staged_batch_needs_device_stream():
    params = CONFIGS["headline_fixed"][0]
    _, _, packed, _ = _streams("headline_fixed")
    stream, offs, lens = _manifest(packed[:1])
    td = tx.BatchDecompressor(_port_params(params), B, N, device="cpu")
    st = td.stage_headers_at(stream, offs, lens)
    assert st.buf is None and st.row_off is not None
    with pytest.raises(tx.CmpError):
        td.decode_staged(st)
    with pytest.raises(tx.CmpError):
        td.decode_staged_from(td.stage_frames_at(stream, offs, lens),
                              td.upload_stream(stream))
    out = td.finish(st, td.decode_staged_from(st, td.upload_stream(stream)))
    np.testing.assert_array_equal(out, _streams("headline_fixed")[0][0])


_EDGES = [0, 1, -1, 0x7FFF, 0x8000, -0x8000, -0x8001, 0xFFFF, 0x10000,
          0x12345, -0x12345, 2 ** 31 - 1, -2 ** 31]


@pytest.mark.parametrize("values", ["edges", "random", "strided"])
def test_narrowing_keeps_the_low_16_bits(values):
    """The fetch's narrowing gives ``astype(np.uint16)``'s bits for every
    int32 value, outside the int16 range too."""
    rng = np.random.default_rng(17)
    x = rng.integers(-2 ** 31, 2 ** 31, (64, 1024)).astype(np.int32)
    x.reshape(-1)[:len(_EDGES)] = _EDGES
    t = torch.from_numpy(x)
    if values == "edges":
        x, t = x[:1, :len(_EDGES)], t[:1, :len(_EDGES)]
    elif values == "strided":
        x, t = x[::3, 1::2], t[::3, 1::2]
    got = tstream._fetch_u16(t)
    assert got.dtype == np.int16 and got.flags.c_contiguous
    np.testing.assert_array_equal(got.view(np.uint16), x.astype(np.uint16))


def _files(params, cmp_type, n_files=3, per_file=3, seed=23):
    """``n_files`` files of ``per_file`` batches of one chain (full-range
    rows in every batch), with their (B, N) uint16 frames."""
    rng = np.random.default_rng(seed)
    bc = tx.BatchCompressor(params, B, N, cmp_type=cmp_type, device="cpu")
    files = []
    for _ in range(n_files):
        frames = [_frames(rng, (1, 3)) for _ in range(per_file)]
        if cmp_type is tx.CmpType.I16:
            frames = [f.view(np.int16) for f in frames]
        packed = [bc.compress_frames_packed(f) for f in frames]
        files.append((*_manifest(packed),
                      [f.view(np.uint16) for f in frames]))
    return files


@pytest.mark.parametrize("name,cmp_type,coalesce", [
    ("headline_fixed", "U16", None),
    ("headline_fixed", "U16", False),
    ("headline_fixed", "I16", None),
    ("headline_fixed", "I16", False),
    # MODEL chains decode batch by batch
    ("flagship_adaptive", "U16", None),
    ("flagship_adaptive", "I16", None),
])
def test_finish_returns_owned_u16(name, cmp_type, coalesce):
    """Grouped or not, every window is a C-contiguous (B, N) uint16 array
    of the frames, and no later decode by the same decompressor changes
    it."""
    cmp_type = tx.CmpType[cmp_type]
    params = _port_params(CONFIGS[name][0])
    files = _files(params, cmp_type)
    td = tx.BatchDecompressor(params, B, N, cmp_type=cmp_type, device="cpu")
    kept = None
    for stream, offs, lens, frames in files:
        got = list(td.decompress_file_stream(stream, offs, lens,
                                             coalesce=coalesce))
        assert len(got) == len(frames)
        for out, want in zip(got, frames):
            assert out.dtype == np.uint16 and out.shape == (B, N)
            assert out.flags.c_contiguous
            np.testing.assert_array_equal(out, want)
        if kept is None:
            kept, copies = got, [o.copy() for o in got]
    for out, copy in zip(kept, copies):
        np.testing.assert_array_equal(out, copy)


def _corrupt(stream, offs, lens, how):
    """``stream`` with batch 1's block 0 garbled: its payload filled with
    ones (an overrun) or its stored checksum's last byte flipped."""
    s = bytearray(stream)
    at, n = int(offs[B]), int(lens[B])
    if how == "payload":
        s[at + 22: at + n] = b"\xff" * (n - 22)
    else:
        s[at + n - 1] ^= 0x01
    return bytes(s)


@pytest.mark.parametrize("how,code", [("payload", "INT_BITSTREAM"),
                                      ("checksum", "GENERIC")])
@pytest.mark.parametrize("coalesce", [None, False])
def test_corrupt_batch_raises_before_its_samples(how, code, coalesce):
    """A payload overrun or a checksum mismatch in batch 1 of a file
    raises its ``CmpError`` on the grouped and the ungrouped path, after
    batch 0's samples and before any of batch 1's."""
    params = _port_params(dataclasses.replace(
        CONFIGS["headline_fixed"][0], checksum_enabled=True))
    (stream, offs, lens, frames), = _files(params, tx.CmpType.U16, 1)
    bad = _corrupt(stream, offs, lens, how)
    td = tx.BatchDecompressor(params, B, N, device="cpu")
    got = []
    with pytest.raises(tx.CmpError) as e:
        for out in td.decompress_file_stream(bad, offs, lens,
                                             coalesce=coalesce):
            got.append(out)
    assert e.value.code.name == code
    assert len(got) == 1
    np.testing.assert_array_equal(got[0], frames[0])
