"""The batch encode's upload (``BatchCompressor._upload_frames``).

A C-ordered, writeable u16 frame array is uploaded as it is: no host
copy comes before the copy to the device, and the samples are widened
to int32 there.  Any other input (i16, I16_IN_I32 words, a list, a
Fortran-ordered, strided or read-only array) is first made one C-ordered
u16 copy.  A frame array of the wrong shape raises before any copy.

The tests marked ``card`` hold the card's frames to the CPU's, byte for
byte, for every input layout and the adaptive encoder, with the caller's
array overwritten after each call, and hold the counters to the copies'
sizes; they skip without a card.  On the card: ``python -m pytest
tests/test_torch_encode_upload.py -m card --noconftest -q`` (this file
imports no JAX).
"""

import warnings

import numpy as np
import pytest
import torch

import airs_compression_tpu_torch as tx
from airs_compression_tpu_torch.models import stream as tstream

# a 3-pass checksummed MODEL chain: a primary pass, then two MODEL passes
CHAIN = tx.CmpParams(primary_preprocessing=tx.Preprocessing.DIFF,
                     primary_encoder_type=tx.EncoderType.GOLOMB_ZERO,
                     primary_encoder_param=4, secondary_iterations=2,
                     secondary_preprocessing=tx.Preprocessing.MODEL,
                     secondary_encoder_type=tx.EncoderType.GOLOMB_MULTI,
                     secondary_encoder_param=2, secondary_encoder_outlier=40,
                     model_rate=8, checksum_enabled=True)
LAYOUTS = {"u16": "U16", "i16": "I16", "i16_in_i32": "I16_IN_I32",
           "fortran": "U16", "sliced": "U16", "read_only": "U16"}


class _Stamp:
    """Deterministic timestamp source: every chain run draws the same
    identifiers."""

    def __init__(self):
        self.counter = 0

    def __call__(self):
        c = self.counter
        self.counter += 1
        return (c >> 16) & 0xFFFFFFFF, c & 0xFFFF


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the card")
    return torch.device("cuda", 0)


def _samples(seed, batches, b, n):
    """u16 frames around 1100 with full-range hits (MULTI escapes)."""
    rng = np.random.default_rng(seed)
    x = (1100 + rng.normal(0, 6, (batches, b, n))).astype(np.int64)
    hits = rng.random((batches, b, n)) < 1e-3
    x[hits] = rng.integers(0, 1 << 16, int(hits.sum()))
    return (x & 0xFFFF).astype(np.uint16)


def _as_layout(frame: np.ndarray, layout: str) -> np.ndarray:
    """One (B, N) u16 frame in the input layout ``layout``."""
    if layout == "i16":
        return frame.view(np.int16)
    if layout == "i16_in_i32":
        # the upper halves are junk the encoder ignores
        return (frame.astype(np.int32) & 0xFFFF) | (0x5A5A << 16)
    if layout == "fortran":
        return np.asfortranarray(frame)
    if layout == "sliced":
        wide = np.zeros((frame.shape[0], 2 * frame.shape[1]), np.uint16)
        wide[:, ::2] = frame
        return wide[:, ::2]
    if layout == "read_only":
        frame.flags.writeable = False
    return frame


def _chain(frames, layout, device, overwrite=False, adaptive=False):
    """The packed streams and sizes of ``frames`` through one compressor
    on ``device``, the identifiers from a fresh deterministic stamp; with
    ``overwrite`` the caller's array is zeroed right after each call."""
    _, b, n = frames.shape
    tx.set_timestamp_func(_Stamp())
    try:
        bc = tx.BatchCompressor(CHAIN, b, n,
                                cmp_type=tx.CmpType[LAYOUTS[layout]],
                                adaptive=adaptive, device=device)
        out = []
        for f in frames:
            arr = _as_layout(f.copy(), layout)
            stream, sizes = bc.compress_frames_packed(arr, as_array=True)
            if overwrite:
                arr[...] = 0
            out.append((stream.copy(), sizes.copy()))
        return out
    finally:
        tx.set_timestamp_func(None)


def _equal(got, want):
    assert len(got) == len(want)
    for (gs, gz), (ws, wz) in zip(got, want):
        assert np.array_equal(gz, wz)
        assert gs.tobytes() == ws.tobytes()


@pytest.mark.parametrize("shape", [(64,), (4, 65), (1, 64), (5, 64)])
def test_misshaped_frames_raise_before_any_copy(shape):
    """A (N,), (B, N+1), (1, N) or (B+1, N) input raises SRC_SIZE_WRONG,
    is never broadcast, and leaves the chains as they were."""
    bc = tx.BatchCompressor(CHAIN, 4, 64, device="cpu")
    seq, ids = bc.seq.copy(), bc.identifiers.copy()
    with pytest.raises(tx.CmpError) as err:
        bc.compress_frames_packed(np.ones(shape, np.uint16))
    assert err.value.code == tx.CmpErrorCode.SRC_SIZE_WRONG
    assert np.array_equal(bc.seq, seq)
    assert np.array_equal(bc.identifiers, ids)


def test_i16_in_i32_needs_32_bit_words():
    bc = tx.BatchCompressor(CHAIN, 4, 64, cmp_type=tx.CmpType.I16_IN_I32,
                            device="cpu")
    with pytest.raises(tx.CmpError) as err:
        bc.compress_frames_packed(np.ones((4, 64), np.int16))
    assert err.value.code == tx.CmpErrorCode.SRC_SIZE_WRONG


def test_c_ordered_u16_frames_upload_without_a_host_copy(monkeypatch):
    """The samples handed to the upload share the caller's memory for a
    C-ordered, writeable u16 array; an i16 array is copied once."""
    seen = []
    upload = tstream._upload

    def spy(array, device):
        seen.append(array)
        return upload(array, device)

    monkeypatch.setattr(tstream, "_upload", spy)
    frames = _samples(3, 1, 4, 64)[0]
    tx.BatchCompressor(CHAIN, 4, 64, device="cpu").compress_frames_packed(
        frames)
    assert np.shares_memory(seen[0], frames)
    seen.clear()
    tx.BatchCompressor(CHAIN, 4, 64, cmp_type=tx.CmpType.I16,
                       device="cpu").compress_frames_packed(
        frames.view(np.int16))
    assert not np.shares_memory(seen[0], frames)


def test_read_only_frames_encode_as_writeable_ones():
    """A read-only frame array is copied before the upload (torch takes
    no read-only memory) and encodes as its writeable twin does."""
    frames = _samples(5, 3, 4, 64)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        got = _chain(frames, "read_only", "cpu")
    _equal(got, _chain(frames, "u16", "cpu"))


@pytest.mark.card
@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_chain_on_the_card_equals_the_cpu(card, layout, adaptive):
    """Four batches of a 3-pass checksummed MODEL chain (a primary pass,
    two MODEL passes, a primary pass again) in each input layout, with
    fixed or adaptive Golomb parameters: the card's streams and sizes
    equal the CPU compressor's, byte for byte."""
    frames = _samples(7, 4, 64, 1024)
    _equal(_chain(frames, layout, card, adaptive=adaptive),
           _chain(frames, layout, "cpu", adaptive=adaptive))


@pytest.mark.card
def test_caller_may_overwrite_frames_after_each_call(card):
    """Frames A, B, then A again through one compressor, the caller's
    array zeroed right after each call returns: every output equals the
    CPU's for the same chain."""
    a, b = _samples(11, 2, 64, 1024)
    frames = np.stack([a, b, a])
    _equal(_chain(frames, "u16", card, overwrite=True),
           _chain(frames, "u16", "cpu"))


@pytest.mark.card
def test_counters_on_the_card_count_the_uploaded_bytes(card):
    """One batch adds its uploaded bytes (the 2BN sample bytes, the
    chains' int32 sequence numbers and two int64 identifier halves) to
    the pageable upload counter, and the sizes, the fallback flags and
    the stream's bytes to the fetch's."""
    b, n = 64, 1024
    f0, f1 = _samples(13, 2, b, n)
    bc = tx.BatchCompressor(CHAIN, b, n, device=card)
    bc.compress_frames_packed(f0)                            # warm-up
    torch.cuda.synchronize()
    before = (tstream._upload.pageable_bytes, tstream._fetch.pageable_bytes)
    stream, sizes = bc.compress_frames_packed(f1, as_array=True)
    after = (tstream._upload.pageable_bytes, tstream._fetch.pageable_bytes)
    assert after[0] - before[0] == 2 * b * n + (4 + 8 + 8) * b
    assert after[1] - before[1] == 4 * b + b + stream.size
    assert stream.size == int(sizes.sum())
