"""Port parity, encode side: ops/encode.py and BatchCompressor vs JAX.

Frames from the PyTorch port (CPU tensors: every kernel wrapper runs its
plain version) must equal the JAX package's frames byte for byte, with
synchronized timestamp stubs installed in both packages.  Shapes are small
and shared across the tests of this module, so each JAX program compiles
once.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import airs_compression_tpu as jx
from airs_compression_tpu.format.dtypes import CmpType as JCmpType
from airs_compression_tpu.models.stream import BatchCompressor as JBatchCompressor
from airs_compression_tpu.ops import encode as j_encode

import airs_compression_tpu_torch as tx
from airs_compression_tpu_torch.ops import encode as t_encode

B, N = 4, 32

CONFIGS = {
    # bench.py:149-158 headline: DIFF + GOLOMB_ZERO, g=4
    "headline": jx.CmpParams(primary_preprocessing=jx.Preprocessing.DIFF,
                             primary_encoder_type=jx.EncoderType.GOLOMB_ZERO,
                             primary_encoder_param=4),
    # __graft_entry__.py:21-34 flagship chain, checksummed
    "flagship": jx.CmpParams(
        primary_preprocessing=jx.Preprocessing.DIFF,
        primary_encoder_type=jx.EncoderType.GOLOMB_ZERO,
        primary_encoder_param=4,
        secondary_iterations=15,
        secondary_preprocessing=jx.Preprocessing.MODEL,
        secondary_encoder_type=jx.EncoderType.GOLOMB_MULTI,
        secondary_encoder_param=2, secondary_encoder_outlier=40,
        model_rate=8, checksum_enabled=True),
    # tests/test_oracle_parity.py CONFIGS[-1]: the fallback config
    "fallback": jx.CmpParams(primary_preprocessing=jx.Preprocessing.IWT,
                             primary_encoder_type=jx.EncoderType.GOLOMB_ZERO,
                             primary_encoder_param=3,
                             uncompressed_fallback_enabled=True,
                             checksum_enabled=True),
}


class _Stamp:
    """Deterministic timestamp source (same sequence in both packages)."""

    def __init__(self):
        self.counter = 0

    def __call__(self):
        c = self.counter
        self.counter += 1
        return (c >> 16) & 0xFFFFFFFF, c & 0xFFFF


@pytest.fixture()
def synced_stamps():
    stamps = _Stamp(), _Stamp()
    jx.set_timestamp_func(stamps[0])
    tx.set_timestamp_func(stamps[1])
    yield stamps
    jx.set_timestamp_func(None)
    tx.set_timestamp_func(None)


def _port_params(params):
    return tx.params_from_reference(dataclasses.asdict(params))


def _frames(rng, noisy_rows=()):
    f = ((1100 + rng.normal(0, 6, (B, N))).astype(np.int64)
         & 0xFFFF).astype(np.uint16)
    for r in noisy_rows:
        f[r] = rng.integers(0, 1 << 16, N).astype(np.uint16)
    return f


def test_params_from_reference_roundtrip():
    for params in CONFIGS.values():
        mine = _port_params(params)
        assert dataclasses.asdict(mine) == dataclasses.asdict(params)
        assert isinstance(mine.primary_preprocessing, tx.Preprocessing)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_encode_blocks_device_matches(name):
    """words, sizes and fell_back of one engine pass, primary and (for the
    chain) secondary, on the same inputs."""
    params = CONFIGS[name]
    rng = np.random.default_rng(len(name))
    x = _frames(rng, noisy_rows=(1,)).view(np.int16).astype(np.int32)
    model = _frames(rng).view(np.int16).astype(np.int32)
    seq = np.array([0, 1, 2, 3], np.int32)
    ids = rng.integers(0, 1 << 48, B)
    id_hi, id_lo = (ids >> 24) & 0xFFFFFF, ids & 0xFFFFFF
    csum = rng.integers(0, 1 << 32, B, dtype=np.int64)
    passes = [False] + ([True] if params.secondary_iterations else [])
    n_words = max(t_encode.worst_case_words(
        t_encode.make_pass_config(_port_params(params), s), N)
        for s in passes)
    for secondary in passes:
        jcfg = j_encode.make_pass_config(params, secondary, True)
        tcfg = t_encode.make_pass_config(_port_params(params), secondary)
        jfb = tfb = None
        if params.uncompressed_fallback_enabled:
            fbp = dataclasses.replace(
                params, primary_preprocessing=jx.Preprocessing.NONE,
                primary_encoder_type=jx.EncoderType.UNCOMPRESSED)
            jfb = j_encode.make_pass_config(fbp, False, True)
            tfb = t_encode.make_pass_config(_port_params(fbp), False)
        # the JAX batch compressor's own static arguments (entropy clamp
        # included), so this module compiles each JAX program once
        jw, js, jf = j_encode.encode_blocks_device(
            jcfg, jfb, jnp.asarray(x), jnp.asarray(model), jnp.asarray(seq),
            jnp.asarray(id_hi.astype(np.uint32)),
            jnp.asarray(id_lo.astype(np.uint32)),
            jnp.asarray(csum.astype(np.uint32)), n_words,
            cap_bits=j_encode.default_cap_bits(jcfg))[:3]
        tw, ts, tf = t_encode.encode_blocks_device(
            tcfg, tfb, torch.from_numpy(x), torch.from_numpy(model),
            torch.from_numpy(seq), torch.from_numpy(id_hi),
            torch.from_numpy(id_lo), torch.from_numpy(csum), n_words)
        np.testing.assert_array_equal(tw.numpy(),
                                      np.asarray(jw).astype(np.int64))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        if params.uncompressed_fallback_enabled:
            assert tf.numpy()[1]  # the noise row fell back


def _compare_chain(params, n_frames, rng, noisy=None, carry=None):
    """Compress n_frames batches in both packages; frames must be equal.
    Returns the port's frames, one list per batch.

    With ``carry=(k, stamps)`` the port starts at frame k from the JAX
    compressor's chain state and timestamp count (the chain carried
    across packages)."""
    start, stamps = carry or (0, None)
    out = []
    jb = JBatchCompressor(params, B, N)
    tb = tx.BatchCompressor(_port_params(params), B, N, device="cpu")
    td = tx.BatchDecompressor(_port_params(params), B, N, device="cpu")
    for f in range(n_frames):
        frames = _frames(rng, noisy_rows=(noisy or {}).get(f, ()))
        if f == start and f:
            tb.load_state(np.asarray(jb.model), jb.seq, jb.identifiers,
                          jb._started)
            stamps[1].counter = stamps[0].counter
        expected = jb.compress_frames(frames)
        if f < start:
            continue
        mine = tb.compress_frames(frames)
        assert mine == expected, f"frame {f}"
        if not start:
            np.testing.assert_array_equal(td.decompress_frames(mine), frames)
        out.append(mine)
    return out


@pytest.mark.parametrize("name", list(CONFIGS))
def test_batch_compressor_bytes_match(name, synced_stamps):
    params = CONFIGS[name]
    n_frames = 4 if params.secondary_iterations else 2
    # noise rows: fallbacks (and, in the chain, a mixed-phase batch)
    _compare_chain(params, n_frames, np.random.default_rng(3),
                   noisy={1: (2,)})


def test_fallback_in_model_chain_matches(synced_stamps):
    """A mid-chain fallback resets one chain, so a later batch mixes
    primary and secondary passes; the fallback identifiers are patched."""
    params = jx.CmpParams(primary_preprocessing=jx.Preprocessing.DIFF,
                          primary_encoder_type=jx.EncoderType.GOLOMB_ZERO,
                          primary_encoder_param=2,
                          secondary_iterations=2,
                          secondary_preprocessing=jx.Preprocessing.MODEL,
                          secondary_encoder_type=jx.EncoderType.GOLOMB_ZERO,
                          secondary_encoder_param=2, model_rate=8,
                          uncompressed_fallback_enabled=True)
    frames = _compare_chain(params, 5, np.random.default_rng(4),
                            noisy={1: (1,)})
    assert frames[1][1][15] == 0  # chain 1 fell back: NONE + UNCOMPRESSED
    # batch 3 restarts the other chains (seq 0) while chain 1, reset by
    # its fallbacks, stays on a secondary pass
    seqs = [f[14] for f in frames[3]]
    assert seqs[0] == 0 and seqs[1] > 0


def test_chain_state_carried_from_jax(synced_stamps):
    """Stop the flagship chain after two JAX frames; the port continues it
    with identical bytes."""
    _compare_chain(CONFIGS["flagship"], 4, np.random.default_rng(5),
                   carry=(2, synced_stamps))


def test_reset_matches(synced_stamps):
    """reset() restarts every chain with fresh identifiers, as in JAX."""
    params = CONFIGS["headline"]
    rng = np.random.default_rng(6)
    jb = JBatchCompressor(params, B, N)
    tb = tx.BatchCompressor(_port_params(params), B, N, device="cpu")
    for step in range(3):
        if step == 1:
            jb.reset()
            tb.reset()
        frames = _frames(rng)
        assert tb.compress_frames(frames) == jb.compress_frames(frames)
    np.testing.assert_array_equal(tb.identifiers, jb.identifiers)


@pytest.mark.parametrize("layout", ["I16", "I16_IN_I32"])
def test_signed_input_layouts_match(layout, synced_stamps):
    """I16 and I16_IN_I32 inputs (signed model arithmetic; the upper
    halves of I16_IN_I32 words are ignored) give the JAX package's bytes."""
    params = CONFIGS["headline"]
    rng = np.random.default_rng(8)
    frames = _frames(rng).view(np.int16)
    if layout == "I16_IN_I32":
        frames = (frames.astype(np.int32) & 0xFFFF) | (0x5A5A << 16)
    jb = JBatchCompressor(params, B, N, cmp_type=JCmpType[layout])
    tb = tx.BatchCompressor(_port_params(params), B, N,
                            cmp_type=tx.CmpType[layout], device="cpu")
    assert tb.compress_frames(frames) == jb.compress_frames(frames)


@pytest.mark.parametrize("form", ["u16", "i16", "i16_in_i32", "list",
                                  "fortran", "sliced"])
def test_input_forms_match(form, synced_stamps):
    """Four batches of a 3-pass checksummed MODEL chain, the frames given
    as C-ordered u16, i16, I16_IN_I32 words with junk upper halves, a
    list, a Fortran-ordered array or a strided slice: the packed streams
    equal the JAX package's frames byte for byte."""
    params = dataclasses.replace(CONFIGS["flagship"], secondary_iterations=2)
    layout = {"i16": "I16", "i16_in_i32": "I16_IN_I32"}.get(form, "U16")
    rng = np.random.default_rng(21)
    jb = JBatchCompressor(params, B, N, cmp_type=JCmpType[layout])
    tb = tx.BatchCompressor(_port_params(params), B, N,
                            cmp_type=tx.CmpType[layout], device="cpu")
    given = {"list": lambda f: f.tolist(),
             "fortran": np.asfortranarray,
             "sliced": lambda f: np.repeat(f, 2, axis=1)[:, ::2]}
    for _ in range(4):
        frames = _frames(rng, noisy_rows=(1,))
        if form == "i16":
            frames = frames.view(np.int16)
        elif form == "i16_in_i32":
            frames = (frames.view(np.int16).astype(np.int32) & 0xFFFF) \
                | (0x5A5A << 16)
        want = jb.compress_frames(frames)
        stream, sizes = tb.compress_frames_packed(
            given.get(form, lambda f: f)(frames))
        assert list(sizes) == [len(w) for w in want]
        assert stream == b"".join(want)


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tx.BatchCompressor(_port_params(CONFIGS["headline"]), B, N)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tx.BatchDecompressor(_port_params(CONFIGS["headline"]), B, N)
