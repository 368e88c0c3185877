"""Port parity, op level: airs_compression_tpu_torch.ops vs the JAX package.

The same numpy inputs (seeded) go through the JAX function, pinned to the
CPU by conftest, and through its counterpart in the PyTorch port on CPU
tensors, where each kernel wrapper runs its plain version.  Where the JAX
function would reach a Pallas kernel, the comparison is against its XLA
reference path (``bitpack.pack_codes_tree``, the scan decoder of
``decode_blocks_device``, ``xxh32_blocks``), which the JAX package's own
tests pin bit-exact to its kernels.  Every comparison is exact.
"""

import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from airs_compression_tpu.ops import bitpack as j_bitpack
from airs_compression_tpu.ops import decode as j_decode
from airs_compression_tpu.ops import golomb as j_golomb
from airs_compression_tpu.ops import preprocess as j_pre
from airs_compression_tpu.ops import xxh32_device as j_xxh
from airs_compression_tpu.utils.xxh32 import cmp_checksum

from airs_compression_tpu_torch.ops import assemble as t_asm
from airs_compression_tpu_torch.ops import decode as t_decode
from airs_compression_tpu_torch.ops import encode as t_encode
from airs_compression_tpu_torch.ops import golomb as t_golomb
from airs_compression_tpu_torch.ops import pack as t_pack
from airs_compression_tpu_torch.ops import preprocess as t_pre
from airs_compression_tpu_torch.ops import xxh32_device as t_xxh
from airs_compression_tpu_torch.ops.decode_kernel import decode_blocks
from airs_compression_tpu_torch.ops.u32 import from_bits, to_bits

EXTREMES = np.array([0, 1, -1, 2, -2, 0x7FFF, -0x8000, 0x7FFE, -0x7FFF],
                    np.int64)


def _i16(rng, shape, spread=None):
    """Sign-extended i16 samples: wide or narrow noise plus extremes."""
    if spread is None:
        v = rng.integers(-0x8000, 0x8000, shape)
    else:
        v = rng.integers(-spread, spread + 1, shape)
    flat = v.reshape(-1)
    k = min(flat.size, EXTREMES.size)
    flat[rng.choice(flat.size, k, replace=False)] = EXTREMES[:k]
    return flat.reshape(shape).astype(np.int32)


def _same(t, j):
    np.testing.assert_array_equal(np.asarray(t), np.asarray(j))


# -- preprocess -------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 5, 7, 8, 33])
def test_preprocess_matches(n):
    rng = np.random.default_rng(n)
    x = _i16(rng, (3, n))
    model = _i16(rng, (3, n))
    tx, tm = torch.from_numpy(x), torch.from_numpy(model)
    jx, jm = jnp.asarray(x), jnp.asarray(model)
    _same(t_pre.wrap16(torch.from_numpy(x * 7)), j_pre.wrap16(jx * 7))
    for method in (0, 1, 2, 3):
        fwd = t_pre.preprocess_forward(method, tx, tm)
        _same(fwd, j_pre.preprocess_forward(method, jx, jm))
        _same(t_pre.preprocess_inverse(method, fwd, tm),
              j_pre.preprocess_inverse(method, jnp.asarray(fwd.numpy()), jm))
        _same(t_pre.preprocess_inverse(method, fwd, tm), x)
    for rate in (0, 8, 16):
        for unsigned in (False, True):
            _same(t_pre.model_update(tx, tm, rate, unsigned),
                  j_pre.model_update(jx, jm, jnp.int32(rate), unsigned))


# -- golomb -------------------------------------------------------------------

GOLOMB_CONFIGS = [(0, 0), (1, 1), (1, 4), (1, 7), (1, 0xFFFF),
                  (2, 2), (2, 5), (2, 0xFFFF)]


def _outlier(enc, g):
    from airs_compression_tpu.utils.bits import derive_encoder_outlier

    return derive_encoder_outlier(enc, g, 40 if g < 10 else 0xFFFFFFFF)


@pytest.mark.parametrize("enc,g", GOLOMB_CONFIGS)
def test_golomb_matches(enc, g):
    rng = np.random.default_rng(g + 10 * enc)
    r = _i16(rng, (4, 257), spread=None if g > 4 else 300)
    outlier = _outlier(enc, g)
    t_out = t_golomb.encode_codewords(torch.from_numpy(r), enc, g, outlier)
    j_out = j_golomb.encode_codewords(jnp.asarray(r), enc, g, outlier)
    for a, b in zip(t_out, j_out):
        _same(a, b)
    m = t_golomb.zigzag(torch.from_numpy(r))
    _same(m, j_golomb.zigzag(jnp.asarray(r)))
    _same(t_golomb.unzigzag(m.to(torch.int32)), r)
    v = torch.from_numpy(rng.integers(0, 1 << 32, 500, dtype=np.int64))
    _same(t_golomb.ilog2(v),
          j_golomb.ilog2(jnp.asarray(v.numpy().astype(np.uint32))))


@pytest.mark.parametrize("enc,g", GOLOMB_CONFIGS + [(1, 3), (2, 1)])
def test_code_lengths_match(enc, g):
    """The lengths-only pass equals the JAX codes' lengths, escapes and
    full-range residuals included."""
    rng = np.random.default_rng(7 + g + 10 * enc)
    r = np.concatenate([_i16(rng, (1, 2000), spread=300)[0],
                        _i16(rng, (1, 2000), spread=None)[0],
                        [-32768, 32767, 0, -1, 1]]).astype(np.int32)
    outlier = _outlier(enc, g)
    _same(t_golomb.code_lengths(torch.from_numpy(r), enc, g, outlier),
          j_golomb.encode_codewords(jnp.asarray(r), enc, g, outlier)[2])


# -- packer (kernel K1's plain version) ---------------------------------------

PACK_K = 64
PACK_CASES = ([(n, 1, 4) for n in (1, 7, PACK_K)]
              + [(n, 2, 2) for n in (1, 7, PACK_K)] + [(PACK_K, 1, 0xFFFF)])


@pytest.mark.parametrize("n,enc,g", PACK_CASES)
def test_pack_matches_pack_codes_tree(n, enc, g):
    rng = np.random.default_rng(n + g)
    r = _i16(rng, (5, n), spread=40)
    outlier = _outlier(enc, g)
    payload, bits = t_pack.pack_residuals(torch.from_numpy(r), enc, g,
                                          outlier)
    assert payload.shape == (5, t_pack.payload_words(enc, g, n))
    hi, lo, lens = j_golomb.encode_codewords(jnp.asarray(r), enc, g, outlier)
    # zero-length codes are no-ops: every n pads to one K, so the JAX
    # packer compiles once per code width
    pad = ((0, 0), (0, PACK_K - n))
    j_words, j_bits = j_bitpack.pack_codes_tree(
        jnp.pad(hi, pad), jnp.pad(lo, pad), jnp.pad(lens, pad),
        t_pack.worst_bits(enc, g))
    _same(bits, j_bits)
    words = from_bits(payload).numpy()
    j_words = np.asarray(j_words).astype(np.int64)
    used = int(-(-int(bits.max()) // 32))
    _same(words[:, :used], j_words[:, :used])
    assert not words[:, used:].any() and not j_words[:, used:].any()


# -- XXH32 (kernel K4's plain version) ----------------------------------------

@pytest.mark.parametrize("n", [1, 7, 8, 64, 256])
def test_xxh32_matches(n):
    rng = np.random.default_rng(n)
    x = _i16(rng, (6, n))
    got = t_xxh.checksum_blocks_device(torch.from_numpy(x)).numpy()
    _same(got, j_xxh.xxh32_blocks(jnp.asarray(x)))
    _same(got, [cmp_checksum(row.astype(np.uint16)) for row in x])


# -- decoder (kernel K3's plain version) --------------------------------------

DECODE_CONFIGS = [
    dict(prep=1, enc=1, g=4),            # headline: DIFF + ZERO, g=4
    dict(prep=3, enc=2, g=2, o=40),      # flagship secondary: MODEL + MULTI
    dict(prep=2, enc=2, g=5, o=80),      # IWT + MULTI
    dict(prep=1, enc=0, g=0),            # DIFF + UNCOMPRESSED
]


def _pass_configs(c):
    from airs_compression_tpu.ops.encode import PassConfig as JPassConfig

    from airs_compression_tpu.utils.bits import derive_encoder_outlier

    o = derive_encoder_outlier(c["enc"], c["g"], c.get("o", 0))
    args = (c["prep"], c["enc"], c["g"], o, False, 8)
    return (JPassConfig(*args, model_needed=c["prep"] == 3,
                        unsigned_model=True), t_encode.PassConfig(*args))


@pytest.mark.parametrize("ci", range(len(DECODE_CONFIGS)))
def test_decode_blocks_device_matches(ci):
    jcfg, tcfg = _pass_configs(DECODE_CONFIGS[ci])
    rng = np.random.default_rng(ci)
    B, N = 4, 64
    x = rng.integers(970, 1031, (B, N)).astype(np.int32)
    model = rng.integers(970, 1031, (B, N)).astype(np.int32)
    seq = np.ones(B, np.int32)
    ids = np.arange(B, dtype=np.int64)
    n_words = t_encode.worst_case_words(tcfg, N)
    words, sizes, _ = t_encode.encode_blocks_device(
        tcfg, None, torch.from_numpy(x), torch.from_numpy(model),
        torch.from_numpy(seq), torch.from_numpy(ids), torch.from_numpy(ids),
        torch.zeros(B, dtype=torch.int64), n_words)
    w32 = words.numpy().astype(np.uint32)
    # valid frames, then the same rows with a corrupted payload (malformed
    # codes: poisoned end positions); the last words stay zero in both
    junk = w32.copy()
    junk[:, 6:n_words - 3] = rng.integers(0, 1 << 32, (B, n_words - 9),
                                          dtype=np.uint64).astype(np.uint32)
    for rows in (w32, junk):
        t_s, t_e = t_decode.decode_blocks_device(
            tcfg, torch.from_numpy(rows.view(np.int32)),
            torch.from_numpy(model), N)
        j_s, j_e = j_decode.decode_blocks_device(
            jcfg, jnp.asarray(rows), jnp.asarray(model), N)
        _same(t_s, j_s)
        _same(t_e, j_e)
    t_s, _ = t_decode.decode_blocks_device(
        tcfg, torch.from_numpy(w32.view(np.int32)), torch.from_numpy(model),
        N)
    _same(t_s, x)


def test_decode_per_block_parameters():
    """One call with per-block g/outlier decodes blocks encoded under
    different parameters (the header-driven path)."""
    rng = np.random.default_rng(7)
    N = 48
    rows, x_all, gs, outs = [], [], [], []
    for g in (1, 3, 4, 9):
        _, tcfg = _pass_configs(dict(prep=1, enc=1, g=g))
        x = _i16(rng, (1, N), spread=20)
        w, _, _ = t_encode.encode_blocks_device(
            tcfg, None, torch.from_numpy(x), torch.zeros_like(
                torch.from_numpy(x)), torch.zeros(1, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int64), torch.zeros(1,
                                                           dtype=torch.int64),
            torch.zeros(1, dtype=torch.int64), 64)
        rows.append(w)
        x_all.append(x)
        gs.append(g)
        outs.append(tcfg.outlier)
    _, tcfg = _pass_configs(dict(prep=1, enc=1, g=4))
    from airs_compression_tpu_torch.ops.u32 import to_bits

    s, e = t_decode.decode_blocks_device(
        tcfg, to_bits(torch.cat(rows)), None, N, torch.tensor(gs),
        torch.tensor(outs))
    _same(s, np.concatenate(x_all))
    vals, e2 = decode_blocks(to_bits(torch.cat(rows)), tcfg.hdr_bits, N, 1,
                             torch.tensor(gs), torch.tensor(outs))
    _same(e, e2)
    assert vals.dtype == torch.int32


# -- codes packer (kernel K2's plain version) ---------------------------------

def _codes(rng, b, k, max_bits):
    """(hi, lo, lens) clean codes of 0..max_bits bits, a quarter of them
    zero-length pads, as uint32/int32 numpy arrays."""
    lens = rng.integers(1, max_bits + 1, (b, k))
    lens[rng.random((b, k)) < 0.25] = 0
    lens[:, -1] = max_bits
    val = rng.integers(0, 1 << 63, (b, k), dtype=np.uint64) \
        >> (64 - lens).astype(np.uint64)
    val[lens == 0] = 0
    return ((val >> 32).astype(np.uint32), (val & 0xFFFFFFFF)
            .astype(np.uint32), lens.astype(np.int32))


@pytest.mark.parametrize("k,max_bits", [(1, 48), (7, 29), (64, 48),
                                        (64, 32), (33, 16)])
def test_pack_codes_matches_pack_codes_tree(k, max_bits):
    """pack_codes (CPU: its plain version) against bitpack.pack_codes_tree,
    K padded to a power of two with zero-length codes on the JAX side."""
    rng = np.random.default_rng(k + max_bits)
    hi, lo, lens = _codes(rng, 5, k, max_bits)
    hi_t = torch.from_numpy(hi.astype(np.int64)) if max_bits > 32 else None
    payload, bits = t_pack.pack_codes(hi_t, torch.from_numpy(lo.view(
        np.int32)), torch.from_numpy(lens), max_bits)
    assert payload.shape == (5, t_pack.code_words(max_bits, k))
    kp = 1 << max(k - 1, 0).bit_length()
    pad = ((0, 0), (0, kp - k))
    j_words, j_bits = j_bitpack.pack_codes_tree(
        jnp.pad(hi, pad), jnp.pad(lo, pad), jnp.pad(lens, pad), max_bits)
    _same(bits, j_bits)
    words = from_bits(payload).numpy()
    j_words = np.asarray(j_words).astype(np.int64)
    used = int(-(-int(bits.max()) // 32))
    _same(words[:, :used], j_words[:, :used])
    assert not words[:, used:].any()


def test_pack_codes_matches_pallas_kernel():
    """pack_codes_plain against the TPU kernel K2 in interpret mode (B=128
    and K=8*2^k as the kernel requires), 48-bit codes and pads."""
    from airs_compression_tpu.ops import pallas_pack

    rng = np.random.default_rng(3)
    hi, lo, lens = _codes(rng, 128, 16, 48)
    j_words, j_bits = pallas_pack.pack_codes_tree_pallas(
        jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(lens), 48,
        interpret=True)
    payload, bits = t_pack.pack_codes_plain(
        torch.from_numpy(hi.astype(np.int64)),
        torch.from_numpy(lo.astype(np.int64)), torch.from_numpy(lens), 48)
    _same(bits, j_bits)
    _same(from_bits(payload), np.asarray(j_words).astype(np.int64))


def test_pack_codes_ignores_bits_past_length():
    """Bits above a code's length, and whole zero-length codes, add
    nothing; a missing ``hi`` is all zeros."""
    rng = np.random.default_rng(4)
    hi, lo, lens = _codes(rng, 3, 40, 30)
    clean = t_pack.pack_codes(None, torch.from_numpy(lo.astype(np.int64)),
                              torch.from_numpy(lens), 30)
    junk = t_pack.pack_codes(
        torch.from_numpy(rng.integers(0, 1 << 32, lo.shape)),
        torch.from_numpy(lo.astype(np.int64) | (0xFFFFFFFF << lens.astype(
            np.int64)) & 0xFFFFFFFF), torch.from_numpy(lens), 30)
    for a, b in zip(clean, junk):
        _same(a, b)


def test_pack_residuals_plain_is_pack_codes_plain():
    rng = np.random.default_rng(5)
    r = torch.from_numpy(_i16(rng, (4, 50), spread=60))
    hi, lo, ln = t_golomb.encode_codewords(r, 2, 3, 40)
    for a, b in zip(t_pack.pack_residuals_plain(r, 2, 3, 40),
                    t_pack.pack_codes_plain(hi, lo, ln, 48)):
        _same(a, b)


# -- stream assembly (kernel K5's plain version) ------------------------------

def _frame_rows(rng, sizes, w):
    """(B, W) BE word values holding random frames of the given sizes,
    zero past each frame, and the frames as bytes."""
    raw = rng.integers(0, 256, (len(sizes), 4 * w), dtype=np.uint8)
    for b, n in enumerate(sizes):
        raw[b, n:] = 0
    words = raw.reshape(len(sizes), w, 4).astype(np.int64)
    words = (words[..., 0] << 24) | (words[..., 1] << 16) \
        | (words[..., 2] << 8) | words[..., 3]
    return words, [raw[b, :n].tobytes() for b, n in enumerate(sizes)]


@pytest.mark.parametrize("sizes", [[0], [3], [5, 0, 1, 2, 3, 4, 7],
                                   [16, 9, 0, 12, 2], []])
def test_assemble_stream_is_join(sizes):
    """Frames of any size (0-3 bytes included), odd B and B=0."""
    rng = np.random.default_rng(len(sizes))
    words, frames = _frame_rows(rng, sizes, 4)
    w = torch.from_numpy(words).reshape(len(sizes), 4)
    sz = torch.tensor(sizes, dtype=torch.int32)
    out = t_asm.assemble_stream(w, sz)
    assert out.dtype == torch.uint8
    assert out.numpy().tobytes() == b"".join(frames)
    _same(t_asm.assemble_stream(to_bits(w), sz), out)


def test_assemble_stream_matches_pallas_kernel():
    """assemble_stream_plain against the TPU kernel K5 in interpret mode,
    frames of at least 4 bytes (its limit), B not a multiple of 8."""
    from airs_compression_tpu.ops import pallas_assemble

    rng = np.random.default_rng(9)
    sizes = rng.integers(4, 41, 11)
    words, frames = _frame_rows(rng, sizes, 10)
    total = int(sizes.sum())
    j_out = pallas_assemble.assemble_stream_pallas(
        jnp.asarray(words.astype(np.uint32)), jnp.asarray(sizes),
        pallas_assemble.stream_capacity_words(total, 10), interpret=True,
        swap=sys.byteorder == "little")
    j_bytes = np.asarray(j_out).view(np.uint8)[:total].tobytes()
    out = t_asm.assemble_stream_plain(torch.from_numpy(words),
                                      torch.from_numpy(sizes))
    assert out.numpy().tobytes() == j_bytes == b"".join(frames)


def test_assemble_stream_rejects_bad_sizes():
    w = torch.zeros((2, 3), dtype=torch.int64)
    with pytest.raises(ValueError):
        t_asm.assemble_stream(w, torch.tensor([4, 13]))
    with pytest.raises(ValueError):
        t_asm.assemble_stream(w, torch.tensor([4]))
