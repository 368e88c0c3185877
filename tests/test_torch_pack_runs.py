"""A CPU model of kernels K1 and K2's packing (``csrc/pack.cu``).

One CTA packs one block row.  It takes the row's codes a tile at a time
(``threads * per`` codes), each thread a run of ``per`` consecutive codes:
a CTA scan of the runs' bit counts, plus the carry of the tiles before,
gives each run its first bit.  A thread appends its codes to a 64-bit
register accumulator and stores each word whose first bit lies in its run
with a plain store into a ring of words in shared memory; the word its run
starts in, where an earlier run began it, gets one OR after the next
barrier.  Words the tiles before have finished are copied from the ring to
the row between the two barriers of each tile's scan, and the words past
the stream's end are zeroed.  K1 computes its codes from residuals, dividing by the Golomb
parameter with a multiply-high; K2 loads them.

A CUDA kernel cannot run here, so :func:`pack_row` repeats that algorithm
in plain Python, with the threads per CTA and the codes per thread as
parameters, and asserts its store discipline as it goes: every word stored
once, an OR only into a word its owner has stored, no ring slot reused
while its word is still to be copied, nothing stored past the row's C
words.  It is held against the port's plain packer (``pack_codes_plain``)
and the JAX packer (``bitpack.pack_codes_tree``).
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from airs_compression_tpu.ops import bitpack as j_bitpack
from airs_compression_tpu.ops import golomb as j_golomb

from airs_compression_tpu_torch.ops import golomb as t_golomb
from airs_compression_tpu_torch.ops import pack as t_pack
from airs_compression_tpu_torch.ops.u32 import from_bits
from airs_compression_tpu_torch.utils.bits import (
    derive_encoder_outlier,
    golomb_upper_bound,
)

M32 = (1 << 32) - 1
M64 = (1 << 64) - 1

# the kernel's geometry: 256 threads per CTA, 8 codes per thread per tile
# for K1, 4 for K2
K1_KERNEL = dict(threads=256, per=8)
K2_KERNEL = dict(threads=256, per=4)


# -- the model: K1's codes -------------------------------------------------------

def divider(g: int):
    """(magic, sh1, sh2) with x // g == (t + ((x - t) >> sh1)) >> sh2,
    t = (x * magic) >> 32, for every u32 x (Granlund and Montgomery, with
    the add-back step, as ``pack.cu`` computes it on the host)."""
    ell = (g - 1).bit_length()  # ceil(log2(g))
    magic = (((1 << 32) * ((1 << ell) - g)) // g + 1) & M32
    return magic, min(ell, 1), max(ell - 1, 0)


def divide(x: np.ndarray, g: int) -> np.ndarray:
    """The kernel's u32 x // g by multiply-high (x: uint64 array)."""
    magic, sh1, sh2 = divider(g)
    t = (x * np.uint64(magic)) >> np.uint64(32)
    return (t + ((x - t) >> np.uint64(sh1))) >> np.uint64(sh2)


def encode(residuals: np.ndarray, enc: int, g: int, outlier: int):
    """``pack.cu``'s ``encode`` for residuals (sign-extended i16): (hi, lo,
    len) as uint64 / int64 arrays."""
    r = residuals.astype(np.int64)
    if enc == 0:
        lo = (r & 0xFFFF).astype(np.uint64)
        return np.zeros_like(lo), lo, np.full(r.shape, 16, np.int64)
    m = (((r << 1) ^ (r >> 15)) & 0xFFFF).astype(np.uint64)
    glog2 = g.bit_length() - 1
    cutoff = np.uint64((2 << glog2) - g)
    len0 = glog2 + 1

    def codeword(v):
        vg = np.where(v < cutoff, np.uint64(0), v - cutoff)
        group = divide(vg, g)
        rem = vg - group * np.uint64(g)
        unary = np.where(group >= 32, np.uint64(M32),
                         (np.uint64(1) << np.minimum(group, 31)) - np.uint64(1))
        long_cw = ((unary << np.uint64(len0 + 1)) + (cutoff << np.uint64(1))
                   + rem) & np.uint64(M32)
        cw = np.where(v < cutoff, v, long_cw)
        ln = np.where(v < cutoff, len0, len0 + 1 + group.astype(np.int64))
        return cw, ln

    esc = m >= np.uint64(outlier)
    if enc == 1:
        cw, ln = codeword(np.where(esc, np.uint64(0), m + np.uint64(1)))
        return (np.zeros_like(cw), np.where(esc, m, cw),
                np.where(esc, glog2 + 17, ln))
    diff = np.where(esc, m - np.uint64(outlier), np.uint64(0))
    ilog2 = np.array([int(d).bit_length() - 1 for d in range(1 << 16)])
    level = np.where(diff < 4, 0, ilog2[diff] >> 1).astype(np.uint64)
    cw, ln = codeword(np.where(esc, np.uint64(outlier) + level, m))
    raw = (level + np.uint64(1)) * np.uint64(2)
    hi = np.where(esc, cw >> (np.uint64(32) - raw), np.uint64(0))
    lo = np.where(esc, ((cw << raw) & np.uint64(M32)) | diff, cw)
    return hi, lo, np.where(esc, ln + raw.astype(np.int64), ln)


# -- the model: the packing ------------------------------------------------------

def ring_words(threads: int, per: int) -> int:
    """Ring size: one tile of 64-bit codes and the carry word, with slack
    (the copy-out of the tiles before and this tile's stores are on either
    side of a barrier)."""
    return 2 * threads * per + 64


def emit_run(codes, pos: int, wide: bool = True):
    """One thread's run of (hi, lo, len) codes from bit ``pos``, as the
    kernel's 32-bit emitter: (plain stores [(word, value)], the OR deferred
    to the next barrier or None).  ``wide``: codes may pass 32 bits (else
    only a longer one is split into two pieces)."""
    pieces = []
    for hi, lo, ln in codes:
        if wide or ln > 32:
            hi_bits = max(ln - 32, 0)
            pieces += [(hi, hi_bits), (lo, ln - hi_bits)]
        else:
            pieces.append((lo, ln))
    fill0 = fill = pos & 31
    cur, words = 0, []
    for v, m in pieces:
        p = (v << (32 - m)) & M32  # left-justified; 0 for m = 0
        cur |= p >> fill
        end = fill + m
        if end >= 32:
            words.append(cur)
            cur = (p << (32 - fill)) & M32  # the bits that did not fit
        fill = end & 31
    if fill > (0 if words else fill0):
        words.append(cur)
    start = pos >> 5
    share = (start, words[0]) if words and fill0 else None
    return ([(start + i, v) for i, v in enumerate(words) if i or not fill0],
            share)


def pack_row(hi, lo, lens, c_words: int, threads: int, per: int,
             wide: bool = True):
    """The kernel's packing of one row: (C words, bits, stats)."""
    tile = threads * per
    n_ring = ring_words(threads, per)
    ring = [None] * n_ring  # (word, value)
    out = [None] * c_words
    stored = set()
    n = len(lens)
    stats = dict(tiles=0, ors=0, stores=0, empty_runs=0)
    carry = flushed = 0
    shares = []

    def copy_out(lo_w, hi_w):
        for w in range(lo_w, min(hi_w, c_words)):
            slot = ring[w % n_ring]
            assert slot is not None and slot[0] == w, f"word {w} lost"
            assert out[w] is None
            out[w] = slot[1]

    for start in range(0, n, tile):
        stats["tiles"] += 1
        # barrier: the ORs the previous tile deferred
        for w, v in shares:
            slot = ring[w % n_ring]
            assert slot is not None and slot[0] == w, "OR before its store"
            ring[w % n_ring] = (w, slot[1] | v)
            stats["ors"] += 1
        shares = []
        runs = []
        for th in range(threads):
            run = []
            for i in range(start + per * th, start + per * (th + 1)):
                if i < n:
                    ln = min(max(int(lens[i]), 0), 64)
                    run.append((int(hi[i]) if hi is not None else 0,
                                int(lo[i]), ln))
            runs.append(run)
        run_bits = [sum(c[2] for c in run) for run in runs]
        firsts = np.concatenate([[0], np.cumsum(run_bits)])[:-1]
        # between the scan's barriers: copy out what the tiles before
        # finished; after them this tile writes the ring
        copy_out(flushed, carry >> 5)
        flushed = carry >> 5
        for run, first, bits in zip(runs, firsts, run_bits):
            stores, share = emit_run(run, carry + int(first), wide)
            if not bits:
                assert not stores and share is None
                stats["empty_runs"] += 1
            for w, v in stores:
                slot = ring[w % n_ring]
                assert slot is None or slot[0] < flushed or slot[0] >= c_words, \
                    "ring slot reused before its word was copied out"
                assert w not in stored, f"word {w} stored twice"
                stored.add(w)
                ring[w % n_ring] = (w, v)
                stats["stores"] += 1
            if share is not None:
                shares.append(share)
        carry += sum(run_bits)
    for w, v in shares:
        slot = ring[w % n_ring]
        assert slot is not None and slot[0] == w
        ring[w % n_ring] = (w, slot[1] | v)
        stats["ors"] += 1
    used = -(-carry // 32)
    copy_out(flushed, used)
    for w in range(used, c_words):
        assert out[w] is None
        out[w] = 0
    assert None not in out
    return out, carry, stats


def model_pack(hi, lo, lens, max_bits: int, threads: int, per: int,
               wide: bool = True):
    """pack_codes' contract through :func:`pack_row`: (payload (B, C)
    uint32, bits (B,) int32, stats of the last row)."""
    b, k = lens.shape
    c_words = t_pack.code_words(max_bits, k)
    payload = np.zeros((b, c_words), np.uint32)
    bits = np.zeros(b, np.int32)
    stats = None
    for i in range(b):
        row, bits[i], stats = pack_row(None if hi is None else hi[i], lo[i],
                                       lens[i], c_words, threads, per, wide)
        payload[i] = row
    return payload, bits, stats


# -- corpora -------------------------------------------------------------------

def _clean(rng, lens):
    val = rng.integers(0, 1 << 64, lens.shape, dtype=np.uint64)
    keep = np.where(lens >= 64, np.uint64(M64),
                    (np.uint64(1) << np.minimum(lens, 63).astype(np.uint64))
                    - np.uint64(1))
    val &= keep
    return val >> np.uint64(32), val & np.uint64(M32)


def codes_case(name: str):
    """(hi uint64 or None, lo uint64, lens int32, max_bits) for a K2 case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name.startswith("len"):  # every code this long, with a few pads
        ln = int(name[3:])
        lens = np.full((3, 300), ln, np.int64)
        lens[:, 5::17] = 0
        max_bits = ln
    elif name == "mixed48":  # not a multiple of the tile, some pads
        lens = rng.integers(0, 49, (3, 2500))
        lens[rng.random(lens.shape) < 0.25] = 0
        max_bits = 48
    elif name == "mixed29":  # adaptive ZERO codes: no hi
        lens = rng.integers(1, 30, (2, 1500))
        max_bits = 29
    elif name == "pad_runs":  # whole runs and a whole tile of pads
        lens = rng.integers(1, 20, (2, 3000))
        lens[:, 3:11] = 0
        lens[:, 1024:2048] = 0
        lens[:, 2990:] = 0
        max_bits = 19
    elif name == "all_pads":
        lens = np.zeros((2, 300), np.int64)
        max_bits = 48
    elif name == "one_code":  # N = 1
        lens = np.array([[33], [1], [0]])
        max_bits = 48
    elif name == "few":  # N < threads
        lens = rng.integers(0, 49, (3, 7))
        max_bits = 48
    elif name == "oversize":  # lengths over max_bits: pieces past C dropped
        lens = rng.integers(8, 49, (2, 600))
        max_bits = 16
    elif name == "empty":  # B = 0
        lens = np.zeros((0, 40), np.int64)
        max_bits = 48
    else:
        raise KeyError(name)
    hi, lo = _clean(rng, lens)
    return (hi if max_bits > 32 or name == "oversize" else None, lo,
            lens.astype(np.int32), max_bits)


CODE_CASES = ["len1", "len32", "len33", "len48", "len64", "mixed48", "mixed29",
              "pad_runs", "all_pads", "one_code", "few", "oversize", "empty"]

GEOMETRIES = {
    "k2_kernel": K2_KERNEL,
    "k1_kernel_narrow": dict(K1_KERNEL, wide=False),
    "one_code_per_run": dict(threads=32, per=1),
    "many_tiles": dict(threads=4, per=2),
    "odd": dict(threads=3, per=5),
}


def _torch(a):
    return None if a is None else torch.from_numpy(a.astype(np.int64))


@functools.cache
def plain(name: str):
    hi, lo, lens, max_bits = codes_case(name)
    payload, bits = t_pack.pack_codes_plain(_torch(hi), _torch(lo),
                                            torch.from_numpy(lens), max_bits)
    return from_bits(payload).numpy().astype(np.uint32), bits.numpy()


def _jax_pack(hi, lo, lens, max_bits):
    """bitpack.pack_codes_tree, K padded to a power of two with pads."""
    b, k = lens.shape
    kp = 1 << max(k - 1, 0).bit_length()
    pad = ((0, 0), (0, kp - k))
    hi = np.zeros_like(lo) if hi is None else hi
    words, bits = j_bitpack.pack_codes_tree(
        jnp.pad(jnp.asarray(hi.astype(np.uint32)), pad),
        jnp.pad(jnp.asarray(lo.astype(np.uint32)), pad),
        jnp.pad(jnp.asarray(lens), pad), max_bits)
    return np.asarray(words), np.asarray(bits)


def _same_stream(payload, bits, j_words, j_bits):
    np.testing.assert_array_equal(bits, j_bits)
    used = -(-int(bits.max(initial=0)) // 32)
    np.testing.assert_array_equal(payload[:, :used], j_words[:, :used])
    assert not payload[:, used:].any()


# -- tests ---------------------------------------------------------------------

@pytest.mark.parametrize("g", [1, 2, 3, 4, 5, 7, 0x8000, 0x8001, 0xFFFF])
def test_divide_by_multiply_high(g):
    """The multiply-high divide equals ``//`` over every dividend below
    2**21 (all that a 16-bit zigzag value, or a MULTI escape symbol up to
    the largest outlier, can produce) and over random u32 dividends."""
    assert max(golomb_upper_bound(gg, True) for gg in (1, 0xFFFF)) + 16 \
        < 1 << 21
    x = np.arange(1 << 21, dtype=np.uint64)
    np.testing.assert_array_equal(divide(x, g), x // np.uint64(g))
    x = np.random.default_rng(g).integers(0, 1 << 32, 1 << 16,
                                          dtype=np.uint64)
    x[:2] = (M32, M32 - g)
    np.testing.assert_array_equal(divide(x, g), x // np.uint64(g))


K1_CONFIGS = [(0, 0)] + [(enc, g) for enc in (1, 2)
                         for g in (1, 2, 3, 4, 5, 0xFFFF)]


def _outlier(enc, g):
    return derive_encoder_outlier(enc, g, 40) if enc else 0


@pytest.mark.parametrize("enc,g", K1_CONFIGS)
def test_k1_codes_match(enc, g):
    """K1's codes (multiply-high divide, no ``//``) equal the port's and
    the JAX package's ``encode_codewords`` for every i16 residual."""
    r = np.arange(-0x8000, 0x8000, dtype=np.int32)[None]
    outlier = _outlier(enc, g)
    hi, lo, ln = encode(r, enc, g, outlier)
    t_hi, t_lo, t_ln = t_golomb.encode_codewords(torch.from_numpy(r), enc, g,
                                                 outlier)
    np.testing.assert_array_equal(hi, t_hi.numpy())
    np.testing.assert_array_equal(lo, t_lo.numpy())
    np.testing.assert_array_equal(ln, t_ln.numpy())
    j_hi, j_lo, j_ln = j_golomb.encode_codewords(jnp.asarray(r), enc, g,
                                                 outlier)
    np.testing.assert_array_equal(hi, np.asarray(j_hi))
    np.testing.assert_array_equal(lo, np.asarray(j_lo))
    np.testing.assert_array_equal(ln, np.asarray(j_ln))
    assert ln.max() <= t_pack.worst_bits(enc, g)


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("name", CODE_CASES)
def test_model_matches_plain(name, geometry):
    """Words and bits equal pack_codes_plain's (pieces past C dropped,
    bits the full sum); a run of pads stores nothing."""
    hi, lo, lens, max_bits = codes_case(name)
    payload, bits, stats = model_pack(hi, lo, lens, max_bits,
                                      **GEOMETRIES[geometry])
    want, want_bits = plain(name)
    np.testing.assert_array_equal(bits, want_bits)
    np.testing.assert_array_equal(payload, want)
    if stats is not None:
        assert stats["ors"] <= stats["tiles"] * GEOMETRIES[geometry]["threads"]
    if name == "oversize":
        assert int(bits.max()) > 32 * payload.shape[1]


@pytest.mark.parametrize("name", ["len1", "len32", "len33", "len48",
                                  "all_pads", "one_code", "few"])
def test_model_matches_jax(name):
    """The same words and bits as the JAX packer (K up to 512, where it
    compiles in seconds).  Not held here: codes of 64 bits, which
    ``pack_codes_tree`` packs as (hi << 1) | (lo >> 31), and lengths over
    the maximum, where its capacity differs."""
    hi, lo, lens, max_bits = codes_case(name)
    if not lens.shape[0]:
        return
    payload, bits, _ = model_pack(hi, lo, lens, max_bits, **K2_KERNEL)
    _same_stream(payload, bits, *_jax_pack(hi, lo, lens, max_bits))


def test_plain_packs_64_bit_codes():
    """A 64-bit code is its hi word then its lo word."""
    hi = torch.tensor([[0x80000000, 0x12345678]])
    lo = torch.tensor([[0xC0000003, 0x9ABCDEF0]])
    payload, bits = t_pack.pack_codes_plain(hi, lo, torch.tensor([[64, 64]]),
                                            64)
    assert from_bits(payload).tolist() == [[0x80000000, 0xC0000003,
                                            0x12345678, 0x9ABCDEF0]]
    assert bits.tolist() == [128]


def _residuals(rng, b, n):
    """Small residuals with a full-range one every fifth sample."""
    r = rng.integers(-40, 41, (b, n))
    r[:, ::5] = rng.integers(-0x8000, 0x8000, (b, (n + 4) // 5))
    return r.astype(np.int32)


@pytest.mark.parametrize("n", [1, 7, 1100])
@pytest.mark.parametrize("enc,g", K1_CONFIGS)
def test_k1_model_matches(enc, g, n):
    """K1 end to end in the model (codes from residuals, then the packing)
    equals pack_residuals_plain, and at small N the JAX encoder + packer."""
    rng = np.random.default_rng(n + g + 7 * enc)
    r = _residuals(rng, 2, n)
    outlier = _outlier(enc, g)
    hi, lo, lens = encode(r, enc, g, outlier)
    max_bits = t_pack.worst_bits(enc, g)
    payload, bits, _ = model_pack(hi, lo, lens, max_bits, **K1_KERNEL,
                                  wide=enc == 2)
    want, want_bits = t_pack.pack_residuals_plain(torch.from_numpy(r), enc,
                                                  g, outlier)
    assert payload.shape == tuple(want.shape)
    np.testing.assert_array_equal(bits, want_bits.numpy())
    np.testing.assert_array_equal(payload,
                                  from_bits(want).numpy().astype(np.uint32))
    if n > 64:
        return
    j_hi, j_lo, j_ln = j_golomb.encode_codewords(jnp.asarray(r), enc, g,
                                                 outlier)
    _same_stream(payload, bits, *_jax_pack(np.asarray(j_hi), np.asarray(j_lo),
                                           np.asarray(j_ln), max_bits))


def test_b_zero():
    """B = 0: both packers return (0, C) payloads and (0,) bits."""
    for payload, bits in (
            t_pack.pack_codes(None, torch.zeros((0, 9), dtype=torch.int64),
                              torch.zeros((0, 9), dtype=torch.int32), 29),
            t_pack.pack_residuals(torch.zeros((0, 9), dtype=torch.int32), 1,
                                  4, _outlier(1, 4))):
        assert payload.shape[0] == 0 and bits.shape == (0,)
        assert payload.shape[1] >= 1
