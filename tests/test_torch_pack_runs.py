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

Long-row mode (``pack_residuals_at``/``pack_codes_at``): one long row cut
into rows of ``row_len`` codes, each packed at its absolute start bit into
ONE stream that holds zeros (and header bits before the first row), each
row by a cluster of CTAs that take its tiles in rounds, one a CTA.
:func:`model_row` runs a row's CTAs as generators in a random interleaving
(:func:`run_cluster`): each sends its tile's bit count into every CTA's
count array of the round's parity, counted there by an mbarrier of that
parity, and a CTA places its tile once its phase completes; it asserts
that no count reaches a CTA that does not run and that a completed phase
holds the round's counts and no other.  :func:`pack_tile` packs one tile
into its own zeroed words (plain stores, ORs of the words runs share) and
copies them out.  :func:`model_pack_long` applies the tiles' stores and
ORs to the stream in an arbitrary order and asserts that each stream word
is either stored by one tile and touched by nothing else, or ORed only by
the tiles whose bits it holds (never a header word stored over); the
stream equals the whole row packed by ``pack_codes_plain`` (and by the
JAX packer) and spliced in at the first row's start, and
``pack_codes_at_plain``.
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
    carry = 0
    flushed = 0
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


def pack_tile(hi, lo, lens, s0: int, threads: int, per: int,
              wide: bool = True):
    """One CTA's tile in long-row mode, from bit ``s0`` < 32 of its first
    word: the CTA scan of its runs, the tile's words zeroed, each run
    emitted into them (a plain store of every word that holds its bits
    only; the word it starts in, where an earlier run began it, and the
    word it ends in, where a later run goes on in it, ORed at once), then
    the copy-out.  Returns (actions [(kind, word, value)], bits): word 0
    is ORed where s0 > 0, the last word where the tile's end is not
    word-aligned, every other word stored."""
    runs = []
    for th in range(threads):
        runs.append([(int(hi[i]) if hi is not None else 0, int(lo[i]),
                      min(max(int(lens[i]), 0), 64))
                     for i in range(per * th, min(per * (th + 1),
                                                  len(lens)))])
    bits = sum(c[2] for run in runs for c in run)
    if not bits:  # the CTA stores nothing
        return [], 0
    words = {}  # the zeroed words: only those written are kept
    stored, ored = set(), set()
    pos = s0  # each run's first bit: the scan's exclusive sums
    for run in runs:
        rb = sum(c[2] for c in run)
        stores, share = emit_run(run, pos, wide)
        if not rb:
            assert not stores and share is None
        for w, v in stores + ([share] if share else []):
            if 32 * w < pos or 32 * w + 32 > pos + rb:  # shared: an OR
                assert w not in stored, f"tile word {w} ORed over a store"
                ored.add(w)
                words[w] = words.get(w, 0) | v
            else:
                assert w not in stored and w not in ored, \
                    f"tile word {w} stored over another run's bits"
                stored.add(w)
                words[w] = v
        pos += rb
    end = s0 + bits
    used = -(-end // 32)
    assert sorted(words) == list(range(used)), "a tile word left unwritten"
    return [("or" if (w == 0 and s0) or (w == used - 1 and end % 32)
             else "store", w, words[w]) for w in range(used)], bits


def run_cluster(ctas, rng) -> None:
    """Run the generators ``ctas`` (a cluster's CTAs) to their ends in a
    random interleaving.  A CTA yields "arrive" or "wait" (the cluster
    barrier: a wait ends once every CTA has arrived as often as the
    waiting one), "step" (a point where another CTA may run) or a function
    (an mbarrier wait: the CTA runs on once it returns True)."""
    arrived = [0] * len(ctas)
    blocked = [None] * len(ctas)  # what each CTA waits on
    live = list(range(len(ctas)))
    while live:
        ready = [i for i in live if blocked[i] is None
                 or (blocked[i] == "wait" and min(arrived) >= arrived[i])
                 or (callable(blocked[i]) and blocked[i]())]
        assert ready, "the cluster never completes"
        i = ready[int(rng.integers(len(ready)))]
        blocked[i] = None
        step = next(ctas[i], None)
        if step is None:
            live.remove(i)
            continue
        arrived[i] += step == "arrive"
        if step == "wait" or callable(step):
            blocked[i] = step


def model_row(hi, lo, lens, start: int, ctas: int, tile: int,
              threads: int, per: int, wide: bool, rng):
    """The cluster of ``ctas`` CTAs that packs one row from bit ``start``.
    CTA j takes the row's tiles j, j + ctas, ..., one a round.  Each CTA
    sends its tile's bits into slot j of the round's count array (two, by
    round parity) of every CTA, each store counted by that CTA's mbarrier
    of the same parity; a CTA waits for its mbarrier's phase of the round
    (all the round's counts in), then sums the slots before its own; a
    cluster of one CTA exchanges nothing.  The first store waits on the
    cluster barrier that every CTA arrives at when it starts.  Asserts
    that a count goes only into a CTA that runs, and that a completed
    phase holds the round's counts and no other.  Returns ([(tile start
    bit, bits, actions)], the row's bits)."""
    n_tiles = -(-len(lens) // tile)
    rounds = -(-n_tiles // ctas)
    counts = [[[None] * ctas for _ in range(2)] for _ in range(ctas)]
    got = [[0, 0] for _ in range(ctas)]  # [CTA][parity]: counts stored
    running = [False] * ctas
    tiles, row_bits = [], []

    def cta(j):
        running[j] = True
        yield "arrive"  # the cluster barrier, after the set-up
        carry = start
        for r in range(rounds):
            t = r * ctas + j
            sl = slice(t * tile, (t + 1) * tile)
            sub = (None if hi is None else hi[sl], lo[sl], lens[sl])
            bits = sum(min(max(int(v), 0), 64) for v in sub[2])  # CTA scan
            if r == 0:
                yield "wait"
            if ctas == 1:  # a cluster of one: no counts to exchange
                pos = carry
                carry += bits
                if bits:
                    actions, b = pack_tile(*sub, pos & 31, threads, per,
                                           wide)
                    tiles.append((pos, bits, actions))
                continue
            for k in range(ctas):  # into slot j of every CTA's array
                assert running[k], "a count sent to a CTA not running"
                counts[k][r % 2][j] = (r, bits)
                got[k][r % 2] += 1
                yield "step"
            phase = r // 2 + 1  # the phases of parity r % 2 up to round r
            yield lambda: got[j][r % 2] >= ctas * phase
            assert got[j][r % 2] == ctas * phase, "a later round's count"
            pos = carry
            for i in range(ctas):
                v = counts[j][r % 2][i]
                assert v == (r, v[1]), f"CTA {j} read {v} in round {r}"
                pos += v[1] if i < j else 0
                carry += v[1]
            if bits:
                actions, b = pack_tile(*sub, pos & 31, threads, per, wide)
                assert b == bits
                tiles.append((pos, bits, actions))
            yield "step"
        if not rounds:
            yield "wait"
        if j == 0:
            row_bits.append(carry - start)
        running[j] = False

    run_cluster([cta(j) for j in range(ctas)], rng)
    return tiles, row_bits[0]


def model_pack_long(hi, lo, lens, max_bits: int, row_len: int, first: int,
                    threads: int, per: int, wide: bool = True,
                    header=None, order_seed: int = 0, ctas: int = 8):
    """Long-row mode through :func:`model_row`: (stream words uint32, rows'
    bits).  A row is packed by min(``ctas``, its launch's tiles a row)
    CTAs of ``threads * per`` codes a tile; the rows' clusters and the
    tiles' stores and ORs run in a random order.  ``header``: stream words
    holding bits only before ``first``.  Each word's discipline is
    asserted (see the module docstring)."""
    k = len(lens)
    tile = threads * per
    rows = max(1, -(-k // row_len))
    cluster = max(1, min(ctas, -(-row_len // tile)))
    sums = [int(np.sum(np.clip(lens[i * row_len:(i + 1) * row_len], 0,
                               64))) for i in range(rows)]
    starts = first + np.concatenate([[0], np.cumsum(sums)])[:-1]
    width = (first + sum(sums) + 31) // 32 + 2
    stream = [0] * width if header is None else [int(v) for v in header]
    assert len(stream) == width
    head_words = set(w for w, v in enumerate(stream) if v)
    rng = np.random.default_rng(order_seed)
    tiles, bits = [], []
    for i in range(rows):
        sl = slice(i * row_len, (i + 1) * row_len)
        row_tiles, b = model_row(None if hi is None else hi[sl], lo[sl],
                                 lens[sl], int(starts[i]), cluster, tile,
                                 threads, per, wide, rng)
        tiles += row_tiles
        bits.append(b)
    stored_by, ored_by = {}, {}
    for t in rng.permutation(len(tiles)):
        pos, b, actions = tiles[t]
        base = pos >> 5
        for kind, w, v in actions:
            w += base
            if kind == "store":
                assert w not in stored_by and w not in ored_by, \
                    f"word {w} stored over another tile's bits"
                assert w not in head_words, f"header word {w} stored over"
                # a stored word holds this tile's bits only
                assert pos <= 32 * w and 32 * w + 32 <= pos + b
                stored_by[w] = t
                stream[w] = v
            else:
                assert w not in stored_by, f"word {w} ORed after a store"
                assert pos < 32 * w + 32 and 32 * w < pos + b, \
                    f"tile {t} ORs word {w} outside its bits"
                ored_by.setdefault(w, set()).add(t)
                stream[w] |= v
    assert sum(bits) == sum(sums)
    return np.array(stream, np.uint32), np.array(bits, np.int32)


def _spliced(payload_bits: np.ndarray, first: int, header: np.ndarray):
    """The stream of ``header`` with the bit string ``payload_bits`` (a
    uint8 0/1 array) written from bit ``first`` on."""
    bitarr = np.unpackbits(header.astype(">u4").view(np.uint8))
    bitarr[first: first + payload_bits.size] |= payload_bits
    return np.packbits(bitarr).view(">u4").astype(np.uint32)


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


# -- long-row mode ---------------------------------------------------------------

LONG_CASES = ["mixed48", "mixed29", "pad_runs", "all_pads", "len1", "len33",
              "few", "one_code"]
LONG_LAYOUTS = {"rows_of_tiles": (2 * 4 * 3, dict(threads=4, per=4)),
                "rows_of_one_run": (4, dict(threads=4, per=4)),
                "odd_rows": (37, dict(threads=3, per=4)),
                "k1_narrow": (50, dict(threads=4, per=8, wide=False)),
                "wide_rows": (100, dict(threads=2, per=4))}
# CTAs a row at most (the kernel's cluster: 8); 1 and 3 make rows of more
# tiles than CTAs, packed in rounds
LONG_CTAS = [1, 3, 8]


def _header(rng, first: int, width: int) -> np.ndarray:
    """Random header bits before bit ``first`` of a width-word stream."""
    w = rng.integers(0, 1 << 32, width, dtype=np.uint64).astype(np.uint32)
    w[(first + 31) // 32:] = 0
    if first % 32:
        w[first // 32] &= np.uint32((M32 << (32 - first % 32)) & M32)
    return w


@functools.cache
def _jax_first_row(name: str, zero_codes: int):
    """The JAX packer's words and bits for the first row of K2 case
    ``name``, its first ``zero_codes`` codes set to length 0."""
    hi, lo, lens, max_bits = codes_case(name)
    lens = lens[:1].copy()
    lens[0, :zero_codes] = 0
    return _jax_pack(None if hi is None else hi[:1], lo[:1], lens, max_bits)


@pytest.mark.parametrize("ctas", LONG_CTAS)
@pytest.mark.parametrize("first", [0, 1, 31, 32, 176])
@pytest.mark.parametrize("layout", list(LONG_LAYOUTS))
@pytest.mark.parametrize("name", LONG_CASES)
def test_long_row_model_matches_plain(name, layout, first, ctas):
    """Every stream word stored by one tile or ORed by the tiles whose bits
    it holds, header bits kept, each count of the cluster's scan read in
    its round; the stream equals the whole row packed by pack_codes_plain
    (and by the JAX packer) spliced in at ``first``, and
    pack_codes_at_plain."""
    hi, lo, lens, max_bits = codes_case(name)
    if not lens.shape[0]:
        return
    hi0 = None if hi is None else hi[0]
    lens0 = lens[0]
    row_len, geometry = LONG_LAYOUTS[layout]
    zero_codes = 3 * row_len if name == "pad_runs" else 0
    if zero_codes:  # rows whose codes all have length 0
        lens0 = lens0.copy()
        lens0[:zero_codes] = 0
    rng = np.random.default_rng(first + len(layout))
    total = int(np.clip(lens0, 0, 64).sum())
    header = _header(rng, first, (first + total + 31) // 32 + 2)
    stream, bits = model_pack_long(hi0, lo[0], lens0, max_bits, row_len,
                                   first, header=header, ctas=ctas,
                                   order_seed=first + ctas, **geometry)
    whole, whole_bits = t_pack.pack_codes_plain(
        None if hi0 is None else _torch(hi0)[None], _torch(lo[0])[None],
        torch.from_numpy(lens0)[None], max_bits)
    payload = from_bits(whole).numpy()[0].astype(np.uint32)
    _same_stream(payload[None], whole_bits.numpy(),
                 *_jax_first_row(name, zero_codes))
    want = _spliced(np.unpackbits(payload.astype(">u4").view(np.uint8))
                    [: int(whole_bits[0])], first, header)
    np.testing.assert_array_equal(stream, want)
    starts, row_bits = t_pack.row_starts(torch.from_numpy(lens0), row_len,
                                         first)
    plain = torch.from_numpy(header.view(np.int32).copy())
    got_bits = t_pack.pack_codes_at_plain(
        plain, None if hi0 is None else _torch(hi0), _torch(lo[0]),
        torch.from_numpy(lens0), row_len, starts, max_bits)
    np.testing.assert_array_equal(plain.numpy().view(np.uint32), stream)
    np.testing.assert_array_equal(got_bits.numpy(), bits)
    assert int(row_bits) == int(whole_bits[0])


@pytest.mark.parametrize("ctas", LONG_CTAS)
@pytest.mark.parametrize("first", [0, 5, 176])
@pytest.mark.parametrize("enc,g", [(0, 0), (1, 4), (2, 3)])
def test_long_row_residuals_match(enc, g, first, ctas):
    """K1 in long-row mode (the model on its codes) equals
    pack_residuals_at_plain, rows of 50 residuals."""
    rng = np.random.default_rng(enc + g + first)
    r = _residuals(rng, 1, 333)[0]
    outlier = _outlier(enc, g)
    hi, lo, lens = encode(r, enc, g, outlier)
    stream, bits = model_pack_long(hi, lo, lens, t_pack.worst_bits(enc, g),
                                   50, first, threads=4, per=8,
                                   wide=enc == 2, order_seed=first,
                                   ctas=ctas)
    rt = torch.from_numpy(r)
    starts, _ = t_pack.row_starts(
        t_golomb.encode_codewords(rt, enc, g, outlier)[2], 50, first)
    plain = torch.zeros(stream.size, dtype=torch.int32)
    got_bits = t_pack.pack_residuals_at(plain, rt, 50, starts, enc, g,
                                        outlier)
    np.testing.assert_array_equal(plain.numpy().view(np.uint32), stream)
    np.testing.assert_array_equal(got_bits.numpy(), bits)


def test_long_row_no_codes():
    """No codes at all: one row, nothing written, the header kept."""
    header = _header(np.random.default_rng(0), 40, 4)
    stream, bits = model_pack_long(None, np.zeros(0, np.uint64),
                                   np.zeros(0, np.int32), 48, 8, 40,
                                   header=header, threads=4, per=4)
    np.testing.assert_array_equal(stream, header)
    assert bits.tolist() == [0]
