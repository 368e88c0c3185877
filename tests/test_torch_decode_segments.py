"""A CPU model of kernel K3's segment-parallel Golomb decode.

``csrc/decode.cu`` decodes each block row with one CTA: it cuts the row's
bits into segments, decodes every segment speculatively from its first
bit, resynchronises the segments round by round until no entry changes,
scans the per-segment code counts and decodes each segment once more to
write its codes; codes past the row's last nonzero word come out in closed
form; a synchronise walk stops where it joins its segment's speculative
walk.  A CUDA kernel cannot run here, so :func:`segment_decode` repeats
that algorithm in plain Python, with the number of segments, the segment
length and the round count as parameters, and is held against the port's
plain decoder (``decode_codes_plain``, the step loop) and the JAX scan
decoder (``decode_blocks_device`` on the CPU): valid ZERO, MULTI (codes
over 40 bits) and UNCOMPRESSED frames, junk, all-ones and all-zero rows,
rows cut short so the chain runs past their end, and per-block Golomb
parameters from 1 to 0xFFFF.  Every row ends in a zero word, where the
JAX decoder (which repeats a row's last word past its end) and the port
(zeros past the end) agree.

Window mode (``decode_windows``, the long-stream tier's sidecar decode):
each row is the window of ONE word stream at a start bit instead of a
stored row.  :func:`stage_window` builds a window word by word in plain
Python (stream words ``start // 32 + i`` and ``+ i + 1`` funnel-shifted by
``start % 32``, the last word's next word and everything past the stream
read as zero, nothing at all for a start below 0); it is held against the
JAX tier's window build (``parallel/sp.py`` ``_sidecar_decode_device``,
read back through an UNCOMPRESSED decode of each window) for start bits
0-63 and near the stream's end, and against the port's ``stream_windows``,
the windows that the window kernel's plain version decodes.

The window kernel (``decode_windows_kernel``): one warp a window, several
windows a CTA, the CTA's span of the stream staged once when it fits, and
each lane's speculative codes kept (value and length) so that a code is
decoded once.  :func:`window_kernel` repeats it with the lanes a window,
the windows a CTA, the span room, the kept-code room and the row staging
as parameters, asserting that every read stays inside the staged span or
the stream and inside the window's limit and that every output value is
stored once; it is held against ``decode_windows_plain`` (the step loop
over ``stream_windows``) and, where every start lies in the stream, the
JAX tier's window build and scan decoder (``_sidecar_decode_device``):
real sidecar windows of ZERO and MULTI frames (48-bit escapes), starts
shuffled, duplicated, below 0 and past the end, spans and segments that
overflow their rooms, junk, all-ones and all-zero streams, B = 1 and B
not a multiple of the windows a CTA takes.
"""

import collections
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from airs_compression_tpu.ops import decode as j_decode
from airs_compression_tpu.ops import golomb as j_golomb
from airs_compression_tpu.ops import preprocess as j_pre
from airs_compression_tpu.ops.encode import PassConfig as JPassConfig
from airs_compression_tpu.parallel import sp as j_sp

from airs_compression_tpu_torch.ops import encode as t_encode
from airs_compression_tpu_torch.ops import golomb as t_golomb
from airs_compression_tpu_torch.ops import preprocess as t_pre
from airs_compression_tpu_torch.ops.decode import BAD_CODE_POISON_BITS
from airs_compression_tpu_torch.ops.decode_kernel import (
    decode_codes_plain,
    decode_windows,
    decode_windows_plain,
    stream_windows,
)
from airs_compression_tpu_torch.utils.bits import derive_encoder_outlier

M32 = (1 << 32) - 1
M64 = (1 << 64) - 1

# the kernel's geometry: 256 segments of at least 64 bits, whole words
KERNEL = dict(segments=256, min_seg_bits=64, align_bits=32)


# -- the model -----------------------------------------------------------------

def _take(win: int, start: int, count: int) -> int:
    return ((win << start) & M64) >> (64 - count) if count else 0


def _step(words, pos: int, enc: int, g: int, outlier: int):
    """One code at bit ``pos`` -> (mapped, consumed, bad), as
    ops/decode.py::_decode_one; words past the list read as zeros."""
    wi, r = pos >> 5, pos & 31
    w = [words[i] if i < len(words) else 0 for i in (wi, wi + 1, wi + 2)]
    win = (((w[0] << 64) | (w[1] << 32) | w[2]) >> (32 - r)) & M64
    if enc == 0:
        return win >> 48, 16, False
    glog2 = g.bit_length() - 1 if g else 0
    cutoff = (2 << glog2) - g
    q = 32 - (~(win >> 32) & M32).bit_length()  # leading ones
    r0 = _take(win, q + 1, glog2)
    long_form = int(r0 >= cutoff)
    extra = _take(win, q + 1 + glog2, long_form)
    rem = (((r0 << 1) | extra) - cutoff) & M32 if long_form else r0
    v = (q * g + rem) & M32
    consumed = q + 1 + glog2 + long_form
    bad = consumed > 32
    if enc == 1:
        if v == 0:
            mapped, consumed = _take(win, consumed, 16), consumed + 16
        else:
            mapped = v - 1
    else:
        mapped = v
        if v >= outlier:
            nbits = ((v - outlier + 1) * 2) & M32
            bad |= nbits > 32
            nbits = min(nbits, 32)
            mapped = (outlier + _take(win, consumed, nbits)) & M32
            consumed += nbits
    return mapped, consumed, bad or mapped > 0xFFFF


def segment_decode(row: np.ndarray, hdr_bits: int, n: int, enc: int, g: int,
                   outlier: int, segments: int, min_seg_bits: int,
                   align_bits: int, max_rounds: "int | None" = None):
    """K3's algorithm on one row of u32 words.

    Returns (mapped values, end bit position with the poison, synchronise
    rounds, segment count).  ``max_rounds`` stops the synchronisation
    early (the result is then exact only if it had converged).
    """
    nz = np.flatnonzero(row)
    words = [int(v) for v in row[: nz[-1] + 1]] if nz.size else []
    step = functools.cache(lambda pos: _step(words, pos, enc, g, outlier))
    end_bits = max(hdr_bits, 32 * len(words))
    bits = end_bits - hdr_bits
    seg = max(min_seg_bits, -(-bits // segments))
    seg = -(-seg // align_bits) * align_bits
    n_seg = -(-bits // seg)
    assert n_seg <= segments
    ends = [min(hdr_bits + (t + 1) * seg, end_bits) for t in range(n_seg)]

    def speculate(t):
        """(exit, count, code starts in the segment's first 64 bits)."""
        pos, count, starts = hdr_bits + t * seg, 0, []
        while pos < ends[t]:
            if pos - (hdr_bits + t * seg) < 64:
                starts.append(pos)
            pos += step(pos)[1]
            count += 1
        return pos, count, starts

    def walk(t, pos):
        """(exit, count) from entry ``pos``; a chain that reaches a code
        start of the speculative walk follows it from there."""
        spec_exit, spec_count, starts = spec[t]
        count = 0
        while pos < ends[t]:
            if pos in starts:
                return spec_exit, count + spec_count - starts.index(pos)
            pos += step(pos)[1]
            count += 1
        return pos, count

    # speculate: every segment decodes from its own first bit
    spec = [speculate(t) for t in range(n_seg)]
    entry = [hdr_bits + t * seg for t in range(n_seg)]
    exits = [s[0] for s in spec]
    counts = [s[1] for s in spec]
    # synchronise: all segments at once, from the previous round's exits
    rounds = 0
    while max_rounds is None or rounds < max_rounds:
        new = [hdr_bits] + exits[:-1]
        redo = [t for t in range(n_seg) if new[t] != entry[t]]
        if not redo:
            break
        for t in redo:
            entry[t] = new[t]
            exits[t], counts[t] = walk(t, entry[t])
        rounds += 1
    # place and write the codes below n
    firsts = np.concatenate([[0], np.cumsum(counts, dtype=np.int64)])
    total = int(firsts[-1])
    vals = [0] * n
    bad = False
    end = hdr_bits if n == 0 else None
    for t in range(n_seg):
        first = int(firsts[t])
        if first >= n:
            continue
        pos = entry[t]
        stop = min(counts[t], n - first)
        for j in range(stop):
            m, c, b = step(pos)
            vals[first + j] = m
            bad |= b
            pos += c
        if first + stop == n:
            end = pos
    if total < n:  # past the last nonzero word every window is zero
        tail_from = exits[-1] if n_seg else hdr_bits
        m, c, b = step(tail_from)
        vals[total:] = [m] * (n - total)
        bad |= b
        end = tail_from + (n - total) * c
    return vals, end + (BAD_CODE_POISON_BITS if bad else 0), rounds, n_seg


# -- corpora -------------------------------------------------------------------

B, N = 3, 48


def _detector(rng, b, n, spikes):
    x = (1100 + rng.normal(0, 4, (b, n))).astype(np.int64)
    hits = rng.random((b, n)) < spikes
    x[hits] = rng.integers(0, 1 << 16, int(hits.sum()))
    return ((x & 0xFFFF) ^ 0x8000) - 0x8000  # as sign-extended i16


def _encode(prep, enc, gs, x):
    """Valid frames, one per row of ``x``, each under its own parameter
    ``gs[i]``: (B, W) u32 words padded with zero words, outliers (B,)."""
    rows, outs = [], []
    for g, xi in zip(gs, x):
        o = derive_encoder_outlier(enc, g, 40)
        cfg = t_encode.PassConfig(prep, enc, g, o, False, 8)
        xt = torch.from_numpy(xi[None].astype(np.int32))
        w, _, _ = t_encode.encode_blocks_device(
            cfg, None, xt, torch.zeros_like(xt), torch.ones(1, dtype=torch.int32),
            torch.zeros(1, dtype=torch.int64), torch.zeros(1, dtype=torch.int64),
            torch.zeros(1, dtype=torch.int64), t_encode.worst_case_words(cfg, N))
        rows.append(w.numpy()[0].astype(np.uint32))
        outs.append(o)
    width = max(len(r) for r in rows) + 2
    words = np.zeros((len(rows), width), np.uint32)
    for i, r in enumerate(rows):
        words[i, : len(r)] = r
    return words, np.array(outs, np.int64)


def _longest_code(enc, gs, outs, x) -> int:
    r = t_pre.diff_forward(torch.from_numpy(x.astype(np.int32)))
    return max(int(t_golomb.encode_codewords(r[i:i + 1], enc, g, o)[2].max())
               for i, (g, o) in enumerate(zip(gs, outs)))


def _raw_rows(kind, rng, width=24):
    if kind == "junk":
        w = rng.integers(0, 1 << 32, (B, width), dtype=np.uint64)
    elif kind == "ones":
        w = np.full((B, width), M32, np.uint64)
    else:
        w = np.zeros((B, width), np.uint64)
    w = w.astype(np.uint32)
    w[:, -1] = 0
    return w


CORPORA = (["zero", "multi", "uncompressed", "mixed_g_zero", "mixed_g_multi",
            "truncated_zero", "truncated_multi"]
           + [f"{kind}_{enc}" for kind in ("junk", "ones", "zeros")
              for enc in (0, 1, 2)])


@functools.cache
def corpus(name: str):
    """(words (B, W) u32, prep, enc, g (B,), outlier (B,), samples or
    None); every row's last word is zero."""
    rng = np.random.default_rng(CORPORA.index(name))
    if name in ("zero", "multi", "uncompressed", "mixed_g_zero",
                "mixed_g_multi", "truncated_zero", "truncated_multi"):
        enc = {"zero": 1, "uncompressed": 0}.get(name.split("_")[-1], 2)
        gs = {"zero": [4, 4, 4], "multi": [1, 2, 3], "uncompressed": [0] * 3,
              "mixed_g_zero": [1, 3, 0xFFFF], "mixed_g_multi": [1, 7, 0xFFFF],
              }.get(name, [1, 4, 2])
        x = _detector(rng, B, N, 0.1 if enc == 2 else 0.05)
        words, outs = _encode(1, enc, gs, x)
        if name == "multi":
            assert _longest_code(enc, gs, outs, x) > 40
        if name.startswith("truncated"):  # each row cut to half its words
            cut = [(np.flatnonzero(r)[-1] + 1) // 2 for r in words]
            for i, c in enumerate(cut):
                words[i, c:] = 0
            words = words[:, : max(cut) + 1].copy()
            x = None
        return words, 1, enc, np.array(gs, np.int64), outs, x
    kind, enc = name.rsplit("_", 1)
    enc = int(enc)
    gs = [0, 0, 0] if enc == 0 else [1, 4, 0xFFFF]
    outs = [derive_encoder_outlier(enc, g, 40) if enc else 0 for g in gs]
    return (_raw_rows(kind, rng), 1, enc, np.array(gs, np.int64),
            np.array(outs, np.int64), None)


def _hdr_bits(prep, enc):
    return t_encode.PassConfig(prep, enc, 1, 1, False, 8).hdr_bits


@functools.cache
def plain(name: str):
    words, prep, enc, gs, outs, _ = corpus(name)
    vals, end = decode_codes_plain(
        torch.from_numpy(words.view(np.int32)), _hdr_bits(prep, enc), N, enc,
        torch.from_numpy(gs), torch.from_numpy(outs))
    return vals.numpy().view(np.uint32), end.numpy()


def model(name: str, **geometry):
    words, prep, enc, gs, outs, _ = corpus(name)
    rows = [segment_decode(words[i], _hdr_bits(prep, enc), N, enc,
                           int(gs[i]), int(outs[i]), **geometry)
            for i in range(words.shape[0])]
    vals = np.array([r[0] for r in rows], np.uint32)
    ends = np.array([r[1] for r in rows], np.int32)
    return vals, ends, [r[2] for r in rows], [r[3] for r in rows]


# -- tests ---------------------------------------------------------------------

GEOMETRIES = {
    "kernel": KERNEL,
    "S1": dict(segments=1, min_seg_bits=64, align_bits=32),
    "S7": dict(segments=7, min_seg_bits=64, align_bits=32),
    # segments of a few bits: shorter than a long code, most of them empty
    "S7_short": dict(segments=7, min_seg_bits=1, align_bits=1),
    "S256_short": dict(segments=256, min_seg_bits=1, align_bits=1),
}


@pytest.mark.parametrize("geometry", list(GEOMETRIES))
@pytest.mark.parametrize("name", CORPORA)
def test_model_matches_plain(name, geometry):
    """Values and poisoned end positions equal the step loop's, and the
    rounds stay below the segment count (after round k, segments 0..k
    are exact)."""
    want_vals, want_end = plain(name)
    vals, ends, rounds, n_segs = model(name, **GEOMETRIES[geometry])
    np.testing.assert_array_equal(vals, want_vals)
    np.testing.assert_array_equal(ends, want_end)
    for r, s in zip(rounds, n_segs):
        assert r <= max(s - 1, 0) <= GEOMETRIES[geometry]["segments"]


@pytest.mark.parametrize("name", CORPORA)
def test_model_matches_jax(name):
    """The model's values, through the JAX decoder's own unzigzag and
    inverse preprocessing, and its end positions equal the JAX scan
    decoder's; valid frames decode to their samples."""
    words, prep, enc, gs, outs, x = corpus(name)
    vals, ends, _, _ = model(name, **KERNEL)
    jcfg = JPassConfig(prep, enc, int(gs.max()), int(outs.max()), False, 8,
                       model_needed=False, unsigned_model=True)
    assert jcfg.hdr_bits == _hdr_bits(prep, enc)
    j_samples, j_end = j_decode.decode_blocks_device(
        jcfg, jnp.asarray(words), jnp.zeros((B, N), jnp.int32), N,
        jnp.asarray(gs.astype(np.uint32)), jnp.asarray(outs.astype(np.uint32)))
    jv = jnp.asarray(vals)
    if enc == 0:
        res = ((jv.astype(jnp.int32) & 0xFFFF) ^ 0x8000) - 0x8000
    else:
        res = j_golomb.unzigzag(jv)
    np.testing.assert_array_equal(np.asarray(j_samples),
                                  np.asarray(j_pre.preprocess_inverse(prep,
                                                                      res)))
    np.testing.assert_array_equal(np.asarray(j_end), ends)
    if x is not None:
        np.testing.assert_array_equal(np.asarray(j_samples), x)
        assert not (ends & BAD_CODE_POISON_BITS).any()


@pytest.mark.parametrize("name", ["zero", "mixed_g_multi", "junk_1"])
def test_speculation_alone_is_not_exact(name):
    """Without the synchronise rounds the segments' guesses give other
    values: the rounds are what makes the decode exact."""
    want_vals, _ = plain(name)
    vals, _, rounds, _ = model(name, **GEOMETRIES["S256_short"])
    assert max(rounds) > 0
    guessed, _, _, _ = model(name, **GEOMETRIES["S256_short"], max_rounds=0)
    assert not np.array_equal(guessed, want_vals)


@pytest.mark.parametrize("name", ["truncated_zero", "truncated_multi"])
def test_truncated_rows_run_past_their_end(name):
    """Every truncated row's chain leaves its nonzero words before the
    N-th code, so the closed-form tail is what the parity tests hold: the
    last code is the zero window's and ends past the last nonzero word."""
    words, prep, enc, gs, outs, _ = corpus(name)
    vals, ends, _, _ = model(name, **KERNEL)
    for i in range(B):
        z = _step([], 0, enc, int(gs[i]), int(outs[i]))
        assert vals[i, -1] == z[0]
        last_bit = 32 * (np.flatnonzero(words[i])[-1] + 1)
        assert (ends[i] & (BAD_CODE_POISON_BITS - 1)) > last_bit


# -- window mode -------------------------------------------------------------------

def stage_window(stream, start: int, width: int) -> np.ndarray:
    """Width words of the u32 word list ``stream`` from bit ``start``, as
    the port's plain ``stream_windows`` (``ops/decode_kernel.py``) builds
    them, word by word."""
    W = len(stream)
    base, r = (start >> 5, start & 31) if start >= 0 else (0, 0)
    avail = W - base if start >= 0 else 0

    def word(i):
        return int(stream[base + i]) if 0 <= i < avail else 0

    out = []
    for i in range(width):
        a = word(i)
        c = word(i + 1) if i + 1 < width else 0
        out.append(((a << r) | (c >> (32 - r))) & M32 if r else a)
    return np.array(out, np.uint32)


def _window_stream(seed: int, words: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 1 << 32, words, dtype=np.uint64).astype(np.uint32)


def _jax_windows(stream: np.ndarray, starts, width: int) -> np.ndarray:
    """Bits 128 on of the JAX tier's windows, as (len(starts), 2 width -
    8) u16 values: each window decoded as UNCOMPRESSED codes after a
    128-bit header (the window build is the JAX code's, sp.py:486-519)."""
    codes = (32 * width - 128) // 16
    cfg = JPassConfig(0, 0, 1, 1, False, 0, model_needed=False,
                      unsigned_model=True)
    samples, _ = j_sp._sidecar_decode_device(
        cfg, jnp.asarray(stream), jnp.asarray(np.asarray(starts, np.int32)),
        codes, width, 0, codes * len(starts))
    return (np.asarray(samples).reshape(len(starts), codes)
            & 0xFFFF).astype(np.uint16)


def _u16_after_header(windows: np.ndarray) -> np.ndarray:
    w = windows[:, 4:]
    return np.stack([w >> 16, w & 0xFFFF], axis=-1).reshape(
        w.shape[0], -1).astype(np.uint16)


WINDOW_CASES = {
    "starts_0_63": (97, list(range(64)), 12),
    "near_end": (40, [32 * 40 - 64 + k for k in (0, 1, 17, 31, 32, 33, 63)]
                 + [32 * 40 - 1, 32 * 40 - 200], 9),
    "past_end": (40, [32 * 40, 32 * 40 + 77, 32 * 45], 9),
    "unaligned_tail": (41, [5, 32 * 41 - 300, 32 * 33 + 31], 16),
}


@pytest.mark.parametrize("case", list(WINDOW_CASES))
def test_window_model_matches_jax(case):
    """The staged windows equal the JAX tier's window build (from bit 128
    on, what the UNCOMPRESSED read-back can see) and the port's plain
    ``stream_windows`` (every word)."""
    words, starts, width = WINDOW_CASES[case]
    stream = _window_stream(len(case), words)
    model = np.stack([stage_window(stream, s, width) for s in starts])
    np.testing.assert_array_equal(_u16_after_header(model),
                                  _jax_windows(stream, starts, width))
    plain = stream_windows(torch.from_numpy(stream.view(np.int32)),
                           torch.tensor(starts), width)
    np.testing.assert_array_equal(plain.numpy().view(np.uint32), model)


def test_window_model_below_zero_and_plain():
    """A start below 0 stages zeros (the kernel reads nothing); the plain
    window decode equals the step loop on the model's windows."""
    stream = _window_stream(3, 30)
    starts = [-1, -32, -(1 << 30), 0, 33, 32 * 30 - 40]
    model = np.stack([stage_window(stream, s, 10) for s in starts])
    assert not model[:3].any()
    plain = stream_windows(torch.from_numpy(stream.view(np.int32)),
                           torch.tensor(starts), 10)
    np.testing.assert_array_equal(plain.numpy().view(np.uint32), model)
    g = torch.tensor([1, 4, 0xFFFF, 2, 3, 4])
    o = torch.tensor([derive_encoder_outlier(1, int(v), 40) for v in g])
    vals, ends = decode_windows(torch.from_numpy(stream.view(np.int32)),
                                torch.tensor(starts), 10, 0, 20, 1, g, o)
    want = decode_codes_plain(torch.from_numpy(model.view(np.int32)), 0, 20,
                              1, g, o)
    np.testing.assert_array_equal(vals.numpy(), want[0].numpy())
    np.testing.assert_array_equal(ends.numpy(), want[1].numpy())


def test_sidecar_windows_decode_the_chunks():
    """Windows of a long frame at its chunks' start bits (the sidecar's
    offsets) decode each chunk and end on its boundary (the segment
    model, per window)."""
    from airs_compression_tpu_torch import CmpParams, EncoderType, \
        Preprocessing
    from airs_compression_tpu_torch.parallel import sp as t_sp

    params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                       primary_encoder_type=EncoderType.GOLOMB_ZERO,
                       primary_encoder_param=4)
    x = (_detector(np.random.default_rng(21), 1, 8 * N, 0.05)[0]
         & 0xFFFF).astype(np.uint16)
    frame = t_sp.compress_long_stream(params, x, device="cpu")
    chunk_bits = t_sp.stream_chunk_index(params, x, N, device="cpu")
    stream = np.frombuffer(frame + bytes(-len(frame) % 4), ">u4")
    outlier = derive_encoder_outlier(1, 4, 0)
    mapped = t_golomb.zigzag(t_pre.diff_forward(
        torch.from_numpy(x.view(np.int16).astype(np.int32)))).numpy()
    hb = _hdr_bits(1, 1)
    off = hb + np.concatenate([[0], np.cumsum(chunk_bits)[:-1]])
    width = (hb + int(chunk_bits.max()) + 63) // 32 + 2
    for c in range(8):
        win = stage_window(stream, int(off[c]) - hb, width)
        vals, end, _, _ = segment_decode(win, hb, N, 1, 4, outlier, **KERNEL)
        assert end == hb + chunk_bits[c]
        np.testing.assert_array_equal(vals, mapped[c * N:(c + 1) * N])


# -- window mode: the window kernel --------------------------------------------

WIN_WARPS = 8  # warps a CTA (csrc/decode.cu kWinWarps)
# an H100: its SMs, and the shared memory a CTA of the window kernel may
# take (the opt-in maximum less the kernel's static arrays)
WIN_SMS = 132
WIN_SMEM = 232448 - 4 * (2 * WIN_WARPS + 4 * WIN_WARPS)


def window_plan(b: int, width: int, n: int, hdr_bits: int,
                sms: int = WIN_SMS, avail: int = WIN_SMEM):
    """(warps a window, span words, kept codes a segment, rows staged) of
    a launch of b windows, as ``csrc/decode.cu`` ``window_smem`` plans
    them: more warps a window while the launch leaves the SMs under 32
    warps and the windows have the bits for their segments."""
    bits = max(0, 32 * width - hdr_bits)
    warps = 1
    while warps < 4 and b * warps * 2 <= sms * 32 and 32 * warps * 64 < bits:
        warps *= 2
    windows = WIN_WARPS // warps
    segs = max(1, min(32 * warps, bits // 64))
    per_seg = -(-n // segs)
    room = per_seg + per_seg // 4 + 4
    n_pad = (n + 7) & ~7
    span = ((windows * width + 8 + 3) & ~3) * 4
    out = windows * n_pad * 2
    per_code = WIN_WARPS * 32 * 3
    if span + out + per_code * room > avail:
        span = 0
    if out + per_code * room > avail:
        out = 0
    room = min(room, (avail - span - out) // per_code)
    return warps, span // 4, room, bool(out)


def _warp_decode(word, lim, r, hdr_bits, n, enc, g, outlier, lanes, room,
                 min_seg_bits, stage_out, stats, max_rounds=None,
                 keep_offset=0):
    """One window by one warp of the window kernel: (row of n values, end
    bit in the window with the poison, synchronise rounds).  ``word(k)``
    reads the window's k-th word from its base word (k < lim); at most
    ``lanes`` segments, one a lane."""
    last = max((k for k in range(lim) if word(k)), default=-1)
    words = [word(k) for k in range(last + 1)]  # the cursor's limit

    def decode(pos):
        stats["decodes"] += 1
        return _step(words, pos, enc, g, outlier)

    hdr_q = hdr_bits + r  # bits of the stream from the base word
    end_bits = max(hdr_q, 32 * len(words))
    bits = end_bits - hdr_q
    seg = max(min_seg_bits, -(-bits // lanes))
    n_seg = -(-bits // seg)
    assert n_seg <= lanes
    seg_start = [hdr_q + t * seg for t in range(n_seg)]
    seg_end = [min(s + seg, end_bits) for s in seg_start]

    # speculate, keeping the first codes (value, length) up to the room,
    # up to the first malformed code
    spec = []
    for t in range(n_seg):
        pos, count, starts, kept = seg_start[t], 0, [], []
        while pos < seg_end[t]:
            if pos - seg_start[t] < 64:
                starts.append(pos)
            m, c, b = decode(pos)
            if count == len(kept) < room and not b:
                kept.append((m, c))
            pos += c
            count += 1
        spec.append((pos, count, starts, kept))

    def walk(t, pos):
        """(exit, count, fresh codes, kept index k0, its bit p0) from entry
        ``pos``; a walk that joins the speculative one follows it."""
        s_exit, s_count, starts, _ = spec[t]
        c = 0
        while pos < seg_end[t]:
            if pos - seg_start[t] < 64 and pos in starts:
                k = starts.index(pos)
                return s_exit, c + s_count - k, c, k, pos
            pos += decode(pos)[1]
            c += 1
        return pos, c, c, 0, pos

    entry = list(seg_start)
    state = [(s[0], s[1], 0, 0, seg_start[t]) for t, s in enumerate(spec)]
    rounds = 0
    while max_rounds is None or rounds < max_rounds:
        new = [hdr_q] + [st[0] for st in state[:-1]]
        redo = [t for t in range(n_seg) if new[t] != entry[t]]
        if not redo:
            break
        for t in redo:
            entry[t] = new[t]
            state[t] = walk(t, entry[t])
        rounds += 1

    counts = [st[1] for st in state]
    firsts = [0] + list(np.cumsum(counts, dtype=np.int64)[:-1])
    total = sum(counts)
    row = [None] * n
    out = {"end": hdr_q if n == 0 else None, "bad": False}

    def write(t, store):
        first = int(firsts[t])
        if first >= n:
            return
        _, count, fresh, k0, p0 = state[t]
        kept = spec[t][3]
        stop = min(count, n - first)
        pos, j = entry[t], 0
        while j < min(fresh, stop):
            m, c, b = decode(pos)
            store(first + j, m)
            out["bad"] |= b
            pos += c
            j += 1
        if j < stop:
            pos, i = p0, k0 + keep_offset
            while j < stop and i < len(kept):
                store(first + j, kept[i][0])
                stats["kept"] += 1
                pos += kept[i][1]
                i += 1
                j += 1
            while j < stop:  # past the room: decoded again
                m, c, b = decode(pos)
                store(first + j, m)
                out["bad"] |= b
                pos += c
                j += 1
        if first + stop == n:
            out["end"] = pos

    big = set()

    def store_once(i, v, t=None):
        assert row[i] is None, f"value {i} stored twice"
        row[i] = v & 0xFFFF if stage_out else v
        if stage_out and v > 0xFFFF:
            big.add(t)

    for t in range(n_seg):
        write(t, lambda i, v, t=t: store_once(i, v, t))
    if total < n:  # the chain left the nonzero words: zero windows
        zm, zc, zb = _step([], 0, enc, g, outlier)
        assert zm == 0  # so never over 16 bits
        for i in range(total, n):
            store_once(i, zm)
        out["bad"] |= zb
        tail_from = state[-1][0] if n_seg else hdr_q
        out["end"] = tail_from + (n - total) * zc
    assert None not in row
    for t in sorted(big):  # lanes with a value over 16 bits: again, whole

        def store_whole(i, v):
            row[i] = v
        write(t, store_whole)
    stats["big"] += len(big)
    end = out["end"] - r + (BAD_CODE_POISON_BITS if out["bad"] else 0)
    return row, end, rounds


def window_kernel(stream, starts, width: int, hdr_bits: int, n: int,
                  enc: int, gs, outs, *, lanes=None, windows=None, room=None,
                  span_room=None, stage_out=None, min_seg_bits: int = 64,
                  max_rounds=None, keep_offset: int = 0):
    """K3's window kernel on windows of the u32 word list ``stream`` at bit
    ``starts``: (values (B, n) u32, end bits (B,) int32, rounds, stats).
    ``lanes`` (segments a window: 32 a warp), ``windows`` (a CTA),
    ``room``, ``span_room`` and ``stage_out`` default to the kernel's plan
    (:func:`window_plan`); ``keep_offset`` shifts the kept values read at a
    join (a mutation the tests must catch)."""
    plan = window_plan(len(starts), width, n, hdr_bits)
    lanes = 32 * plan[0] if lanes is None else lanes
    windows = WIN_WARPS // plan[0] if windows is None else windows
    span_room = plan[1] if span_room is None else span_room
    room = plan[2] if room is None else room
    stage_out = plan[3] if stage_out is None else stage_out
    W, B = len(stream), len(starts)
    vals = np.zeros((B, n), np.uint32)
    ends = np.zeros(B, np.int64)
    rounds = [0] * B
    stats = collections.Counter(decodes=0, kept=0, big=0, spans=0, ctas=0)
    for c0 in range(0, B, windows):
        geo = []
        for b in range(c0, min(c0 + windows, B)):
            s = int(starts[b])
            if s >= 0:
                base, r = s >> 5, s & 31
                geo.append((b, base, r, max(0, min(width, W - base))))
            else:  # a start below 0 reads zeros
                geo.append((b, 0, 0, 0))
        live = [(base, base + lim) for _, base, _, lim in geo if lim]
        span = None
        if span_room and live:
            lo_al = min(lo for lo, _ in live) & ~3
            hi = max(hi for _, hi in live)
            if hi - lo_al <= span_room:
                span = {e - lo_al: int(stream[e]) for e in range(lo_al, hi)}
                stats["spans"] += 1
        stats["ctas"] += 1
        for b, base, r, lim in geo:

            def word(k, base=base, lim=lim):
                assert 0 <= k < lim <= width
                if span is not None:
                    return span[base - lo_al + k]
                assert base + k < W
                return int(stream[base + k])
            row, ends[b], rounds[b] = _warp_decode(
                word, lim, r, hdr_bits, n, enc, int(gs[b]), int(outs[b]),
                lanes, room, min_seg_bits, stage_out, stats, max_rounds,
                keep_offset)
            vals[b] = row
    return vals, ends.astype(np.int32), rounds, stats


WN = 96  # codes a window (a sidecar chunk's samples)


def _sidecar(enc: int, seed: int, chunks: int):
    """(stream u32, starts, width, g, outlier) of a long frame's sidecar
    windows, as ``parallel/sp.py`` ``decompress_long_stream`` builds them,
    and the frame's mapped values; MULTI frames carry 48-bit escapes."""
    from airs_compression_tpu_torch import CmpParams, EncoderType, \
        Preprocessing
    from airs_compression_tpu_torch.parallel import sp as t_sp

    g, raw = (4, 0) if enc == 1 else (2, 40)
    params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                       primary_encoder_type=EncoderType(enc),
                       primary_encoder_param=g, primary_encoder_outlier=raw)
    x = (_detector(np.random.default_rng(seed), 1, chunks * WN,
                   0.1 if enc == 2 else 0.05)[0] & 0xFFFF).astype(np.uint16)
    frame = t_sp.compress_long_stream(params, x, device="cpu")
    chunk_bits = t_sp.stream_chunk_index(params, x, WN, device="cpu")
    stream = np.frombuffer(frame + bytes(-len(frame) % 4), ">u4").astype(
        np.uint32)
    hb = _hdr_bits(1, enc)
    # each chunk's window starts hb bits before its first code, where the
    # header's bits end (sp.py: the payload offset less hb)
    starts = np.concatenate([[0], np.cumsum(chunk_bits)[:-1]])
    width = (hb + int(chunk_bits.max()) + 63) // 32 + 2
    outlier = derive_encoder_outlier(enc, g, raw)
    mapped = t_golomb.zigzag(t_pre.diff_forward(
        torch.from_numpy(x.view(np.int16).astype(np.int32)))).numpy()
    return stream, starts, width, g, outlier, mapped, chunk_bits


WINDOW_CORPORA = ["sidecar_zero", "sidecar_multi", "shuffled", "duplicated",
                  "below_and_past", "b1", "junk_0", "junk_1", "junk_2",
                  "ones_1", "ones_2", "zeros_1"]


@functools.cache
def window_corpus(name: str):
    """(stream u32, starts, width, hdr_bits, n, enc, g (B,), outlier (B,),
    mapped values or None)."""
    rng = np.random.default_rng(100 + WINDOW_CORPORA.index(name))
    if name in ("sidecar_zero", "b1"):
        stream, st, width, g, o, mapped, _ = _sidecar(1, 31, 13)
        enc = 1
    elif name in ("sidecar_multi", "shuffled", "duplicated",
                  "below_and_past"):
        stream, st, width, g, o, mapped, _ = _sidecar(2, 32, 13)
        enc = 2
    if name.startswith(("sidecar", "b1", "shuffled", "duplicated", "below")):
        hb = _hdr_bits(1, enc)
        st = np.asarray(st, np.int64)
        if name == "b1":
            st, mapped = st[5:6], mapped[5 * WN:6 * WN]
        elif name == "shuffled":
            perm = rng.permutation(st.size)
            st, mapped = st[perm], mapped.reshape(-1, WN)[perm].reshape(-1)
        elif name == "duplicated":
            pick = np.sort(rng.integers(0, st.size, 11))
            pick[3:6] = pick[3]
            st, mapped = st[pick], mapped.reshape(-1, WN)[pick].reshape(-1)
        elif name == "below_and_past":
            W32 = 32 * stream.size
            st = np.concatenate([st[:3], [-1, -32, -(1 << 30), W32,
                                          W32 + 77, W32 - 40, W32 - 1], st[3:6]])
            mapped = None
        B = st.size
        return (stream, st, width, hb, WN, enc, np.full(B, g),
                np.full(B, o), mapped)
    kind, enc = name.rsplit("_", 1)
    enc = int(enc)
    W = 700
    if kind == "junk":
        stream = rng.integers(0, 1 << 32, W, dtype=np.uint64).astype(np.uint32)
    else:
        stream = np.full(W, M32 if kind == "ones" else 0, np.uint32)
    st = np.concatenate([rng.integers(0, 32 * W, 9), [32 * W - 100, 3]])
    gs = np.array([0] * 11) if enc == 0 else rng.choice([1, 4, 0xFFFF], 11)
    outs = np.array([derive_encoder_outlier(enc, int(v), 40) if enc else 0
                     for v in gs])
    return stream, st, 30, 16, 48, enc, gs, outs, None


@functools.cache
def window_plain(name: str):
    stream, st, width, hb, n, enc, gs, outs, _ = window_corpus(name)
    vals, end = decode_windows_plain(
        torch.from_numpy(stream.view(np.int32)), torch.from_numpy(st), width,
        hb, n, enc, torch.from_numpy(gs), torch.from_numpy(outs))
    return vals.numpy().view(np.uint32), end.numpy()


WINDOW_GEOMETRIES = {
    "kernel": {},
    # every kept-code room overflows: decoded again past it
    "room0": dict(room=0),
    "room3": dict(room=3),
    # the CTA's span never fits: every window read from the stream
    "no_span": dict(span_room=0),
    "span_tight": dict(span_room=40),
    "rows_direct": dict(stage_out=False),
    "lanes7": dict(lanes=7, windows=3),
    "windows1": dict(windows=1),
    # a launch of few windows takes 2 or 4 warps a window
    "warps2": dict(lanes=64, windows=4),
    "warps4": dict(lanes=128, windows=2),
}


@pytest.mark.parametrize("geometry", list(WINDOW_GEOMETRIES))
@pytest.mark.parametrize("name", WINDOW_CORPORA)
def test_window_kernel_model_matches_plain(name, geometry):
    """Values and poisoned end bits equal ``decode_windows_plain``'s; real
    sidecar windows decode their chunks and end on their boundaries."""
    stream, st, width, hb, n, enc, gs, outs, mapped = window_corpus(name)
    vals, ends, rounds, stats = window_kernel(
        stream, st, width, hb, n, enc, gs, outs,
        **WINDOW_GEOMETRIES[geometry])
    want_vals, want_end = window_plain(name)
    np.testing.assert_array_equal(vals, want_vals)
    np.testing.assert_array_equal(ends, want_end)
    assert stats["ctas"] == -(-st.size // WINDOW_GEOMETRIES[geometry].get(
        "windows", WIN_WARPS // window_plan(st.size, width, n, hb)[0]))
    if geometry == "kernel" and name.startswith("sidecar"):
        assert stats["spans"] == stats["ctas"]  # consecutive chunks: staged
    if geometry == "no_span":
        assert stats["spans"] == 0
    if geometry == "span_tight" and st.size > 1:  # a window fits, not two
        assert stats["spans"] < stats["ctas"]
    if mapped is not None:
        np.testing.assert_array_equal(vals.reshape(-1), mapped)
        assert not (ends & BAD_CODE_POISON_BITS).any()


def _jax_window_decode(stream, starts, width, hb, n, enc, g, outlier):
    """The JAX tier's window build and scan decoder on the CPU: (residuals
    (B, n), end bits (B,))."""
    jcfg = JPassConfig(0, enc, g, outlier, False, 8, model_needed=False,
                       unsigned_model=True)  # no inverse preprocessing
    assert jcfg.hdr_bits == hb
    res, end = j_sp._sidecar_decode_device(
        jcfg, jnp.asarray(stream), jnp.asarray(np.asarray(starts, np.int32)),
        n, width, 0, n * len(starts))
    return np.asarray(res).reshape(len(starts), n), np.asarray(end)


@pytest.mark.parametrize("name", ["sidecar_zero", "sidecar_multi",
                                  "shuffled", "duplicated", "b1"])
def test_window_kernel_model_matches_jax(name):
    """Where every start lies in the stream, the model's values (unzigzag)
    and end bits equal the JAX tier's window decode."""
    stream, st, width, hb, n, enc, gs, outs, _ = window_corpus(name)
    vals, ends, _, _ = window_kernel(stream, st, width, hb, n, enc, gs, outs)
    res, j_end = _jax_window_decode(stream, st, width, hb, n, enc,
                                    int(gs[0]), int(outs[0]))
    np.testing.assert_array_equal(
        t_golomb.unzigzag(torch.from_numpy(vals.astype(np.int64))).numpy(),
        res)
    np.testing.assert_array_equal(ends, j_end)


def test_window_kernel_decodes_each_code_once():
    """On a sidecar at 1024 codes a chunk (phase G's chunk, its noise),
    the kernel decodes at most 1.3 codes a written code, the kept values
    carry most of them, and every window is read from one staged span."""
    from airs_compression_tpu_torch import CmpParams, EncoderType, \
        Preprocessing
    from airs_compression_tpu_torch.parallel import sp as t_sp

    params = CmpParams(primary_preprocessing=Preprocessing.DIFF,
                       primary_encoder_type=EncoderType.GOLOMB_ZERO,
                       primary_encoder_param=4)
    rng = np.random.default_rng(50)
    x = ((1000 + rng.normal(0, 4, 10 * 1024)).astype(np.int64)
         & 0xFFFF).astype(np.uint16)
    frame = t_sp.compress_long_stream(params, x, device="cpu")
    chunk_bits = t_sp.stream_chunk_index(params, x, 1024, device="cpu")
    stream = np.frombuffer(frame + bytes(-len(frame) % 4), ">u4").astype(
        np.uint32)
    hb = _hdr_bits(1, 1)
    starts = np.concatenate([[0], np.cumsum(chunk_bits)[:-1]])
    width = (hb + int(chunk_bits.max()) + 63) // 32 + 2
    g = np.full(starts.size, 4)
    o = np.full(starts.size, derive_encoder_outlier(1, 4, 0))
    # phase G's launch: 4096 windows, one warp each
    warps, span_room, room, _ = window_plan(4096, width, 1024, hb)
    assert warps == 1
    vals, ends, rounds, stats = window_kernel(
        stream, starts, width, hb, 1024, 1, g, o, lanes=32, windows=8,
        room=room, span_room=span_room)
    np.testing.assert_array_equal(ends, hb + chunk_bits)
    mapped = t_golomb.zigzag(t_pre.diff_forward(
        torch.from_numpy(x.view(np.int16).astype(np.int32)))).numpy()
    np.testing.assert_array_equal(vals.reshape(-1), mapped)
    assert stats["decodes"] <= 1.3 * vals.size
    assert stats["kept"] >= 0.8 * vals.size
    assert stats["spans"] == stats["ctas"] == 2
    assert max(rounds) <= 2


@pytest.mark.parametrize("name", ["sidecar_multi", "junk_2"])
def test_window_kernel_model_catches_a_wrong_join(name):
    """Kept values read one code off at a join give other values: the
    parity tests see the join."""
    stream, st, width, hb, n, enc, gs, outs, _ = window_corpus(name)
    vals, _, rounds, _ = window_kernel(stream, st, width, hb, n, enc, gs,
                                       outs, lanes=32, min_seg_bits=1)
    assert max(rounds) > 0
    bad, _, _, _ = window_kernel(stream, st, width, hb, n, enc, gs, outs,
                                 lanes=32, min_seg_bits=1, keep_offset=1)
    assert not np.array_equal(bad, vals)
