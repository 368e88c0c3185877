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
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from airs_compression_tpu.ops import decode as j_decode
from airs_compression_tpu.ops import golomb as j_golomb
from airs_compression_tpu.ops import preprocess as j_pre
from airs_compression_tpu.ops.encode import PassConfig as JPassConfig

from airs_compression_tpu_torch.ops import encode as t_encode
from airs_compression_tpu_torch.ops import golomb as t_golomb
from airs_compression_tpu_torch.ops import preprocess as t_pre
from airs_compression_tpu_torch.ops.decode import BAD_CODE_POISON_BITS
from airs_compression_tpu_torch.ops.decode_kernel import (
    decode_blocks,
    decode_codes_plain,
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


def test_decode_blocks_rounds_are_kernel_only():
    words, prep, enc, gs, outs, _ = corpus("zero")
    with pytest.raises(ValueError, match="CUDA kernel only"):
        decode_blocks(torch.from_numpy(words.view(np.int32)),
                      _hdr_bits(prep, enc), N, enc, torch.from_numpy(gs),
                      torch.from_numpy(outs),
                      rounds=torch.zeros(B, dtype=torch.int32))
