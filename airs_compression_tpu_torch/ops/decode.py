"""Batch block decoder: Golomb codes -> residuals -> samples.

Port of ``airs_compression_tpu/ops/decode.py``.  Golomb decoding is
bit-serial within a block (each codeword's position depends on all earlier
lengths).  The plain version here parallelizes ACROSS blocks: B
independent bit cursors advance one code per step.  Each step takes the
64-bit window at the cursor, counts leading ones and inverts the
closed-form Golomb / escape code (encoder.c:303-378).  On the card kernel
K3 (ops/decode_kernel.py) runs the same step function and also decodes
WITHIN a block, by speculative segments that resynchronise; the helpers
here are its plain version, vectorized over B.

The decoded residuals then run through the batched inverse preprocessors
(ops/preprocess.py): wraparound cumsum for DIFF, inverse lifting for IWT,
model add for MODEL.

u32 values are int64 tensors masked to 32 bits (ops/u32.py); frame words
arrive as int32 bit patterns, the form the kernel takes.
"""

from __future__ import annotations

import torch

from . import golomb, preprocess
from .encode import PassConfig
from .u32 import MASK, from_bits

__all__ = ["decode_blocks_device", "decode_blocks_uncompressed",
           "BAD_CODE_POISON_BITS"]

# poison added to a lane's end bit position when a malformed codeword is
# seen: guarantees (end + 7) // 8 exceeds any 24-bit compressed_size, so
# the callers' exhaustion checks reject the block
BAD_CODE_POISON_BITS = 1 << 29


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Count leading zeros of u32 values (32 for x == 0)."""
    return torch.where(x == 0, 32, 31 - golomb.ilog2(x))


def _window64(words: torch.Tensor, bitpos: torch.Tensor):
    """(hi, lo) 64-bit window starting at ``bitpos`` for each block.

    ``words`` is (B, W) int64 u32 values whose last 3 columns are zeros
    (reads past a row give zeros, as in kernel K3); ``bitpos`` is (B,).
    """
    W = words.shape[-1]
    wi = bitpos >> 5
    r = bitpos & 31

    def take(i):
        return torch.gather(words, 1, i.clamp(0, W - 1)[:, None])[:, 0]

    w0, w1, w2 = take(wi), take(wi + 1), take(wi + 2)
    # w >> (32 - r) is 0 for r == 0 (an int64 shift by 32)
    hi = ((w0 << r) & MASK) | (w1 >> (32 - r))
    lo = ((w1 << r) & MASK) | (w2 >> (32 - r))
    return hi, lo


def _take_bits(hi: torch.Tensor, lo: torch.Tensor, start, count):
    """Extract ``count`` bits of the 64-bit window starting at ``start``
    (MSB-relative); start in [0, 63], count in [0, 32]."""
    s = torch.as_tensor(start, device=hi.device)
    c = torch.as_tensor(count, device=hi.device)
    top = torch.where(
        s >= 32, (lo << (s - 32).clamp(0, 31)) & MASK,
        ((hi << s.clamp(0, 31)) & MASK) | (lo >> (32 - s).clamp(0, 32)))
    return top >> (32 - c)


def _golomb_terms(g: torch.Tensor, outlier: torch.Tensor):
    """Per-lane (g, g_log2, cutoff, outlier) decode constants."""
    g_log2 = golomb.ilog2(g)
    cutoff = (2 << g_log2) - g
    return g, g_log2, cutoff, outlier


def _decode_one(enc_type: int, hi: torch.Tensor, lo: torch.Tensor, terms):
    """Decode one codeword per block from its 64-bit window.

    Returns (mapped_or_raw_value, consumed_bits, bad) — ``bad`` marks a
    MALFORMED codeword: a Golomb part wider than the format's 32-bit
    codeword cap (reference encoder.h:17-30) or a MULTI escape asking for
    more than 32 raw bits, or a mapped value over 16 bits.  Such codewords
    only occur in corrupt streams; the host decoders reject them, so the
    device poisons the block's end position.
    """
    if enc_type == 0:  # UNCOMPRESSED: raw 16-bit residual
        return (hi >> 16, torch.full_like(hi, 16),
                torch.zeros(hi.shape, dtype=torch.bool, device=hi.device))

    g_par, g_log2, cutoff, outlier = terms
    # unary quotient: leading ones
    q = _clz32(~hi & MASK)
    # remainder: g_log2 bits after the terminating zero
    r0 = _take_bits(hi, lo, q + 1, g_log2)
    long_form = (r0 >= cutoff).to(torch.int64)
    extra = _take_bits(hi, lo, q + 1 + g_log2, long_form)
    r_long = (((r0 << 1) | extra) - cutoff) & MASK
    rem = torch.where(long_form == 1, r_long, r0)
    v = (q * g_par + rem) & MASK
    consumed = q + 1 + g_log2 + long_form
    bad = consumed > 32  # Golomb part exceeds the 32-bit codeword cap

    if enc_type == 1:  # GOLOMB_ZERO
        esc = v == 0
        raw = _take_bits(hi, lo, consumed, torch.where(esc, 16, 0))
        mapped = torch.where(esc, raw, (v - 1) & MASK)
        consumed = consumed + torch.where(esc, 16, 0)
        return mapped, consumed, bad | (mapped > 0xFFFF)

    if enc_type == 2:  # GOLOMB_MULTI
        esc = v >= outlier
        level = torch.where(esc, v - outlier, 0)
        nbits = ((level + 1) * 2) & MASK
        bad = bad | (esc & (nbits > 32))
        nbits = nbits.clamp(max=32)  # keep the window math in range
        diff = _take_bits(hi, lo, consumed, torch.where(esc, nbits, 0))
        mapped = torch.where(esc, (outlier + diff) & MASK, v)
        consumed = consumed + torch.where(esc, nbits, 0)
        return mapped, consumed, bad | (mapped > 0xFFFF)

    raise ValueError(f"unknown encoder type {enc_type}")


def decode_blocks_uncompressed(words: torch.Tensor, n_samples: int):
    """Closed-form decode of NONE+UNCOMPRESSED frames (no step loop).

    Such frames — notably the engine's uncompressed-fallback output
    (reference cmp.c:342-393) — have a 16-byte (4-word) header followed by
    word-aligned raw big-endian samples, so decoding is a slice + bit
    split.  ``words`` are int32 BE word bits; returns (B, N) int32
    sign-extended i16 samples.
    """
    B = words.shape[0]
    n_payload = (n_samples + 1) // 2
    w = from_bits(words[:, 4: 4 + n_payload])
    vals = torch.stack([w >> 16, w & 0xFFFF], dim=-1).reshape(B, -1)
    return preprocess.wrap16(vals[:, :n_samples]).to(torch.int32)


def decode_blocks_device(cfg: PassConfig, words: torch.Tensor,
                         model: torch.Tensor, n_samples: int,
                         g: "torch.Tensor | None" = None,
                         outlier: "torch.Tensor | None" = None):
    """Decode (B, W) frames (header included) -> (B, N) int32 samples.

    ``words`` are int32 BE word bits.  All blocks share ``cfg``'s
    preprocessing, encoder type and header size; the Golomb parameter and
    outlier are per block: ``g``/``outlier`` (B,) from the headers, or
    ``cfg``'s values for every block when omitted.  ``model`` is
    consulted only for MODEL preprocessing.  Returns (samples (B, N)
    int32 sign-extended i16, end_bitpos (B,) int32).

    The step loop runs in kernel K3 for CUDA tensors and in
    :func:`decode_codes_plain` for CPU tensors (ops/decode_kernel.py).
    Reads past a row give zeros; the JAX scan repeats the row's last word
    instead, which is the same whenever that word is zero, as it is in
    staged rows and in encoder output.
    """
    from .decode_kernel import decode_blocks

    B = words.shape[0]
    if g is None:
        g = torch.full((B,), cfg.g_par, dtype=torch.int64, device=words.device)
        outlier = torch.full((B,), cfg.outlier, dtype=torch.int64,
                             device=words.device)
    vals, end_pos = decode_blocks(words, cfg.hdr_bits, n_samples,
                                  cfg.enc_type, g, outlier)
    if cfg.enc_type == 0:
        residuals = preprocess.wrap16(vals)
    else:
        residuals = golomb.unzigzag(vals)
    samples = preprocess.preprocess_inverse(
        cfg.prep, residuals, model if cfg.prep == 3 else None)
    return samples, end_pos
