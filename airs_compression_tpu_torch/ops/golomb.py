"""Closed-form Golomb codeword generation on tensors.

Port of ``airs_compression_tpu/ops/golomb.py``.  The reference encodes one
sample at a time through a branchy scalar routine
(lib/compress/encoder.c:303-378); here every sample's codeword is a
closed-form elementwise function of the zigzag-mapped value: a
(hi, lo, len) triple — the codeword's up-to-48 bits split across two u32
words plus its bit length.  u32 values are int64 tensors masked to 32 bits
(see ops/u32.py).

Codeword construction (identical bits to the reference):
  value < cutoff:  value in (glog2+1) bits
  else:            group = (value-cutoff)/g;  rem = (value-cutoff)%g
                   [group ones] [(cutoff<<1)+rem in glog2+2 bits]
ZERO escape  (mapped >= outlier): Golomb(0) zeros + 16 raw bits, one write
MULTI escape (mapped >= outlier): Golomb(outlier+level) + (level+1)*2 raw
                                  bits of diff, level = ilog2(diff)/2
"""

from __future__ import annotations

import torch

from .u32 import MASK

__all__ = ["zigzag", "unzigzag", "ilog2", "golomb_codeword",
           "encode_codewords"]


def zigzag(v: torch.Tensor) -> torch.Tensor:
    """ZigZag map of i16 residuals (sign-extended) -> int64 in [0, 65535].

    Mirrors reference map_to_unsigned with n_bits=16 (encoder.c:274-286).
    """
    v = v.to(torch.int64)
    return ((v << 1) ^ (v >> 15)) & 0xFFFF


def unzigzag(m: torch.Tensor) -> torch.Tensor:
    """Inverse zigzag: mapped values as int32 bit patterns -> int32
    sign-extended residuals (the JAX version's uint32 -> int32 cast)."""
    mi = m.to(torch.int32)
    return (mi >> 1) ^ -(mi & 1)


def ilog2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(x)) for u32 values x >= 1, exact (encoder.c:40-49);
    0 for x == 0."""
    r = torch.zeros_like(x)
    for shift in (16, 8, 4, 2, 1):
        m = x >= (1 << shift)
        r = torch.where(m, r + shift, r)
        x = torch.where(m, x >> shift, x)
    return r


def golomb_codeword(v: torch.Tensor, g_par: int, g_log2: int):
    """Codewords for u32 values known to be < golomb_upper_bound.

    ``g_par``/``g_log2`` are Python ints.  Returns (cw, len) as int64
    tensors; lengths never exceed 32 (guaranteed by the outlier clamp,
    encoder.c:211-216).
    """
    cutoff = (2 << g_log2) - g_par
    len0 = g_log2 + 1
    in_g0 = v < cutoff
    vg = torch.where(in_g0, 0, v - cutoff)
    group = vg // g_par
    rem = vg - group * g_par
    gclamp = group.clamp(max=31)
    unary = torch.where(group >= 32, MASK,
                        (torch.ones_like(gclamp) << gclamp) - 1)
    cw_hi = ((unary << (len0 + 1)) + (cutoff << 1) + rem) & MASK
    cw = torch.where(in_g0, v, cw_hi)
    ln = torch.where(in_g0, len0, len0 + 1 + group)
    return cw, ln


def encode_codewords(residuals: torch.Tensor, encoder_type: int, g_par: int,
                     outlier: int):
    """(hi, lo, len) codeword triples (int64) for a batch of residuals.

    ``residuals`` are sign-extended i16 values; the configuration is plain
    Python ints.  Mirrors reference cmp_encoder_encode_s16
    (encoder.c:327-378) semantics exactly, vectorized.
    """
    r = residuals.to(torch.int64)
    if encoder_type == 0:  # UNCOMPRESSED: raw 16-bit residual
        lo = r & 0xFFFF
        return torch.zeros_like(lo), lo, torch.full_like(lo, 16)

    g_log2 = int(g_par).bit_length() - 1
    m = zigzag(r)
    if encoder_type == 1:  # GOLOMB_ZERO
        esc = m >= outlier
        cw, ln = golomb_codeword(torch.where(esc, 0, m + 1), g_par, g_log2)
        # escape: Golomb(0) zeros then 16 raw bits, combined (<=32 bits)
        lo = torch.where(esc, m, cw)
        ln = torch.where(esc, g_log2 + 1 + 16, ln)
        return torch.zeros_like(lo), lo, ln

    if encoder_type == 2:  # GOLOMB_MULTI
        esc = m >= outlier
        diff = torch.where(esc, m - outlier, 0)
        level = torch.where(diff < 4, 0, ilog2(diff) >> 1)
        cw, ln = golomb_codeword(torch.where(esc, outlier + level, m),
                                 g_par, g_log2)
        raw_bits = (level + 1) * 2  # in [2, 16]
        # combined (cw << raw_bits) | diff across a 48-bit (hi, lo) pair
        hi = torch.where(esc, cw >> (32 - raw_bits), 0)
        lo = torch.where(esc, ((cw << raw_bits) & MASK) | diff, cw)
        ln = torch.where(esc, ln + raw_bits, ln)
        return hi, lo, ln

    raise ValueError(f"unknown encoder type {encoder_type}")


def _golomb_length(v: torch.Tensor, g_par: int, g_log2: int) -> torch.Tensor:
    """The length alone of :func:`golomb_codeword`'s codeword for ``v``."""
    cutoff = (2 << g_log2) - g_par
    group = (v - cutoff).clamp(min=0) // g_par
    return torch.where(v < cutoff, g_log2 + 1, g_log2 + 2 + group)


def code_lengths(residuals: torch.Tensor, encoder_type: int, g_par: int,
                 outlier: int) -> torch.Tensor:
    """The lengths (int64) of :func:`encode_codewords`' codes, without the
    codewords: what a row's start bits need before a kernel packs it."""
    r = residuals.to(torch.int64)
    if encoder_type == 0:
        return torch.full_like(r, 16)
    g_log2 = int(g_par).bit_length() - 1
    m = zigzag(r)
    esc = m >= outlier
    if encoder_type == 1:
        return torch.where(esc, g_log2 + 17,
                           _golomb_length(m + 1, g_par, g_log2))
    if encoder_type == 2:
        diff = torch.where(esc, m - outlier, 0)
        level = torch.where(diff < 4, 0, ilog2(diff) >> 1)
        ln = _golomb_length(torch.where(esc, outlier + level, m), g_par,
                            g_log2)
        return torch.where(esc, ln + 2 * (level + 1), ln)
    raise ValueError(f"unknown encoder type {encoder_type}")
