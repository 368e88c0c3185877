"""Plain PyTorch AIRSPACE batch encoder: the benchmark's reference.

It encodes B lockstep chains of N 16-bit samples into the packed stream of
their frames (frame b of every batch is chain b's next frame), byte for byte
as the format defines it (uviespace/airs-compression v0.6.0: header
lib/cmp_header.h:19-51, engine lib/compress/cmp.c:213-393, encoder
lib/compress/encoder.c:185-378, checksum lib/common/header.c:137-163).

It covers the parts the benchmark's configurations use: DIFF and MODEL
preprocessing, GOLOMB_ZERO and GOLOMB_MULTI codes with their escapes, the
22-byte header with its extension, the XXH32 trailer, the model update and
the primary / secondary pass chain.  The uncompressed fallback and the
IWT are not covered: a configuration that asks for them is refused.

Plain ``torch`` integer operations on any device, int64 throughout; it
imports nothing of the program under test.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .xxh32 import xxh32_u16_rows

__all__ = ["Params", "Stamp", "derive_outlier", "encode_chain"]

DIFF, MODEL = 1, 3
ZERO, MULTI = 1, 2
VERSION = (1 << 15) | 600          # version flag + 0.6.0
HDR_BYTES = 22                     # header with its extension
CHECKSUM_BYTES = 4


@dataclasses.dataclass(frozen=True)
class Params:
    """The codec parameters of one configuration (struct cmp_params)."""

    primary_preprocessing: int
    primary_encoder_type: int
    primary_encoder_param: int
    primary_encoder_outlier: int = 0
    secondary_iterations: int = 0
    secondary_preprocessing: int = 0
    secondary_encoder_type: int = 0
    secondary_encoder_param: int = 0
    secondary_encoder_outlier: int = 0
    model_rate: int = 0
    checksum_enabled: bool = False
    uncompressed_fallback_enabled: bool = False

    def model_is_needed(self) -> bool:
        return self.secondary_preprocessing == MODEL and \
            self.secondary_iterations != 0

    def pass_params(self, secondary: bool):
        if secondary:
            return (self.secondary_preprocessing, self.secondary_encoder_type,
                    self.secondary_encoder_param,
                    self.secondary_encoder_outlier)
        return (self.primary_preprocessing, self.primary_encoder_type,
                self.primary_encoder_param, self.primary_encoder_outlier)


class Stamp:
    """Deterministic timestamp source: draw k gives the identifiers
    ``counter .. counter + k - 1`` (48 bits), as a counter-backed
    ``() -> (coarse, fine)`` source would."""

    def __init__(self, start: int = 0):
        self.counter = start

    def __call__(self):
        c = self.counter
        self.counter += 1
        return (c >> 16) & 0xFFFFFFFF, c & 0xFFFF

    def draw(self, k: int) -> np.ndarray:
        ids = (self.counter + np.arange(k, dtype=np.int64)) & ((1 << 48) - 1)
        self.counter += k
        return ids


def _ilog2(x: int) -> int:
    return x.bit_length() - 1


def derive_outlier(enc: int, g: int, outlier: int) -> int:
    """The outlier an encoder works with (encoder.c:63-224): ZERO derives
    its own, both clamp to the first value whose code passes 32 bits."""
    if not 1 <= g <= 0xFFFF or enc not in (ZERO, MULTI):
        raise ValueError(f"encoder {enc} with parameter {g} not covered")
    cutoff = (2 << _ilog2(g)) - g
    first_invalid = cutoff + (33 - (_ilog2(g) + 2)) * g
    if enc == MULTI:
        first_invalid -= 8          # the 8 escape symbols of 16-bit samples
        out = outlier
    else:
        out = cutoff + 16 * g - 1
    out = min(out, first_invalid)
    if out <= 0:
        raise ValueError("outlier parameter invalid")
    return out


def _golomb(v: torch.Tensor, g: int):
    """Golomb codeword and length of each value (encoder.c:303-324)."""
    lg = _ilog2(g)
    cutoff = (2 << lg) - g
    vg = (v - cutoff).clamp(min=0)
    group = vg // g
    rem = vg - group * g
    long_cw = (((1 << group) - 1) << (lg + 2)) + (cutoff << 1) + rem
    low = v < cutoff
    return (torch.where(low, v, long_cw),
            torch.where(low, lg + 1, lg + 2 + group))


def _codes(r: torch.Tensor, enc: int, g: int, outlier: int):
    """Codeword (at most 48 bits) and length of each int16 residual."""
    m = ((r << 1) ^ (r >> 15)) & 0xFFFF          # zigzag
    esc = m >= outlier
    if enc == ZERO:
        cw, ln = _golomb(torch.where(esc, 0, m + 1), g)
        return (torch.where(esc, m, cw),
                torch.where(esc, _ilog2(g) + 17, ln))
    diff = torch.where(esc, m - outlier, 0)
    ilog = torch.zeros_like(diff)
    for s in (8, 4, 2, 1):              # floor(log2(diff)), diff < 2^16
        hit = (diff >> (ilog + s)) > 0
        ilog = torch.where(hit, ilog + s, ilog)
    level = torch.where(diff < 4, 0, ilog // 2)
    cw, ln = _golomb(torch.where(esc, outlier + level, m), g)
    raw = 2 * (level + 1)
    return (torch.where(esc, (cw << raw) | diff, cw),
            torch.where(esc, ln + raw, ln))


def _pack_words(cw, ln, pos, n_words: int) -> torch.Tensor:
    """OR every code (value ``cw`` of ``ln`` bits, MSB first at stream bit
    ``pos``) into u32 words; the codes cover disjoint bits, so a sum is
    their OR.  A code of at most 48 bits touches at most three words."""
    words = torch.zeros(n_words + 3, dtype=torch.int64, device=cw.device)
    end = pos + ln
    first = pos >> 5
    for k in range(3):
        w = first + k
        a = torch.maximum(pos, 32 * w)
        b = torch.minimum(end, 32 * w + 32)
        nb = (b - a).clamp(min=0)
        val = (cw >> (end - b).clamp(0, 63)) & ((1 << nb) - 1)
        piece = torch.where(nb > 0, val << (32 * w + 32 - b).clamp(0, 31), 0)
        words.index_add_(0, w, piece)
    return words[:n_words]


def _header_bytes(sizes, n, ids, seq, prep, enc, g, outlier, rate, cs):
    """(B, 22) uint8 headers (header.c:24-67)."""
    B = sizes.shape[0]
    dev = sizes.device
    fields = [(VERSION, 2), (sizes, 3), (2 * n, 3), (ids, 6), (seq, 1),
              ((prep << 4) | (int(cs) << 3) | enc, 1), (rate, 1), (g, 2),
              (outlier, 3)]
    cols = []
    for value, width in fields:
        v = torch.as_tensor(value, dtype=torch.int64, device=dev).expand(B)
        cols += [(v >> (8 * (width - 1 - i))) & 0xFF for i in range(width)]
    return torch.stack(cols, 1).to(torch.uint8)


def _encode_batch(x, model, p: Params, secondary: bool, seq: int, ids):
    """The packed stream (uint8 tensor) and the (B,) frame sizes of one
    pass over the (B, N) u16 samples ``x`` (int64 tensor)."""
    prep, enc, g, out = p.pass_params(secondary)
    B, n = x.shape
    if prep == DIFF:
        r = x - torch.nn.functional.pad(x[:, :-1], (1, 0))
    elif prep == MODEL:
        r = x - model
    else:
        raise ValueError(f"preprocessing {prep} not covered")
    r = ((r + 0x8000) & 0xFFFF) - 0x8000          # int16 wrap
    outlier = derive_outlier(enc, g, out)
    cw, ln = _codes(r, enc, g, outlier)
    bits = ln.sum(1)
    sizes = HDR_BYTES + (bits + 7) // 8 + (CHECKSUM_BYTES if
                                               p.checksum_enabled else 0)
    starts = torch.cumsum(sizes, 0) - sizes
    total = int(sizes.sum())
    pos = 8 * (starts + HDR_BYTES)[:, None] + torch.cumsum(ln, 1) - ln
    words = _pack_words(cw.reshape(-1), ln.reshape(-1), pos.reshape(-1),
                        (total + 3) // 4)
    stream = torch.stack([(words >> s) & 0xFF for s in (24, 16, 8, 0)],
                         1).reshape(-1)[:total].to(torch.uint8)
    hdr = _header_bytes(sizes, n, torch.as_tensor(ids, device=x.device),
                        seq, prep, enc, g, outlier,
                        p.model_rate if prep == MODEL else 0,
                        p.checksum_enabled)
    at = starts[:, None] + torch.arange(HDR_BYTES, device=x.device)
    stream[at.reshape(-1)] = hdr.reshape(-1)
    if p.checksum_enabled:
        h = xxh32_u16_rows(x)
        tail = torch.stack([(h >> s) & 0xFF for s in (24, 16, 8, 0)], 1)
        at = (starts + sizes - CHECKSUM_BYTES)[:, None] + torch.arange(
            CHECKSUM_BYTES, device=x.device)
        stream[at.reshape(-1)] = tail.to(torch.uint8).reshape(-1)
    return stream, sizes


def encode_chain(batches, p: Params, stamp: Stamp, state=None):
    """Encode consecutive (B, N) batches of u16 samples (any integer
    tensors) on B lockstep chains.

    ``state`` (``seq``, ``ids``, ``model``) continues earlier calls; None
    starts new chains.  Returns ``(streams, sizes, state)``: one uint8
    numpy stream and one (B,) int64 numpy size array a batch.
    """
    if p.uncompressed_fallback_enabled:
        raise ValueError("the uncompressed fallback is not covered")
    seq, ids, model = state if state is not None else (0, None, None)
    streams, sizes = [], []
    for x in batches:
        x = x.to(torch.int64) & 0xFFFF
        secondary = 0 < seq <= p.secondary_iterations
        if not secondary:                         # cmp.c:228-248: reset
            seq = 0
            ids = stamp.draw(x.shape[0])
        s, z = _encode_batch(x, model, p, secondary, seq, ids)
        streams.append(s.cpu().numpy())
        sizes.append(z.cpu().numpy())
        if p.model_is_needed():                   # cmp.c:120-142, 296-312
            model = x if seq == 0 else (model * p.model_rate + x * (
                16 - p.model_rate)) >> 4
        seq += 1
    return streams, sizes, (seq, ids, model)
