"""Plain PyTorch AIRSPACE batch encoder with a Golomb parameter chosen per
block: the reference of the adaptive tier.

Each block (frame) of a GOLOMB_ZERO or GOLOMB_MULTI pass picks its own
Golomb parameter from a ladder of candidates by the exact coded bit count
of the whole block; the choice and its outlier go into that frame's
22-byte header (``encoder_param``, ``encoder_outlier``: uviespace/
airs-compression v0.6.0 lib/common/header_private.h:23-31), so every
frame is an ordinary AIRSPACE frame.  The rule:

* the values are the zigzag-mapped residuals of the pass; under
  GOLOMB_MULTI, for the estimate alone, an escape (a value at or above
  the configured outlier) counts as that outlier plus its escape level;
* mu is the block's exact integer sum of those values, rounded once to
  float32, divided by N in float32; the estimate g* is float32(0.69) * mu
  in float32;
* the estimate falls between two neighbouring ladder entries by their
  geometric means (each rounded to float32; an estimate equal to a mean
  takes the lower entry): that entry's index is the window's centre;
* the candidates are ``ladder[0]`` and the window of 2w + 1 indices about
  the centre, clipped to the ladder;
* each candidate costs the block's exact bits under its own outlier: the
  one GOLOMB_ZERO derives from the parameter, or the configured
  GOLOMB_MULTI outlier clamped to the parameter's 32-bit bound
  (:func:`airspace.derive_outlier`);
* the cheapest candidate wins, and of equal costs the one of the lowest
  ladder index;
* with ``select="exact"``, or a ladder of no more than 2w + 2 entries,
  every ladder entry is a candidate.

The frames are then encoded as :func:`airspace.encode_chain` encodes them
(residuals, codes, packing, header, XXH32 trailer, the model chain and the
primary / secondary passes), with each frame's own parameter and outlier.

Departures: the JAX package (``airs_compression_tpu``) sums mu in
float32; this rule takes the exact integer sum, as the PyTorch port
does, so the choice does not hang on the order of a float sum.  The costs
here are of every ladder entry, masked to the candidates, where the
program costs only the candidates: the same choice, more work.  Upstream
has no adaptive choice; the frames it reads are its own.

Plain ``torch`` integer operations on any device, int64 throughout
(float32 only for the estimate, as the rule states); it imports nothing of
the program under test.
"""

from __future__ import annotations

import torch

from .airspace import (CHECKSUM_BYTES, DIFF, HDR_BYTES, MODEL, MULTI, ZERO,
                       Params, Stamp, _codes, _header_bytes, _pack_words,
                       derive_outlier)
from .xxh32 import xxh32_u16_rows

__all__ = ["SELECTS", "choose", "encode_chain"]

SELECTS = ("fast", "exact")


def _escape_level(m: torch.Tensor, outlier: int) -> torch.Tensor:
    """GOLOMB_MULTI's escape level of each value at or above ``outlier``:
    0 for an excess under 4, else floor(log2(excess)) // 2."""
    excess = (m - outlier).clamp(min=1)
    log2 = torch.floor(torch.log2(excess.to(torch.float64))).to(torch.int64)
    return torch.where(excess < 4, 0, log2 // 2)


def _estimate_values(m: torch.Tensor, enc: int, outlier: int) -> torch.Tensor:
    if enc == ZERO:
        return m
    return torch.where(m >= outlier, outlier + _escape_level(m, outlier), m)


def _centre(values: torch.Tensor, ladder) -> torch.Tensor:
    """(B,) ladder index nearest to g* = 0.69 * mean of each row."""
    n = values.shape[-1]
    f32 = torch.float32
    dev = values.device
    mu = values.sum(-1).to(f32) / torch.tensor(float(n), dtype=f32,
                                               device=dev)
    g_est = torch.tensor(0.69, dtype=f32, device=dev) * mu
    means = torch.tensor([(a * b) ** 0.5 for a, b in zip(ladder, ladder[1:])],
                         dtype=f32, device=dev)
    # the number of geometric means strictly below the estimate
    return torch.bucketize(g_est, means, right=False)


def choose(r: torch.Tensor, enc: int, outlier: int, ladder,
           select: str = "fast", window: int = 2):
    """Each row's parameter and header outlier for the int16 residuals
    ``r`` (B, N): ((B,) g, (B,) outlier), int64."""
    if select not in SELECTS:
        raise ValueError(f"select {select!r} is not one of {SELECTS}")
    B = r.shape[0]
    dev = r.device
    if dev.type == "cuda":
        # float32 stays float32 on the card (the rule has no matrix
        # product; kept off for any later one)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    m = ((r << 1) ^ (r >> 15)) & 0xFFFF                     # zigzag
    L = len(ladder)
    outliers = [derive_outlier(enc, g, outlier) for g in ladder]
    costs = torch.stack([_codes(r, enc, g, o)[1].sum(-1)
                         for g, o in zip(ladder, outliers)], dim=-1)
    if select == "exact" or L <= 2 * window + 2:
        allowed = torch.ones((B, L), dtype=torch.bool, device=dev)
    else:
        centre = _centre(_estimate_values(m, enc, outlier), ladder)
        idx = torch.arange(L, device=dev)
        allowed = ((idx - centre[:, None]).abs() <= window) | (idx == 0)
    masked = torch.where(allowed, costs, torch.iinfo(torch.int64).max)
    best = masked.min(-1, keepdim=True).values
    # the lowest ladder index among the cheapest candidates
    pick = torch.where(masked == best, torch.arange(L, device=dev),
                       L).min(-1).values
    g = torch.tensor(ladder, dtype=torch.int64, device=dev)[pick]
    out = torch.tensor(outliers, dtype=torch.int64, device=dev)[pick]
    return g, out


def _encode_batch(x, model, p: Params, secondary: bool, seq: int, ids,
                  ladder, select: str, window: int):
    """The packed stream (uint8 tensor) and the (B,) frame sizes of one
    pass over the (B, N) u16 samples ``x`` (int64 tensor), each frame
    under its own parameter."""
    prep, enc, _, caller_outlier = p.pass_params(secondary)
    if enc not in (ZERO, MULTI):
        raise ValueError(f"encoder {enc} has no parameter to choose")
    B, n = x.shape
    if prep == DIFF:
        r = x - torch.nn.functional.pad(x[:, :-1], (1, 0))
    elif prep == MODEL:
        r = x - model
    else:
        raise ValueError(f"preprocessing {prep} not covered")
    r = ((r + 0x8000) & 0xFFFF) - 0x8000          # int16 wrap
    g_row, out_row = choose(r, enc, caller_outlier, ladder, select, window)
    cw = torch.zeros_like(r)
    ln = torch.zeros_like(r)
    for g in torch.unique(g_row).tolist():        # each chosen parameter
        rows = g_row == g
        cw[rows], ln[rows] = _codes(r[rows], enc, g,
                                    derive_outlier(enc, g, caller_outlier))
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
                        seq, prep, enc, g_row, out_row,
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


def encode_chain(batches, p: Params, stamp: Stamp, ladder, state=None,
                 select: str = "fast", window: int = 2):
    """Encode consecutive (B, N) batches of u16 samples (any integer
    tensors) on B lockstep chains, each frame under its own parameter
    from ``ladder``.

    ``state`` (``seq``, ``ids``, ``model``) continues earlier calls; None
    starts new chains.  Returns ``(streams, sizes, state)``: one uint8
    numpy stream and one (B,) int64 numpy size array a batch.
    """
    if p.uncompressed_fallback_enabled:
        raise ValueError("the uncompressed fallback is not covered")
    ladder = tuple(int(g) for g in ladder)
    seq, ids, model = state if state is not None else (0, None, None)
    streams, sizes = [], []
    for x in batches:
        x = x.to(torch.int64) & 0xFFFF
        secondary = 0 < seq <= p.secondary_iterations
        if not secondary:                         # cmp.c:228-248: reset
            seq = 0
            ids = stamp.draw(x.shape[0])
        s, z = _encode_batch(x, model, p, secondary, seq, ids, ladder,
                             select, window)
        streams.append(s.cpu().numpy())
        sizes.append(z.cpu().numpy())
        if p.model_is_needed():                   # cmp.c:120-142, 296-312
            model = x if seq == 0 else (model * p.model_rate + x * (
                16 - p.model_rate)) >> 4
        seq += 1
    return streams, sizes, (seq, ids, model)
