"""A plain AIRSPACE context over long blocks: one block a frame, the model
chained from block to block, as upstream's ``airspace`` CLI compresses a
list of files with one context (programs/airspacecli.c:148-191,
programs/file.c:435-488).

Each block is one frame of the format (lib/cmp_header.h:19-51): the IWT,
DIFF or MODEL residuals of the pass, their GOLOMB_ZERO or GOLOMB_MULTI
codes packed from bit 176 on, the 22-byte header and the XXH32 trailer.
The pass chain follows upstream's engine (lib/compress/cmp.c:213-393): a
primary pass at sequence number 0 (or once the secondary iterations are
spent) resets the chain and draws an identifier, the next
``secondary_iterations`` blocks take the secondary parameters, and the
model is the primary block, then the EMA ``(model * rate + x * (16 -
rate)) >> 4`` of the unsigned values after each block (cmp.c:120-142).
As upstream's ``cmp_initialise`` ends in a reset, the context draws one
identifier when it is made (cmp.c:203-208).

The codes, the packing and the header are :mod:`airspace`'s; the IWT is
:mod:`iwt`'s and the checksum :mod:`xxh32_long`'s.  Plain ``torch``
integer operations on any device, int64 throughout, and numpy for the
checksum on the host; it imports nothing of the program under test.
"""

from __future__ import annotations

import numpy as np
import torch

from .airspace import (CHECKSUM_BYTES, DIFF, HDR_BYTES, MODEL, Params, Stamp,
                       _codes, _header_bytes, _pack_words, derive_outlier)
from .iwt import iwt_forward
from .xxh32_long import xxh32_u16_long

__all__ = ["IWT", "LongContext"]

IWT = 2


def _residuals(x: torch.Tensor, prep: int, model) -> torch.Tensor:
    """The pass's residuals of the (n,) unsigned samples, int16 values."""
    if prep == IWT:
        return iwt_forward(x)
    if prep == DIFF:
        r = x - torch.nn.functional.pad(x[:-1], (1, 0))
    elif prep == MODEL:
        r = x - model
    else:
        raise ValueError(f"preprocessing {prep} not covered")
    return ((r + 0x8000) & 0xFFFF) - 0x8000


class LongContext:
    """One context: :meth:`encode` turns each block into its frame."""

    def __init__(self, p: Params, stamp: Stamp):
        if p.uncompressed_fallback_enabled:
            raise ValueError("the uncompressed fallback is not covered")
        self.p = p
        self.stamp = stamp
        self.seq = 0
        self.model = None
        self.identifier = int(stamp.draw(1)[0])

    def encode_all(self, blocks, device="cpu") -> "list[np.ndarray]":
        """The frames of the (K, n) blocks, in order; their checksums in
        one pass over all of them."""
        blocks = np.asarray(blocks)
        sums = (xxh32_u16_long(blocks) if self.p.checksum_enabled
                else [None] * len(blocks))
        return [self.encode(b, device, h) for b, h in zip(blocks, sums)]

    def encode(self, samples, device="cpu",
               checksum: "int | None" = None) -> np.ndarray:
        """The uint8 frame of the (n,) u16 ``samples`` (any integer array),
        the residuals and codes computed on ``device``; ``checksum``, the
        samples' XXH32 where the caller hashed them already."""
        p = self.p
        host = np.asarray(samples).astype(np.int64) & 0xFFFF
        x = torch.from_numpy(host).to(device)
        secondary = 0 < self.seq <= p.secondary_iterations
        if not secondary:
            self.seq = 0
            self.identifier = int(self.stamp.draw(1)[0])
        prep, enc, g, out = p.pass_params(secondary)
        outlier = derive_outlier(enc, g, out)
        cw, ln = _codes(_residuals(x, prep, self.model), enc, g, outlier)
        bits = int(ln.sum())
        trailer = CHECKSUM_BYTES if p.checksum_enabled else 0
        size = HDR_BYTES + (bits + 7) // 8 + trailer
        pos = 8 * HDR_BYTES + torch.cumsum(ln, 0) - ln
        words = _pack_words(cw, ln, pos, (size + 3) // 4)
        frame = torch.stack([(words >> s) & 0xFF for s in (24, 16, 8, 0)],
                            1).reshape(-1)[:size].to(torch.uint8)
        frame = frame.cpu().numpy()
        frame[:HDR_BYTES] = _header_bytes(
            torch.tensor([size]), x.numel(), torch.tensor([self.identifier]),
            self.seq, prep, enc, g, outlier,
            p.model_rate if prep == MODEL else 0,
            p.checksum_enabled)[0].numpy()
        if p.checksum_enabled:
            if checksum is None:
                checksum = int(xxh32_u16_long(host[None])[0])
            frame[size - 4:] = list(int(checksum).to_bytes(4, "big"))
        if p.model_is_needed():
            self.model = x if self.seq == 0 else (
                self.model * p.model_rate + x * (16 - p.model_rate)) >> 4
        self.seq += 1
        return frame
