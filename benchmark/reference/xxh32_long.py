"""XXH32 (xxHash specification) of long rows of u16 samples, in numpy:
the AIRSPACE checksum of a block of millions of samples.

The same function as :func:`xxh32.xxh32_u16_rows` (XXH32 of the samples'
big-endian bytes, seed 419764627, lib/common/header.c:137-163), written for
rows of millions of samples: the stripes' rounds are one sequential chain
a lane, so the loop runs over the stripes once, every row's four lanes
advancing together in one small uint32 array (numpy's uint32 arithmetic
wraps modulo 2^32, as the specification's does).
"""

from __future__ import annotations

import numpy as np

from .xxh32 import P1, P2, P3, P4, P5, SEED

__all__ = ["xxh32_u16_long"]


def _rotl(a: np.ndarray, r: int) -> np.ndarray:
    return (a << np.uint32(r)) | (a >> np.uint32(32 - r))


def xxh32_u16_long(x, seed: int = SEED) -> np.ndarray:
    """(R,) uint32 XXH32 of each row of the (R, N) u16 samples ``x`` (any
    integer array; the low 16 bits are hashed)."""
    x = np.asarray(x)
    R, n = x.shape
    data = np.ascontiguousarray((x & 0xFFFF).astype(">u2")).view(np.uint8)
    nbytes = 2 * n
    n_words = nbytes // 4
    words = data[:, :4 * n_words].copy().view("<u4").reshape(R, n_words)
    stripes = n_words // 4
    u32 = np.uint32
    if stripes:
        # lane l of row r at [:, 4r + l]; a stripe's four words a row
        wp = (words[:, :4 * stripes].reshape(R, stripes, 4)
              .transpose(1, 0, 2).reshape(stripes, 4 * R) * u32(P2))
        acc = np.tile(np.array([(seed + P1 + P2) & 0xFFFFFFFF,
                                (seed + P2) & 0xFFFFFFFF, seed & 0xFFFFFFFF,
                                (seed - P1) & 0xFFFFFFFF], u32), R)
        hi = np.empty_like(acc)
        p1 = u32(P1)
        for s in range(stripes):
            np.add(acc, wp[s], out=acc)
            np.left_shift(acc, u32(13), out=hi)
            np.right_shift(acc, u32(19), out=acc)
            np.bitwise_or(acc, hi, out=acc)
            np.multiply(acc, p1, out=acc)
        acc = acc.reshape(R, 4)
        h = (_rotl(acc[:, 0], 1) + _rotl(acc[:, 1], 7)
             + _rotl(acc[:, 2], 12) + _rotl(acc[:, 3], 18))
    else:
        h = np.full(R, (seed + P5) & 0xFFFFFFFF, u32)
    h = h + u32(nbytes & 0xFFFFFFFF)
    for k in range(4 * stripes, n_words):
        h = _rotl(h + words[:, k] * u32(P3), 17) * u32(P4)
    for k in range(4 * n_words, nbytes):          # the bytes left over
        h = _rotl(h + data[:, k].astype(u32) * u32(P5), 11) * u32(P1)
    h = h ^ (h >> u32(15))
    h = h * u32(P2)
    h = h ^ (h >> u32(13))
    h = h * u32(P3)
    return h ^ (h >> u32(16))
