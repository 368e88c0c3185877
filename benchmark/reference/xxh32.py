"""XXH32 (xxHash specification) of each row of u16 samples, in plain
PyTorch: the AIRSPACE checksum, XXH32 of the samples' big-endian bytes with
seed 419764627 (lib/common/header.c:137-163), every row at once."""

from __future__ import annotations

import torch

__all__ = ["SEED", "xxh32_u16_rows"]

SEED = 419764627
M = 0xFFFFFFFF
P1, P2, P3, P4, P5 = (2654435761, 2246822519, 3266489917, 668265263,
                      374761393)


def _mul(a: torch.Tensor, c: int) -> torch.Tensor:
    """a * c mod 2^32 for u32 values in int64, without overflow."""
    return (a * (c & 0xFFFF) + (((a * (c >> 16)) & 0xFFFF) << 16)) & M


def _rotl(a: torch.Tensor, r: int) -> torch.Tensor:
    return ((a << r) | (a >> (32 - r))) & M


def xxh32_u16_rows(x: torch.Tensor, seed: int = SEED) -> torch.Tensor:
    """(R,) int64 XXH32 of each row of the (R, N) u16 samples ``x``."""
    x = x.to(torch.int64) & 0xFFFF
    R, n = x.shape
    be = ((x & 0xFF) << 8) | (x >> 8)            # each sample's bytes, BE
    nbytes = 2 * n
    n_words = n // 2
    w = be[:, 0:2 * n_words:2] | (be[:, 1:2 * n_words:2] << 16)
    stripes = nbytes // 16
    if stripes:
        acc = torch.tensor([(seed + P1 + P2) & M, (seed + P2) & M, seed & M,
                            (seed - P1) & M], dtype=torch.int64,
                           device=x.device).expand(R, 4).clone()
        for s in range(stripes):
            acc = _mul(_rotl((acc + _mul(w[:, 4 * s:4 * s + 4], P2)) & M,
                             13), P1)
        h = (_rotl(acc[:, 0], 1) + _rotl(acc[:, 1], 7) + _rotl(acc[:, 2], 12)
             + _rotl(acc[:, 3], 18)) & M
    else:
        h = torch.full((R,), (seed + P5) & M, dtype=torch.int64,
                       device=x.device)
    h = (h + nbytes) & M
    for k in range(4 * stripes, n_words):
        h = _mul(_rotl((h + _mul(w[:, k], P3)) & M, 17), P4)
    if n % 2:                                    # two tail bytes
        for byte in (x[:, -1] >> 8, x[:, -1] & 0xFF):
            h = _mul(_rotl((h + _mul(byte, P5)) & M, 11), P1)
    h ^= h >> 15
    h = _mul(h, P2)
    h ^= h >> 13
    h = _mul(h, P3)
    h ^= h >> 16
    return h
