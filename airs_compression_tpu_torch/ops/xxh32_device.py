"""Batched XXH32 — the AIRSPACE block checksum, one hash per block (kernel K4).

Port of ``airs_compression_tpu/ops/xxh32_device.py``.  The reference
computes XXH32 inline while encoding each block (lib/compress/cmp.c:314-319,
lib/common/header.c:137-163, seed 419764627 over the samples as big-endian
u16 bytes).  Per-block checksums are independent, so B blocks hash at once:

* :func:`xxh32_blocks` — the plain PyTorch version: the 4-lane accumulator
  recurrence ``acc = rotl13(acc + w * P2) * P1`` over 16-byte stripes as a
  loop along the stripes, elementwise across (block, lane), then the tail
  and the finalize;
* :func:`checksum_blocks_device` — the wrapper: kernel K4
  (``csrc/xxh32.cu``, one warp per block: coalesced chunks of the row
  through shared memory, four threads for the four lanes) on a CUDA
  tensor, the plain version on a CPU tensor.

Byte order note: the AIRSPACE convention hashes *big-endian* sample bytes,
while XXH32 consumes its stripe words *little-endian* — so each u32 lane
word is ``bswap16(s[2j]) | bswap16(s[2j+1]) << 16``.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build
from ..utils.xxh32 import CHECKSUM_SEED
from .u32 import MASK, from_bits, mul32, rotl32

__all__ = ["xxh32_blocks", "checksum_blocks_device"]

_P1 = 2654435761
_P2 = 2246822519
_P3 = 3266489917
_P4 = 668265263
_P5 = 374761393


def _lane_words(x: torch.Tensor) -> torch.Tensor:
    """(B, N) u16-valued samples -> (B, N//2) int64 LE stripe words of the
    samples' BE bytes."""
    s = x.to(torch.int64) & 0xFFFF
    sw = ((s & 0xFF) << 8) | (s >> 8)  # bswap16
    return sw[:, 0::2] | (sw[:, 1::2] << 16)


def _round(acc: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return mul32(rotl32((acc + mul32(w, _P2)) & MASK, 13), _P1)


def _finalize(h: torch.Tensor) -> torch.Tensor:
    h = mul32(h ^ (h >> 15), _P2)
    h = mul32(h ^ (h >> 13), _P3)
    return h ^ (h >> 16)


def xxh32_blocks(x: torch.Tensor) -> torch.Tensor:
    """XXH32 (seed CHECKSUM_SEED) of each row's big-endian u16 bytes ->
    (B,) int64 u32 values.

    ``x`` is (B, N) integer samples (low 16 bits hashed as two BE bytes
    each).  Matches utils.xxh32.cmp_checksum row for row for any N >= 1.
    """
    B, N = x.shape
    seed = CHECKSUM_SEED
    n_bytes = 2 * N
    n_stripes = n_bytes // 16
    if N % 2:
        w = _lane_words(x[:, : N - 1])  # (B, (N-1)//2)
        s_last = x[:, -1].to(torch.int64) & 0xFFFF
    else:
        w = _lane_words(x)
        s_last = None

    if n_stripes:
        stripes = w[:, : 4 * n_stripes].reshape(B, n_stripes, 4)
        acc = torch.tensor([(seed + _P1 + _P2) & MASK, (seed + _P2) & MASK,
                            seed & MASK, (seed - _P1) & MASK],
                           dtype=torch.int64, device=x.device).expand(B, 4)
        for i in range(n_stripes):
            acc = _round(acc, stripes[:, i])
        h = (rotl32(acc[:, 0], 1) + rotl32(acc[:, 1], 7)
             + rotl32(acc[:, 2], 12) + rotl32(acc[:, 3], 18)) & MASK
    else:
        h = torch.full((B,), (seed + _P5) & MASK, dtype=torch.int64,
                       device=x.device)
    h = (h + n_bytes) & MASK

    # 4-byte tail words after the last full stripe
    for j in range(4 * n_stripes, w.shape[1]):
        h = mul32(rotl32((h + mul32(w[:, j], _P3)) & MASK, 17), _P4)
    if s_last is not None:
        # final odd sample: two single BE bytes
        for b in (s_last >> 8, s_last & 0xFF):
            h = mul32(rotl32((h + b * _P5) & MASK, 11), _P1)
    return _finalize(h)


_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint,
             ctypes.c_void_p, ctypes.c_void_p]


def checksum_blocks_device(x: torch.Tensor) -> torch.Tensor:
    """AIRSPACE per-block checksum of (B, N) samples -> (B,) int64 u32.

    CUDA tensors go through kernel K4 (``csrc/xxh32.cu``), CPU tensors
    through :func:`xxh32_blocks`.
    """
    if x.device.type == "cpu":
        return xxh32_blocks(x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dim() != 2:
        raise ValueError(f"samples must be (B, N), got {x.shape}")
    B, N = x.shape
    xs = x.to(torch.int32).contiguous()
    out = torch.empty((B,), dtype=torch.int32, device=xs.device)
    if B == 0:
        return from_bits(out)
    fn = _build.function("xxh32", "airs_xxh32_blocks", _ARGTYPES)
    with torch.cuda.device(xs.device):
        err = fn(_build.ptr(xs), B, N, CHECKSUM_SEED, _build.ptr(out),
                 _build.stream_arg(xs))
    _build.check("xxh32", err, "xxh32_blocks launch")
    checksum_blocks_device.launches += 1
    return from_bits(out)


checksum_blocks_device.launches = 0
