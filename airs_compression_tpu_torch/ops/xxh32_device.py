"""Batched XXH32 — the AIRSPACE block checksum, one hash per block (kernel K4).

Port of ``airs_compression_tpu/ops/xxh32_device.py``.  The reference
computes XXH32 inline while encoding each block (lib/compress/cmp.c:314-319,
lib/common/header.c:137-163, seed 419764627 over the samples as big-endian
u16 bytes).  Per-block checksums are independent, so B blocks hash at once:

* :func:`xxh32_blocks` — the plain PyTorch version: the 4-lane accumulator
  recurrence over 16-byte stripes as a loop along the stripes, elementwise
  across (block, lane), then the tail and the finalize.  The rounds run in
  the kernel's u-form: with ``t = w * P2`` for every stripe at once, the
  lanes carry ``u = acc + t``, each round is ``u = rotl13(u) * P1 + t``
  and ``acc = rotl13(u) * P1`` comes back at the end (the same bytes as
  ``acc = rotl13(acc + w * P2) * P1``);
* :func:`checksum_blocks_device` — the wrapper: kernel K4
  (``csrc/xxh32.cu``) on a CUDA tensor, the plain version on a CPU tensor.
  K4 takes its batch path (one warp per block: coalesced chunks of the row
  through shared memory, four threads for the four lanes) for many or
  short rows, and its long path (one CTA per row: a producer warp streams
  the row by TMA into shared-memory stages of premultiplied words, a chain
  warp runs the rounds) for at most one row per SM of at least
  :data:`LONG_MIN_SAMPLES` samples.

One long stream (parallel/sp.py) is one row of K4:
:func:`checksum_stream_device` hashes it in one launch, and
:class:`StreamHasher` hashes it piece by piece, a piece's whole 16-byte
stripes on the device (:func:`xxh32_lanes`, K4 with the four lane
accumulators passed in and returned; plain version
:func:`xxh32_lanes_plain`) while the at most 7 samples left over and the
length wait for the next piece, and a host
:class:`~airs_compression_tpu_torch.utils.xxh32.XXH32State` finalizes.

Byte order note: the AIRSPACE convention hashes *big-endian* sample bytes,
while XXH32 consumes its stripe words *little-endian* — so each u32 lane
word is ``bswap16(s[2j]) | bswap16(s[2j+1]) << 16``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _build
from ..utils.xxh32 import CHECKSUM_SEED, XXH32State
from .u32 import MASK, from_bits, mul32, rotl32, to_bits

__all__ = ["xxh32_blocks", "checksum_blocks_device", "checksum_stream_device",
           "xxh32_lanes", "xxh32_lanes_plain", "StreamHasher"]

_P1 = 2654435761
_P2 = 2246822519
_P3 = 3266489917
_P4 = 668265263
_P5 = 374761393

#: K4's long-path geometry (csrc/xxh32.cu): stripes a shared-memory stage,
#: and the row length from which at most one row per SM takes the long path
STAGE_STRIPES = 512
LONG_MIN_SAMPLES = 8192


def _lane_words(x: torch.Tensor) -> torch.Tensor:
    """(B, N) u16-valued samples -> (B, N//2) int64 LE stripe words of the
    samples' BE bytes."""
    s = x.to(torch.int64) & 0xFFFF
    sw = ((s & 0xFF) << 8) | (s >> 8)  # bswap16
    return sw[:, 0::2] | (sw[:, 1::2] << 16)


def _finalize(h: torch.Tensor) -> torch.Tensor:
    h = mul32(h ^ (h >> 15), _P2)
    h = mul32(h ^ (h >> 13), _P3)
    return h ^ (h >> 16)


def _seed_lanes(seed: int, B: int, device) -> torch.Tensor:
    """(B, 4) int64 lane accumulators before the first stripe."""
    return torch.tensor([(seed + _P1 + _P2) & MASK, (seed + _P2) & MASK,
                         seed & MASK, (seed - _P1) & MASK],
                        dtype=torch.int64, device=device).expand(B, 4)


def _stripe_rounds(acc: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The lanes ``acc`` (B, 4) after the stripes of lane words ``w``
    (B, 4 S), one round per stripe and lane, in u-form as K4 runs them:
    ``u = acc + t`` on the first stripe, ``u = rotl13(u) * P1 + t`` on each
    later one, ``acc = rotl13(u) * P1`` after the last (``t = w * P2``, off
    the chain)."""
    t = mul32(w, _P2).reshape(w.shape[0], -1, 4).unbind(1)
    if not t:
        return acc
    u = (acc + t[0]) & MASK
    for tj in t[1:]:
        u = (mul32(rotl32(u, 13), _P1) + tj) & MASK
    return mul32(rotl32(u, 13), _P1)


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
        acc = _stripe_rounds(_seed_lanes(seed, B, x.device),
                             w[:, : 4 * n_stripes])
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


def checksum_stream_device(x: torch.Tensor) -> torch.Tensor:
    """AIRSPACE checksum of one long (n,) sample stream -> 0-d int64 u32.

    One row of kernel K4 (``csrc/xxh32.cu``: four chains of n / 8 rounds;
    the long path from :data:`LONG_MIN_SAMPLES` samples on) on a CUDA
    tensor, :func:`xxh32_blocks` on a CPU tensor.
    """
    if x.dim() != 1 or not x.numel():
        raise ValueError(f"samples must be (n,) with n >= 1, got {x.shape}")
    if x.device.type == "cpu":
        return xxh32_blocks(x[None])[0]
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    xs = x.to(torch.int32).contiguous()
    out = torch.empty((1,), dtype=torch.int32, device=xs.device)
    fn = _build.function("xxh32", "airs_xxh32_blocks", _ARGTYPES)
    with torch.cuda.device(xs.device):
        err = fn(_build.ptr(xs), 1, xs.numel(), CHECKSUM_SEED,
                 _build.ptr(out), _build.stream_arg(xs))
    _build.check("xxh32", err, "checksum_stream_device launch")
    checksum_stream_device.launches += 1
    return from_bits(out)[0]


checksum_stream_device.launches = 0


def _check_lanes(lanes: torch.Tensor, x: torch.Tensor) -> None:
    if x.dim() != 2 or x.shape[1] % 8:
        raise ValueError(f"samples must be (B, N), N a multiple of 8, got "
                         f"{tuple(x.shape)}")
    if lanes.shape != (x.shape[0], 4) or lanes.dtype != torch.int32:
        raise ValueError("lanes must be a (B, 4) int32 tensor")


def xxh32_lanes_plain(lanes: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`xxh32_lanes` (same contract)."""
    _check_lanes(lanes, x)
    if x.shape[1]:
        acc = _stripe_rounds(from_bits(lanes), _lane_words(x))
        lanes.copy_(to_bits(acc))
    return lanes


_LANES_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]


def xxh32_lanes(lanes: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Run XXH32's stripe rounds over each row of samples, in place.

    ``lanes`` (B, 4) int32: each row's four lane accumulators (u32 bits),
    updated by the row's ``N / 8`` stripes of ``x`` (B, N) as big-endian
    u16 bytes; ``N`` must be a multiple of 8.  Returns ``lanes``.  CUDA
    tensors go through kernel K4 in streaming mode (``csrc/xxh32.cu``), CPU
    tensors through :func:`xxh32_lanes_plain`.
    """
    if x.device.type == "cpu":
        return xxh32_lanes_plain(lanes, x)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_lanes(lanes, x)
    if not lanes.is_contiguous() or lanes.device != x.device:
        raise ValueError("lanes must be contiguous, on the samples' device")
    B, N = x.shape
    if not B or not N:
        return lanes
    xs = x.to(torch.int32).contiguous()
    fn = _build.function("xxh32", "airs_xxh32_lanes", _LANES_ARGTYPES)
    with torch.cuda.device(xs.device):
        err = fn(_build.ptr(xs), B, N, _build.ptr(lanes),
                 _build.stream_arg(xs))
    _build.check("xxh32", err, "xxh32_lanes launch")
    xxh32_lanes.launches += 1
    return lanes


xxh32_lanes.launches = 0


class StreamHasher:
    """The AIRSPACE checksum of one stream fed in pieces of any length.

    The lanes and the at most 7 samples left over stay on ``device``
    between pieces (no host round trip per piece); :meth:`intdigest`
    fetches them and finalizes on the host.  Equal to ``cmp_checksum`` of
    the concatenated pieces.
    """

    def __init__(self, device, seed: int = CHECKSUM_SEED):
        self.seed = seed
        self.lanes = to_bits(_seed_lanes(seed, 1, device)).contiguous()
        self.tail = torch.zeros((0,), dtype=torch.int32, device=device)
        self.samples = 0

    def update(self, x: torch.Tensor) -> None:
        """Hash the next (m,) samples (low 16 bits of each)."""
        x = torch.cat([self.tail, x.reshape(-1).to(torch.int32)])
        whole = x.numel() - x.numel() % 8
        if whole:
            xxh32_lanes(self.lanes, x[:whole][None])
        self.tail = x[whole:]
        self.samples += whole  # hashed as whole stripes

    STATE_LEN = 13

    def state(self) -> torch.Tensor:
        """The state as one (STATE_LEN,) int64 host tensor, to pass to another
        process (parallel/sp.py relays it from rank to rank): the samples
        hashed as whole stripes, the four lanes (u32 values), the tail's
        length and its at most 7 samples, zero-padded."""
        tail = self.tail.cpu().to(torch.int64) & 0xFFFF
        return torch.cat([
            torch.tensor([self.samples]), from_bits(self.lanes[0].cpu()),
            torch.tensor([tail.numel()]), tail,
            torch.zeros(7 - tail.numel(), dtype=torch.int64)])

    def load(self, state: torch.Tensor) -> None:
        """Continue from a :meth:`state` (same seed)."""
        s = state.cpu().to(torch.int64)
        dev = self.lanes.device
        self.samples = int(s[0])
        self.lanes = to_bits(s[1:5])[None].to(dev).contiguous()
        self.tail = s[6: 6 + int(s[5])].to(device=dev, dtype=torch.int32)

    def intdigest(self) -> int:
        tail = self.tail.cpu().numpy().astype(np.uint16).astype(">u2")
        total = 2 * (self.samples + tail.size)
        return XXH32State.from_lanes(self.seed,
                                     from_bits(self.lanes[0]).tolist(),
                                     tail.tobytes(), total).intdigest()
