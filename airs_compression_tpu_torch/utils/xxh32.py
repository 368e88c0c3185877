"""XXH32 checksum on the host, bit-exact with the reference's xxhash 0.8.3.

The AIRSPACE format optionally appends ``XXH32(samples as big-endian u16
bytes, seed=419764627)`` after the compressed payload (reference
lib/common/header.c:137-163, header_private.h:46).  The batch tiers hash on
the device (ops/xxh32_device.py); this module is the independent host
implementation they are checked against:

* :func:`xxh32` — a pure-Python XXH32 (public algorithm, from the xxHash
  specification);
* :class:`XXH32State` — the streaming form (xxhash's streaming API): four
  lane accumulators, at most 15 bytes of tail and the total length, so a
  long stream is hashed piece by piece;
* :func:`cmp_checksum` and :func:`cmp_checksum_chunked` — checksum of a u16
  sample array (or of its chunks, in order) per the AIRSPACE convention
  (big-endian sample bytes).

Port of ``airs_compression_tpu/utils/xxh32.py`` without its ``xxhash``
fast path.  The long-stream tier (parallel/sp.py) hashes on the card
(kernel K4, ops/xxh32_device.py); :meth:`XXH32State.from_lanes` turns the
lanes it leaves into a state whose :meth:`~XXH32State.intdigest` is the
checksum.
"""

from __future__ import annotations

import numpy as np

__all__ = ["xxh32", "cmp_checksum", "cmp_checksum_chunked", "XXH32State",
           "CHECKSUM_SEED"]

CHECKSUM_SEED = 419764627

_M = 0xFFFFFFFF
_P1 = 2654435761
_P2 = 2246822519
_P3 = 3266489917
_P4 = 668265263
_P5 = 374761393


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M


def xxh32(data: bytes, seed: int = 0) -> int:
    """XXH32 of ``data`` with ``seed``."""
    return XXH32State(seed).update(data).intdigest()


class XXH32State:
    """Streaming XXH32 (xxhash 0.8.3 streaming API semantics).

    Digests are identical to the one-shot :func:`xxh32` over the
    concatenation of everything passed to :meth:`update`.
    """

    __slots__ = ("_seed", "_acc", "_buf", "_total")

    def __init__(self, seed: int = 0):
        self._seed = seed & _M
        self._acc = [(seed + _P1 + _P2) & _M, (seed + _P2) & _M,
                     seed & _M, (seed - _P1) & _M]
        self._buf = b""
        self._total = 0

    @classmethod
    def from_lanes(cls, seed: int, lanes, tail: bytes,
                   total: int) -> "XXH32State":
        """The state after ``total`` bytes whose whole 16-byte stripes left
        the accumulators ``lanes`` (four u32) and whose last
        ``total % 16`` bytes are ``tail``."""
        if len(tail) != total % 16:
            raise ValueError(f"tail of {len(tail)} bytes after {total}")
        st = cls(seed)
        st._acc = [int(v) & _M for v in lanes]
        st._buf = bytes(tail)
        st._total = total
        return st

    def update(self, data: bytes) -> "XXH32State":
        self._total += len(data)
        data = self._buf + bytes(data)
        v1, v2, v3, v4 = self._acc
        i, limit = 0, len(data) - 16

        def w(j):
            return int.from_bytes(data[j: j + 4], "little")

        while i <= limit:
            v1 = (_rotl((v1 + w(i) * _P2) & _M, 13) * _P1) & _M
            v2 = (_rotl((v2 + w(i + 4) * _P2) & _M, 13) * _P1) & _M
            v3 = (_rotl((v3 + w(i + 8) * _P2) & _M, 13) * _P1) & _M
            v4 = (_rotl((v4 + w(i + 12) * _P2) & _M, 13) * _P1) & _M
            i += 16
        self._acc = [v1, v2, v3, v4]
        self._buf = data[i:]
        return self

    def intdigest(self) -> int:
        if self._total >= 16:
            v1, v2, v3, v4 = self._acc
            h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12)
                 + _rotl(v4, 18)) & _M
        else:
            h = (self._seed + _P5) & _M
        h = (h + self._total) & _M
        data, i, n = self._buf, 0, len(self._buf)
        while i + 4 <= n:
            h = (h + int.from_bytes(data[i: i + 4], "little") * _P3) & _M
            h = (_rotl(h, 17) * _P4) & _M
            i += 4
        while i < n:
            h = (h + data[i] * _P5) & _M
            h = (_rotl(h, 11) * _P1) & _M
            i += 1
        h ^= h >> 15
        h = (h * _P2) & _M
        h ^= h >> 13
        h = (h * _P3) & _M
        h ^= h >> 16
        return h


def cmp_checksum_chunked(chunks_u16) -> int:
    """AIRSPACE sample checksum accumulated over sample chunks, in order:
    ``cmp_checksum(concatenate(chunks))`` without the concatenation."""
    st = XXH32State(CHECKSUM_SEED)
    for chunk in chunks_u16:
        be = np.ascontiguousarray(chunk, dtype=np.uint16).astype(">u2")
        st.update(be.tobytes())
    return st.intdigest()


def cmp_checksum(samples_u16: np.ndarray) -> int:
    """AIRSPACE sample checksum: XXH32 over big-endian u16 bytes.

    Mirrors reference cmp_checksum (lib/common/header.c:137-163): every
    sample contributes its two bytes in big-endian order, seed 419764627.
    """
    be = np.ascontiguousarray(samples_u16, dtype=np.uint16).astype(">u2")
    return xxh32(be.tobytes(), CHECKSUM_SEED)
