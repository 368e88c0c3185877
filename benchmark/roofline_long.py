"""The bytes K1's long-row mode must move on one block, by the rule of
``roofline.py``: each input byte read once, each output byte written once,
and the frame's real length, not the worst-case capacity.  (K4 on the
block's one row is ``roofline.k4_bytes(1, n)``.)
"""

from __future__ import annotations

__all__ = ["ROW_CODES", "k1_long_bytes"]

#: codes a row of K1's long-row mode (the port's ``ops/pack.ROW_CODES``)
ROW_CODES = 8192


def k1_long_bytes(size: int, n: int, hdr: int, trailer: int) -> int:
    """K1 long-row on one block of ``n`` residuals whose frame came out
    ``size`` bytes: the int32 residuals read, the u32 words the payload
    fills written, and each row's start bit read."""
    rows = -(-n // ROW_CODES)
    return 4 * n + 4 * ((size - hdr - trailer + 3) // 4) + 4 * rows
