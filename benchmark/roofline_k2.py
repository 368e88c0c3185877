"""The bytes K2 (csrc/pack.cu, ``pack_codes``: precomputed codes packed
per batch row) must move on one batch, by the rule of ``roofline.py``:
each input byte read once, each output byte written once, and the frames'
real lengths, not the worst-case capacity.
"""

from __future__ import annotations

import numpy as np

__all__ = ["k2_bytes"]


def k2_bytes(sizes, n: int, hdr: int, trailer: int, multi: bool) -> int:
    """K2 on one batch of ``n`` codes a row whose frames came out
    ``sizes`` bytes long: the int32 code arrays the wrapper hands it read
    (``lo`` and ``lens``, and ``hi`` under GOLOMB_MULTI, whose codes pass
    32 bits), the u32 words the payload fills written, and each row's bit
    count written."""
    sizes = np.asarray(sizes, np.int64)
    rows = sizes.size
    arrays = 3 if multi else 2
    words = int(((sizes - hdr - trailer + 3) // 4).sum())
    return 4 * arrays * rows * n + 4 * words + 4 * rows
